"""The committee path of the port (`CommitteeTable`, K5 `committee_ladder`,
K2g `h_digits_gather`, `verify_committee96(_dh)`, the verifier's and
`TorchBackend`'s committee API) against the JAX package's committee path
(`CommitteeTable`, `_verify_kernel_w4_committee` through
`_verify_w4c96(dh)_jit`, `TpuBackend` with a registered committee) and
against the port's own generic path, on the same inputs. Every comparison
is exact.

The JAX comparisons use 128 lanes and 4-key committees: the shapes
`tests/test_committee_verify.py` compiles, so the JAX side can hit the
persistent compile cache."""

import random

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.crypto import primitives as jprim
from hotstuff_tpu.crypto.tpu_backend import TpuBackend
from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.ops import committee as tcm
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import field as tf
from hotstuff_tpu_torch.ops import sha512 as tsha
from hotstuff_tpu_torch.ops.pipeline import StagingBufferPool
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
from tests.common_torch_threads import one_torch_thread  # noqa: F401
from tests.common_torch_verifier import check_verifier_depth

P, L = pysigner.P, pysigner.L
B = 128

NO_SQRT = next(y for y in range(2, 100) if ted.decompress_int(y.to_bytes(32, "little")) is None).to_bytes(32, "little")
Y0_GE_P = P.to_bytes(32, "little")  # y = p: reduced to y = 0, a point of order 4
Y1_GE_P = (P + 1).to_bytes(32, "little")  # y = p + 1: reduced to y = 1, the identity
X0_SIGN = (1 | 1 << 255).to_bytes(32, "little")  # y = 1 (x = 0) with the sign bit set


def _signer(seed):
    sk = random.Random(seed).randbytes(32)
    return sk, pysigner.keypair_from_seed(sk)[0]


SK, PK = _signer(1)
# The JAX comparisons' committee: a signing validator and the three key
# encodings where pysigner's strict verify and the device decoder differ.
COMMITTEE = [PK, NO_SQRT, Y1_GE_P, X0_SIGN]


def _forge_identity_key(rng):
    """A signature that the device equation accepts for any key that
    decodes to the identity (y = 1 or y = p + 1): [h]A vanishes, so
    R = enc([s]B) verifies for every message."""
    s = rng.randrange(L)
    return pysigner._pt_compress(pysigner._pt_mul(s, pysigner._B_POINT)) + s.to_bytes(32, "little")


def _vote_batch(msg_len, seed):
    """16 lanes over COMMITTEE covering the rejection classes of ROADMAP.md
    §C. Returns (msgs, keys, sigs, expected device-semantics mask)."""
    rng = random.Random(seed)
    msgs = [rng.randbytes(msg_len) for _ in range(16)]
    keys = [PK] * 16
    sigs = [pysigner.sign(SK, m, public_key=PK) for m in msgs]
    want = [True] * 16
    sigs[0] = sigs[0][:3] + bytes([sigs[0][3] ^ 1]) + sigs[0][4:]  # flipped R byte
    sigs[1] = sigs[1][:40] + bytes([sigs[1][40] ^ 1]) + sigs[1][41:]  # flipped S byte
    sigs[2] = sigs[2][:32] + (int.from_bytes(sigs[2][32:], "little") + L).to_bytes(32, "little")  # s >= L
    msgs[3] = bytes([msgs[3][0] ^ 1]) + msgs[3][1:]  # wrong message
    keys[4] = NO_SQRT  # undecompressable key
    sigs[5] = (P + 2).to_bytes(32, "little") + sigs[5][32:]  # non-canonical R
    sigs[6] = bytes(64)  # zero signature
    sigs[7] = sigs[7][:32] + sigs[8][32:]  # S from another lane
    for i in range(8):
        want[i] = False
    keys[9], sigs[9] = Y1_GE_P, _forge_identity_key(rng)  # y >= p: reduced, accepted
    keys[10], sigs[10] = X0_SIGN, _forge_identity_key(rng)  # x = 0 takes either sign
    keys[11], sigs[11] = X0_SIGN, sigs[12]  # identity key, R != enc([s]B)
    want[11] = False
    return msgs, keys, sigs, want


def _vals(entries, v):
    """Values mod p of validator v's 16 entries, coordinate-major."""
    return [[x % P for x in tf.int_of_limbs(entries[v, k, c].view(-1, 1))] for c in range(3) for k in range(16)]


# --- CommitteeTable --------------------------------------------------------


def test_committee_table_matches_jax():
    _, pk2 = _signer(2)
    keys = [PK, pk2, PK, NO_SQRT, Y0_GE_P, Y1_GE_P, X0_SIGN, (2**256 - 1).to_bytes(32, "little")]
    ours = ted.CommitteeTable(keys, device="cpu")
    ref = jed.CommitteeTable(keys)
    entries, valid, keys_u8 = convert.committee_table_from_jax(ref)
    assert ours.size == ref.size == len(keys)
    assert ours.entries.dtype == torch.int32 and ours.entries.shape == (len(keys), 16, 3, ted.NL)
    assert torch.equal(ours.entries, entries)  # both canonical: equal limb for limb
    assert torch.equal(ours.valid, valid) and torch.equal(ours.keys_u8, keys_u8)
    assert ours.index == ref.index and ours.index[PK] == 0  # first index wins
    assert ours.valid.tolist()[:7] == [True, True, True, False, True, True, True]
    for k in keys:
        assert ted.decompress_int(k) == jed._decompress_int(k)
    # an undecompressable key: the identity in row 0, zeros after; the
    # strict host decoder rejects the y >= p and x = 0-with-sign keys
    # that the table accepts
    assert _vals(ours.entries, 3) == ([[1]] + [[0]] * 15) * 2 + [[0]] * 16
    assert [pysigner._pt_decompress(k) is None for k in (Y0_GE_P, Y1_GE_P, X0_SIGN)] == [True] * 3
    with pytest.raises(ValueError):
        ted.CommitteeTable([], device="cpu")


def test_committee_table_entries_are_multiples():
    """Entry k of validator v is k*(-A_v) in affine precomp form."""
    _, pk2 = _signer(3)
    ct = ted.CommitteeTable([PK, pk2], device="cpu")
    for v, key in enumerate((PK, pk2)):
        x, y = ted.decompress_int(key)
        neg, cur = ((P - x) % P, y), (0, 1)
        for k in range(16):
            ypx, ymx, xy2d = (tf.int_of_limbs(ct.entries[v, k, c].view(-1, 1))[0] for c in range(3))
            cx, cy = cur
            assert (ypx, ymx, xy2d) == ((cy + cx) % P, (cy - cx) % P, ted.D2_INT * cx * cy % P)
            cur = ted._edwards_add_int(cur, neg)


# --- K2g and K5 plain versions -----------------------------------------------


def test_h_digits_gather_plain():
    rng = np.random.default_rng(5)
    keys = [bytes(r) for r in rng.integers(0, 256, (5, 32), np.uint8)]
    ct = ted.CommitteeTable(keys, device="cpu")
    r, m = (torch.from_numpy(rng.integers(0, 256, (32, 9), np.uint8)) for _ in range(2))
    idx = torch.tensor([0, 4, 2, -1, 5, 1000, 3, 3, 1], dtype=torch.int32)
    got = tsha.h_digits_gather(r, ct.keys_u8, idx, m)  # CPU: the plain version
    a = ct.keys_u8[:, idx.clamp(0, 4).long()]
    want = tsha.h_digits_plain(r, a, m)
    for lane in range(9):
        col = want[:, lane] if 0 <= idx[lane] < 5 else torch.zeros(64, dtype=torch.uint8)
        assert torch.equal(got[:, lane], col)


def test_committee_ladder_matches_jax():
    """`committee_ladder_plain` + `compress_eq_plain` against the JAX
    committee kernel (`_verify_kernel_w4_committee`) on the same digits,
    indices and (converted) table. The JAX kernel is reached through
    `_verify_w4c96_jit`, which nibble-unpacks the S and h rows into exactly
    these digits, so the compile is shared with the host-hash tests below.
    R is the encoding of the port's point on even lanes, so the masks show
    whether the two ladders reach the same point."""
    rng = np.random.default_rng(7)
    keys = [PK, NO_SQRT, Y0_GE_P, X0_SIGN]
    jct = jed.CommitteeTable(keys)
    entries, valid, _ = convert.committee_table_from_jax(jct)
    sd = rng.integers(0, 16, (64, B), np.uint8)
    hd = rng.integers(0, 16, (64, B), np.uint8)
    idx = rng.integers(0, len(keys), B).astype(np.int32)
    point, lane_valid = tcm.committee_ladder_plain(
        torch.from_numpy(sd), torch.from_numpy(hd), entries, valid, torch.from_numpy(idx)
    )
    assert point.dtype == torch.int32 and point.shape == (4, ted.NL, B)
    assert lane_valid.tolist() == [bool(valid[i]) for i in idx]
    r = rng.integers(0, 256, (32, B), np.uint8)
    r[:, ::2] = ted.compress(point)[:, ::2].numpy()
    ours = ted.compress_eq_plain(point, torch.from_numpy(r), lane_valid)
    packed = np.vstack([r, sd[0::2] | sd[1::2] << 4, hd[0::2] | hd[1::2] << 4])
    assert torch.equal(tsha.nibble_rows(torch.from_numpy(packed[32:64])), torch.from_numpy(sd))
    put = jax.device_put
    ref = jed._verify_w4c96_jit(jct.ta_ypx, jct.ta_ymx, jct.ta_xy2d, jct.valid, put(idx), put(packed))
    assert ours.tolist() == np.asarray(ref).tolist()
    assert ours[::2].tolist() == lane_valid[::2].tolist() and not ours[1::2].any()
    # the kernel wrapper on CPU tensors is the plain version
    ct = ted.CommitteeTable(keys, device="cpu")
    p2, lv2 = tcm.committee_ladder(torch.from_numpy(sd), torch.from_numpy(hd), ct, torch.from_numpy(idx))
    assert torch.equal(p2, point) and torch.equal(lv2, lane_valid)


def test_committee_ladder_out_of_range_lanes():
    """An index outside [0, N) takes the clamped validator's table and is
    masked: lane_valid False, point as for the clamped index."""
    ct = ted.CommitteeTable([PK, Y0_GE_P], device="cpu")
    rng = np.random.default_rng(8)
    sd = torch.from_numpy(rng.integers(0, 16, (64, 6), np.uint8))
    hd = torch.from_numpy(rng.integers(0, 16, (64, 6), np.uint8))
    idx = torch.tensor([-5, 0, 1, 2, 2**31 - 1, 1], dtype=torch.int32)
    point, lane_valid = tcm.committee_ladder(sd, hd, ct, idx)
    clamped, _ = tcm.committee_ladder(sd, hd, ct, idx.clamp(0, 1))
    assert torch.equal(point, clamped)
    assert lane_valid.tolist() == [False, True, True, False, False, True]


# --- packed96 formats against the JAX jits -----------------------------------


@pytest.mark.parametrize("msg_len", [32, 33], ids=["device_hash", "host_hash"])
def test_verify_committee96_matches_jax(msg_len):
    msgs, keys, sigs, want = _vote_batch(msg_len, seed=msg_len)
    ct = ted.CommitteeTable(COMMITTEE, device="cpu")
    jct = jed.CommitteeTable(COMMITTEE)
    indices = [ct.index[k] for k in keys]
    if msg_len == 32:
        staged = ted.prepare_batch_committee_dh(msgs, indices, sigs)
        ref_staged = jed.prepare_batch_committee_dh(msgs, indices, sigs)
    else:
        staged = ted.prepare_batch_committee(msgs, keys, indices, sigs)
        ref_staged = jed.prepare_batch_committee(msgs, keys, indices, sigs)
    for name in ("packed", "idx", "s_ok"):
        np.testing.assert_array_equal(staged[name], ref_staged[name])
    pool = StagingBufferPool()
    packed, idx = pool.pad(staged["packed"], B), pool.pad(staged["idx"], B)
    put = jax.device_put
    if msg_len == 32:
        ours = tcm.verify_committee96_dh(ct, torch.from_numpy(idx), torch.from_numpy(packed))
        ref = jed._verify_w4c96dh_jit(
            jct.ta_ypx, jct.ta_ymx, jct.ta_xy2d, jct.valid, jct.keys_u8, put(idx), put(packed)
        )
    else:
        ours = tcm.verify_committee96(ct, torch.from_numpy(idx), torch.from_numpy(packed))
        ref = jed._verify_w4c96_jit(jct.ta_ypx, jct.ta_ymx, jct.ta_xy2d, jct.valid, put(idx), put(packed))
    assert ours.tolist() == np.asarray(ref).tolist()
    assert (ours.numpy()[:16] & staged["s_ok"]).tolist() == want


# --- the slice as a whole: TorchBackend against TpuBackend -----------------------


@pytest.mark.parametrize("msg_len", [32, 33], ids=["device_hash", "host_hash"])
def test_backend_committee_masks_match_tpu_backend_and_generic(msg_len):
    msgs, keys, sigs, want = _vote_batch(msg_len, seed=100 + msg_len)
    tb = TorchBackend(device="cpu", crossover=1)
    assert tb.register_committee([PublicKey(k) for k in COMMITTEE]) == len(COMMITTEE)
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    ours = tb.verify_batch_mask(msgs, pks, sgs, committee=True)
    assert tb.stats["committee_batches"] == 1 and tb.stats["committee_sigs"] == 16
    generic = tb.verify_batch_mask(msgs, pks, sgs)
    assert tb.stats["committee_batches"] == 1 and tb.stats["device_batches"] == 2
    assert tb.stats["host_sigs"] == 0
    jb = TpuBackend(crossover=1, min_bucket=128, max_bucket=128)
    assert jb.register_committee([jprim.PublicKey(k) for k in COMMITTEE]) == len(COMMITTEE)
    ref = jb.verify_batch_mask(
        msgs, [jprim.PublicKey(k) for k in keys], [jprim.Signature(s) for s in sigs], committee=True
    )
    assert ours == ref == generic == want
    # pysigner's strict verify rejects the identity-key forgeries that the
    # device equation (and HostBackend, and OpenSSL) accept
    assert [pysigner.verify(keys[i], msgs[i], sigs[i]) for i in (9, 10)] == [False, False]


def test_backend_committee_miss_takes_generic_path():
    msgs, keys, sigs, want = _vote_batch(32, seed=7)
    tb = TorchBackend(device="cpu", crossover=1, min_bucket=16)
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    # no registration: the tag is ignored, nothing counts as a miss
    assert tb.verify_batch_mask(msgs, pks, sgs, committee=True) == want
    assert tb.stats["committee_batches"] == 0 and tb.stats["committee_misses"] == 0
    tb.register_committee(COMMITTEE[:3])  # X0_SIGN (lanes 10, 11) is not registered
    assert tb.verify_batch_mask(msgs, pks, sgs, committee=True) == want
    assert tb.stats["committee_misses"] == 1 and tb.stats["committee_batches"] == 0
    assert tb.stats["device_batches"] == 2


@pytest.mark.parametrize("depth", [1, 2])
def test_verifier_pipeline_matches_reference_verifier(depth):
    """The committee path through the dispatch pipeline, against the
    reference verifier at the 128-lane, 4-key shape compiled above: every
    rejection class of `_vote_batch`, tiled to 128 so both chunks hold it."""
    msgs, keys, sigs, want = _vote_batch(32, seed=91)
    idx = [COMMITTEE.index(k) for k in keys]
    got = check_verifier_depth("committee", depth, msgs * 8, idx * 8, sigs * 8, committee=COMMITTEE)
    assert got == want * 8


def test_committee_crossover():
    """A committee batch obeys `committee_crossover`, a generic one
    `crossover`. On the exact route both default to 1: on the H100 both
    paths beat the exact host verifier from one signature."""
    exact = TorchBackend(device="cpu", host="exact")
    assert (exact.crossover, exact.committee_crossover) == (1, 1)
    msgs, keys, sigs, want = _vote_batch(32, seed=9)
    tb = TorchBackend(device="cpu", crossover=17, committee_crossover=17, min_bucket=16)
    tb.register_committee(COMMITTEE)
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    host = tb.verify_batch_mask(msgs, pks, sgs, committee=True)  # 16 < 17: the host verifier
    assert tb.stats["host_batches"] == 1 and tb.stats["committee_batches"] == 0
    assert host == want  # the card's verdicts, identity-key forgeries (lanes 9, 10) included
    tb.committee_crossover = 16
    assert tb.verify_batch_mask(msgs, pks, sgs, committee=True) == want  # 16 >= 16: the card's path
    assert tb.stats["committee_batches"] == 1 and tb.stats["host_batches"] == 1


# --- the verifier's committee API ------------------------------------------------


def test_registration_idempotent_and_replaced_on_change():
    v = Ed25519TorchVerifier(device="cpu")
    t1 = v.set_committee(COMMITTEE)
    assert v.set_committee(list(COMMITTEE)) is t1 and v.committee is t1
    t2 = v.set_committee(list(reversed(COMMITTEE)))
    assert t2 is not t1 and v.committee is t2 and t2.index[PK] == 3


def test_pinned_table_survives_reregistration():
    """As tests/test_committee_verify.py:130-170: a batch resolved against
    t1 keeps t1's result after the committee is re-registered as t2."""
    msgs, keys, sigs, want = _vote_batch(32, seed=11)
    v = Ed25519TorchVerifier(device="cpu", min_bucket=16)
    t1 = v.set_committee(COMMITTEE)
    idx_old = [t1.index[k] for k in keys]
    departed = COMMITTEE[-1]
    t2 = v.set_committee(list(reversed(COMMITTEE[:-1])))
    assert v.committee is t2 and departed not in t2.index
    assert v.verify_batch_mask_committee(msgs, idx_old, sigs, table=t1).tolist() == want
    live = [i for i, k in enumerate(keys) if k != departed]
    got = v.verify_batch_mask_committee(
        [msgs[i] for i in live], [t2.index[keys[i]] for i in live], [sigs[i] for i in live]
    )
    assert got.tolist() == [want[i] for i in live]


def test_verify_batch_mask_committee_edges():
    v = Ed25519TorchVerifier(device="cpu")
    with pytest.raises(RuntimeError, match="no committee registered"):
        v.verify_batch_mask_committee([bytes(32)], [0], [bytes(64)])
    v.set_committee(COMMITTEE)
    out = v.verify_batch_mask_committee([], [], [])
    assert out.dtype == bool and out.shape == (0,)


def test_register_committee_warmup_runs_every_width():
    tb = TorchBackend(device="cpu", min_bucket=4, max_bucket=8, chunk=8)
    assert tb.register_committee(COMMITTEE, warmup=True) == 4
    assert tb._warmup_widths() == [4, 8]
