"""The port's f32-argument staging and kernel K7 (`ops/bit_ladder.py`)
against the JAX package's `prepare_batch(want_bits=True)`, `kernel_args`
and `_verify_jit` (the legacy bit ladder, hotstuff_tpu/ops/ed25519.py:
599-689), on the CPU.

The JAX side traces `_verify_jit` once, at 16 lanes, in a module-scoped
fixture (about 25 s); every lane class of the batch rides that one call.
The port's plain bit ladder takes about 1.3 s a call at these widths.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import bit_ladder as bl
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import field, ladder
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = pysigner.P
WIDTH = 16


def _bad_key() -> bytes:
    y = 2
    while pysigner._recover_x(y, 0) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _identity_forgery(s: int) -> bytes:
    """R = enc([s]B), S = s: valid under a key that decodes to the identity."""
    return pysigner._pt_compress(pysigner._pt_mul(s, pysigner._B_POINT)) + s.to_bytes(32, "little")


def _corpus():
    """(msgs, keys, sigs, raw device mask expected from the bits ladder,
    final mask expected, lane of s + 2^253). Messages of several lengths
    (host hash)."""
    msgs, keys, sigs = [], [], []
    for i in range(8):
        seed = hashlib.sha256(b"bit ladder %d" % i).digest()
        msg = bytes([i + 1]) * (7 * i)
        pk = pysigner.keypair_from_seed(seed)[0]
        msgs.append(msg)
        keys.append(pk)
        sigs.append(pysigner.sign(seed, msg, public_key=pk))
    raw = [True] * 8
    final = [True] * 8
    # corrupted R, corrupted S
    sigs[1] = sigs[1][:5] + bytes([sigs[1][5] ^ 0x40]) + sigs[1][6:]
    sigs[2] = sigs[2][:40] + bytes([sigs[2][40] ^ 0x01]) + sigs[2][41:]
    raw[1] = raw[2] = final[1] = final[2] = False
    # an undecodable key
    keys[3] = _bad_key()
    raw[3] = final[3] = False
    # s + 2^253 on a valid signature: bits 0..252 are s
    high = 4
    s = int.from_bytes(sigs[high][32:], "little") + 2**253
    sigs[high] = sigs[high][:32] + s.to_bytes(32, "little")
    final[high] = False
    # identity-key forgeries: y = 1, and the non-canonical y = p + 1
    for key in ((1).to_bytes(32, "little"), (P + 1).to_bytes(32, "little")):
        msgs.append(b"any message")
        keys.append(key)
        sigs.append(_identity_forgery(12345 + len(msgs)))
        raw.append(True)
        final.append(True)
    return msgs, keys, sigs, raw, final, high


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


@pytest.fixture(scope="module")
def reference(corpus):
    """The JAX package's staging, f32 arguments and `_verify_jit` raw mask
    (its one trace) on the corpus, at WIDTH lanes."""
    msgs, keys, sigs, *_ = corpus
    staged = jed.prepare_batch(msgs, keys, sigs, want_bits=True, allow_native=False)
    args = jed.kernel_args(staged, WIDTH, "bits")
    raw = np.asarray(jed._verify_jit(*args))
    return staged, args, raw


@pytest.mark.parametrize("staging", ["native", "numpy"])
def test_prepare_batch_matches_the_reference(corpus, reference, staging):
    """Every array of the f32 form, value for value (uint8 here, float32
    there), bits included, from the native plane and from numpy."""
    msgs, keys, sigs, *_ = corpus
    ref = reference[0]
    got = ted.prepare_batch(msgs, keys, sigs, want_bits=True, staging=staging)
    assert set(got) == set(ref)
    for k, want in ref.items():
        want = np.asarray(want)
        assert got[k].shape == want.shape, k
        assert got[k].dtype == (bool if k == "s_ok" else np.uint8), k
        assert np.array_equal(got[k].astype(np.float64), want.astype(np.float64)), k
    assert set(ted.prepare_batch(msgs, keys, sigs, staging=staging)) == set(ref) - {"s_bits", "h_bits"}


def test_prepare_batch_rejects_an_unknown_staging(corpus):
    msgs, keys, sigs, *_ = corpus
    with pytest.raises(ValueError, match="staging"):
        ted.prepare_batch(msgs, keys, sigs, staging="jax")


@pytest.mark.parametrize("kernel", ["bits", "w4", "pallas"])
def test_kernel_args_from_jax_round_trips(corpus, reference, kernel):
    """The reference's padded f32 arguments, carried across, equal the
    port's own `kernel_args` on its own staging, and go back unchanged."""
    msgs, keys, sigs, *_ = corpus
    ref_args = jed.kernel_args(reference[0], WIDTH, kernel)
    got = convert.kernel_args_from_jax(ref_args, kernel)
    ours = ted.kernel_args(ted.prepare_batch(msgs, keys, sigs, want_bits=True), WIDTH, kernel)
    assert len(got) == len(ours) == 5
    for g, o, r in zip(got, ours, ref_args):
        assert g.dtype == torch.uint8 and g.shape[-1] == WIDTH
        assert np.array_equal(g.numpy(), o)
        assert np.array_equal(g.numpy().astype(np.float32), np.asarray(r))
    with pytest.raises(ValueError):
        convert.kernel_args_from_jax((np.full((32, 2), 0.5, np.float32),) * 5, kernel)


def test_bits_verify_args_equals_verify_jit(corpus, reference):
    """`verify_args(..., "bits")` on the CPU gives `_verify_jit`'s raw mask
    on the same arguments: valid lanes, corrupted R and S, an undecodable
    key, the identity-key forgeries (y = 1 and the non-canonical y = p + 1)
    and s + 2^253, whose raw mask is True (bits 0..252 are s); the final
    masks AND s < L in."""
    _, _, _, raw_want, final_want, high = corpus
    staged, ref_args, ref_raw = reference
    args = convert.kernel_args_from_jax(ref_args, "bits")
    raw = ladder.verify_args(*args, kernel="bits")
    assert raw.dtype == torch.bool and raw.shape == (WIDTH,)
    assert raw.tolist() == ref_raw.tolist()
    n = len(raw_want)
    assert raw[:n].tolist() == raw_want and raw[high]
    s_ok = np.asarray(staged["s_ok"], bool)
    assert (raw[:n].numpy() & s_ok).tolist() == final_want
    assert not (ref_raw[:n] & s_ok)[high]


def test_w4_raw_mask_differs_only_on_the_high_s_lane(corpus):
    """The digit ladder reads all 256 bits of s: on s + 2^253 its raw mask is
    False where the bit ladder's is True; both final masks are False."""
    msgs, keys, sigs, raw_want, final_want, high = corpus
    staged = ted.prepare_batch(msgs, keys, sigs)
    args = [torch.from_numpy(a) for a in ted.kernel_args(staged, WIDTH, "w4")]
    raw = ladder.verify_args(*args, kernel="w4")[: len(raw_want)].tolist()
    assert raw == [v and i != high for i, v in enumerate(raw_want)]
    assert [r and ok for r, ok in zip(raw, staged["s_ok"])] == final_want


def test_verify_args_rejects_an_unknown_kernel(corpus):
    staged = ted.prepare_batch(*corpus[:3])
    with pytest.raises(ValueError, match="kernel"):
        ladder.verify_args(*(torch.from_numpy(a) for a in ted.kernel_args(staged, WIDTH, "w4")), kernel="w8")


@pytest.mark.parametrize("lanes", [4, 9])
def test_bit_ladder_plain_equals_python_int_double_and_add(lanes):
    """[s]B + [h](-A) by Python ints (pysigner's extended-coordinate adds)
    against `bit_ladder_plain` on lanes of random 253-bit s and h (9: not a
    whole number of K7's 8-lane blocks), -A from K3's plain table; the
    output's T is X Y / Z."""
    rng = np.random.default_rng(13)
    keys = [pysigner.keypair_from_seed(bytes(rng.integers(0, 256, 32, np.uint8)))[0] for _ in range(lanes)]
    a_bytes = torch.from_numpy(np.frombuffer(b"".join(keys), np.uint8).reshape(lanes, 32).T.copy())
    table, valid = ted.decompress_table_plain(a_bytes)
    assert valid.all()
    s_bits = torch.from_numpy(rng.integers(0, 2, (ted.SCALAR_BITS, lanes), np.uint8))
    h_bits = torch.from_numpy(rng.integers(0, 2, (ted.SCALAR_BITS, lanes), np.uint8))
    out = bl.bit_ladder_plain(s_bits, h_bits, table)
    assert out.dtype == torch.int32 and out.shape == (4, field.NL, lanes)
    assert torch.equal(bl.bit_ladder(s_bits, h_bits, table), out)
    X, Y, Z, T = (field.int_of_limbs(out[c]) for c in range(4))
    for lane, key in enumerate(keys):
        s = sum(int(b) << i for i, b in enumerate(s_bits[:, lane].tolist()))
        h = sum(int(b) << i for i, b in enumerate(h_bits[:, lane].tolist()))
        x, y = ted.decompress_int(key)
        neg_a = ((P - x) % P, y, 1, (P - x) * y % P)
        want = pysigner._pt_add(pysigner._pt_mul(s, pysigner._B_POINT), pysigner._pt_mul(h, neg_a))
        zi, wzi = pow(Z[lane], P - 2, P), pow(want[2], P - 2, P)
        assert X[lane] * zi % P == want[0] * wzi % P
        assert Y[lane] * zi % P == want[1] * wzi % P
        assert (T[lane] * Z[lane] - X[lane] * Y[lane]) % P == 0
