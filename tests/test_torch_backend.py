"""The slice as a whole: `TorchBackend(device="cpu")` (every kernel wrapper
on its plain version) against the JAX package's `TpuBackend` on the same
batches — valid lanes mixed with every adversarial class of ROADMAP.md §C —
on both wire formats (device hash for 32-byte messages, host hash
otherwise), plus the RFC 8032 vectors. Masks must be identical."""

import random

import pytest

from hotstuff_tpu.crypto import primitives as jprim
from hotstuff_tpu.crypto import pysigner as jpysigner
from hotstuff_tpu.crypto.tpu_backend import TpuBackend
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto.backend import HostBackend, get_backend, set_backend
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from tests.common_torch_threads import one_torch_thread  # noqa: F401
from tests.common_torch_verifier import check_verifier_depth
from tests.test_rfc8032_vectors import VECTORS

P = pysigner.P
L = pysigner.L


def _signed(n, msg_len, seed):
    rng = random.Random(seed)
    msgs, keys, sigs = [], [], []
    for _ in range(n):
        sk = rng.randbytes(32)
        pk, _ = pysigner.keypair_from_seed(sk)
        m = rng.randbytes(msg_len)
        msgs.append(m)
        keys.append(pk)
        sigs.append(pysigner.sign(sk, m, public_key=pk))
    return msgs, keys, sigs


def _adversarial(msgs, keys, sigs):
    """One lane per class; returns the names of the corrupted lanes."""
    bad_y = next(y for y in range(2, 100) if pysigner._recover_x(y, 0) is None)
    y_a = int.from_bytes(keys[5], "little") & ((1 << 255) - 1)
    classes = {
        0: "flipped R byte", 1: "flipped S byte", 2: "s >= L", 3: "wrong message",
        4: "undecompressable key", 5: "non-canonical A (y >= p)", 6: "non-canonical R",
        7: "x = 0 key with sign bit", 8: "zero signature", 9: "S from another lane",
    }
    s = sigs
    s[0] = s[0][:3] + bytes([s[0][3] ^ 1]) + s[0][4:]
    s[1] = s[1][:40] + bytes([s[1][40] ^ 1]) + s[1][41:]
    s[2] = s[2][:32] + (int.from_bytes(s[2][32:], "little") + L).to_bytes(32, "little")
    msgs[3] = bytes([msgs[3][0] ^ 1]) + msgs[3][1:]
    keys[4] = bad_y.to_bytes(32, "little")
    if y_a + P < 2**255:  # the same point, encoded with y + p
        keys[5] = (y_a + P | (keys[5][31] >> 7) << 255).to_bytes(32, "little")
    else:
        keys[5] = (P + 1).to_bytes(32, "little")
    s[6] = (P + 2).to_bytes(32, "little") + s[6][32:]
    keys[7] = (1 | 1 << 255).to_bytes(32, "little")
    s[8] = bytes(64)
    s[9] = s[9][:32] + s[10][32:]
    return classes


def _masks(msgs, keys, sigs):
    tb = TorchBackend(device="cpu", crossover=1)
    ours = tb.verify_batch_mask(msgs, [PublicKey(k) for k in keys], [Signature(s) for s in sigs])
    assert tb.stats["host_sigs"] == 0 and tb.stats["device_sigs"] == len(msgs)
    ref = TpuBackend(crossover=1, min_bucket=128, max_bucket=128).verify_batch_mask(
        msgs, [jprim.PublicKey(k) for k in keys], [jprim.Signature(s) for s in sigs]
    )
    return ours, ref


@pytest.mark.parametrize("msg_len", [32, 33], ids=["device_hash", "host_hash"])
def test_masks_match_tpu_backend(msg_len):
    msgs, keys, sigs = _signed(16, msg_len, seed=msg_len)
    classes = _adversarial(msgs, keys, sigs)
    ours, ref = _masks(msgs, keys, sigs)
    assert ours == ref
    want = [i not in classes for i in range(16)]
    assert ours == want, [classes.get(i) for i, (a, b) in enumerate(zip(ours, want)) if a != b]


@pytest.mark.parametrize("depth", [1, 2])
def test_verifier_pipeline_matches_reference_verifier(depth):
    """The generic path through the dispatch pipeline: 16 lanes of every
    adversarial class, tiled to 128 so that both chunks hold them."""
    msgs, keys, sigs = _signed(16, 32, seed=90)
    classes = _adversarial(msgs, keys, sigs)
    got = check_verifier_depth("generic", depth, msgs * 8, keys * 8, sigs * 8)
    assert got == [i % 16 not in classes for i in range(128)]


def test_rfc8032_vectors():
    msgs = [bytes.fromhex(m) for _, m, _ in VECTORS]
    keys = [bytes.fromhex(k) for k, _, _ in VECTORS]
    sigs = [bytes.fromhex(s) for _, _, s in VECTORS]
    tb = TorchBackend(device="cpu", crossover=1)
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    assert tb.verify_batch_mask(msgs, pks, sgs) == [True] * len(VECTORS)
    assert tb.verify_batch(msgs, pks, sgs)
    bad = [m + b"\x00" for m in msgs]
    assert tb.verify_batch_mask(bad, pks, sgs) == [False] * len(VECTORS)


def test_chunking_and_buckets():
    """Chunks of 8 padded to power-of-two widths give the same mask as one
    chunk; the bucket rule mirrors Ed25519TpuVerifier._bucket."""
    msgs, keys, sigs = _signed(20, 32, seed=3)
    sigs[13] = sigs[12]
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    small = TorchBackend(device="cpu", crossover=1, min_bucket=4, max_bucket=8, chunk=8)
    assert small._verifier._bucket(3) == 4 and small._verifier._bucket(5) == 8
    assert small._verifier._bucket(100) == 8
    want = [i != 13 for i in range(20)]
    assert small.verify_batch_mask(msgs, pks, sgs) == want
    assert small.bucket_alignment == 4


def test_sub_crossover_batches_verify_on_host():
    msgs, keys, sigs = _signed(4, 32, seed=4)
    sigs[1] = sigs[0]
    tb = TorchBackend(device="cpu", crossover=8)
    mask = tb.verify_batch_mask(msgs, [PublicKey(k) for k in keys], [Signature(s) for s in sigs])
    assert mask == [True, False, True, True]
    assert tb.stats == {"device_batches": 0, "device_sigs": 0, "host_batches": 1, "host_sigs": 4,
                        "committee_batches": 0, "committee_sigs": 0, "committee_misses": 0}
    assert tb.verify_batch_mask([], [], []) == []


def test_backend_seam_and_committee_stub():
    """The seam, and committee routing on (the committee path itself is
    tests/test_torch_committee.py)."""
    tb = TorchBackend(device="cpu")
    assert tb.name == "torch" and tb.supports_committee_routing is True
    assert tb.register_committee([PublicKey(bytes(32))]) == 1
    prev = set_backend(tb)
    try:
        assert get_backend() is tb
    finally:
        set_backend(prev)
    assert isinstance(get_backend(), HostBackend)


def test_pysigner_matches_reference_signer():
    rng = random.Random(8)
    for n in (0, 32, 33, 100):
        seed, msg = rng.randbytes(32), rng.randbytes(n)
        pk, _ = pysigner.keypair_from_seed(seed)
        assert pk == jpysigner.keypair_exact(seed)[0]
        sig = pysigner.sign(seed, msg)
        assert sig == jpysigner.sign_exact(seed, msg) == pysigner.sign(seed, msg, public_key=pk)
        assert pysigner.verify(pk, msg, sig) and jpysigner.verify_exact(pk, msg, sig)
        assert not pysigner.verify(pk, msg + b"x", sig)


def test_warmup_runs_every_width():
    tb = TorchBackend(device="cpu", min_bucket=4, max_bucket=8, chunk=8)
    assert tb.warmup() >= 0.0


def _cpu_backend():
    """The reference's host verifier (OpenSSL through `cryptography`)."""
    pytest.importorskip("cryptography")
    from hotstuff_tpu.crypto.backend import CpuBackend

    return CpuBackend()


def _host_and_reference(msgs, keys, sigs):
    ours = HostBackend().verify_batch_mask(msgs, [PublicKey(k) for k in keys], [Signature(s) for s in sigs])
    ref = _cpu_backend().verify_batch_mask(
        msgs, [jprim.PublicKey(k) for k in keys], [jprim.Signature(s) for s in sigs]
    )
    return ours, ref


@pytest.mark.parametrize("msg_len", [32, 33])
def test_host_backend_matches_reference_semantics(msg_len):
    """HostBackend against the reference's CpuBackend on every adversarial
    class; the strict verifier agrees on these (no identity-key lane)."""
    msgs, keys, sigs = _signed(12, msg_len, seed=9)
    _adversarial(msgs, keys, sigs)
    ours, ref = _host_and_reference(msgs, keys, sigs)
    assert ours == ref == [False] * 10 + [True, True]
    assert ours == [jpysigner.verify_exact(k, m, s) for m, k, s in zip(msgs, keys, sigs)]


def _forged_identity(s: int) -> bytes:
    """R = enc([s]B), S = s: valid for any message under a key that decodes
    to the identity, where [h]A vanishes."""
    return pysigner._pt_compress(pysigner._pt_mul(s, pysigner._B_POINT)) + s.to_bytes(32, "little")


def test_host_backend_accepts_identity_key_forgeries_as_reference():
    """The four identity encodings (y = 1 with the sign bit, y = p + 1 with
    and without it, y = 1): OpenSSL, HostBackend and the card's plain path
    all accept the forgery; pysigner's strict verify accepts only y = 1."""
    keys = [(1 | 1 << 255).to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
            (P + 1 | 1 << 255).to_bytes(32, "little"), (1).to_bytes(32, "little")]
    msgs, sigs = [bytes(32)] * 4, [_forged_identity(12345)] * 4
    ours, ref = _host_and_reference(msgs, keys, sigs)
    assert ours == ref == [True] * 4
    assert [pysigner.verify(k, m, s) for m, k, s in zip(msgs, keys, sigs)] == [False, False, False, True]
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    assert TorchBackend(device="cpu", crossover=1, min_bucket=4).verify_batch_mask(msgs, pks, sgs) == ours
    host = TorchBackend(device="cpu", crossover=8)
    assert host.verify_batch_mask(msgs, pks, sgs) == ours and host.stats["host_sigs"] == 4


@pytest.mark.parametrize("msg_len", [32, 33])
def test_host_backend_matches_reference_on_special_keys(msg_len):
    """`chip_smoke.py`'s special key encodings (y >= p, x = 0 with the sign
    bit, y = 0, y = 1, no square root, all ones), each with an identity
    forgery and with another key's real signature: HostBackend equals
    CpuBackend, and the card's path below and above its crossover."""
    import chip_smoke

    rng = random.Random(msg_len)
    special = chip_smoke._special_keys() + [(P + 1 | 1 << 255).to_bytes(32, "little")]
    real_msgs, _, real_sigs = _signed(len(special), msg_len, seed=40 + msg_len)
    msgs, keys, sigs = [], [], []
    for k, m, sig in zip(special, real_msgs, real_sigs):
        msgs += [m, m]
        keys += [k, k]
        sigs += [_forged_identity(rng.randrange(L)), sig]
    ours, ref = _host_and_reference(msgs, keys, sigs)
    assert ours == ref
    assert any(ours)  # the identity keys accept their forgeries
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    card = TorchBackend(device="cpu", crossover=1, min_bucket=32).verify_batch_mask(msgs, pks, sgs)
    host = TorchBackend(device="cpu", crossover=64).verify_batch_mask(msgs, pks, sgs)
    assert card == host == ours


def test_verifier_native_and_numpy_staging_match_reference_verifier():
    """`Ed25519TorchVerifier(device="cpu")` with the native staging plane and
    with the numpy staging, on the w4/128 corpus of
    `test_verifier_pipeline_matches_reference_verifier`: both masks equal
    the JAX package's verifier (the reference mask computed there)."""
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
    from tests.common_torch_verifier import PIPE_KW, reference_mask

    msgs, keys, sigs = _signed(16, 32, seed=90)
    classes = _adversarial(msgs, keys, sigs)
    msgs, keys, sigs = msgs * 8, keys * 8, sigs * 8
    want = reference_mask("generic", tuple(msgs), tuple(keys), tuple(sigs), None)
    masks = {}
    for staging in ("native", "numpy"):
        v = Ed25519TorchVerifier(device="cpu", pipeline_depth=1, staging=staging, **PIPE_KW)
        masks[staging] = tuple(v.verify_batch_mask(msgs, keys, sigs).tolist())
    assert masks["native"] == masks["numpy"] == want
    assert list(want) == [i % 16 not in classes for i in range(128)]


def _port_cpu_backend():
    """The port's copy of the reference's host verifier (OpenSSL)."""
    pytest.importorskip("cryptography")
    from hotstuff_tpu_torch.crypto.backend import CpuBackend

    return CpuBackend()


@pytest.mark.parametrize("msg_len", [32, 33])
def test_port_cpu_backend_matches_reference_cpu_backend(msg_len):
    """The port's `CpuBackend` against the reference's on every adversarial
    class, the four identity-key forgeries and `chip_smoke.py`'s special
    keys: the same verdicts, which are also `HostBackend`'s."""
    import chip_smoke

    msgs, keys, sigs = _signed(12, msg_len, seed=9)
    _adversarial(msgs, keys, sigs)
    rng = random.Random(msg_len)
    identity = [(1 | 1 << 255).to_bytes(32, "little"), (P + 1).to_bytes(32, "little"),
                (P + 1 | 1 << 255).to_bytes(32, "little"), (1).to_bytes(32, "little")]
    special = chip_smoke._special_keys()
    real_msgs, _, real_sigs = _signed(len(special), msg_len, seed=40 + msg_len)
    for k in identity:
        msgs.append(bytes(msg_len))
        keys.append(k)
        sigs.append(_forged_identity(12345))
    for k, m, sig in zip(special, real_msgs, real_sigs):
        msgs += [m, m]
        keys += [k, k]
        sigs += [_forged_identity(rng.randrange(L)), sig]
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    ours = _port_cpu_backend().verify_batch_mask(msgs, pks, sgs)
    host, ref = _host_and_reference(msgs, keys, sigs)
    assert ours == ref == host
    assert ours[:12] == [False] * 10 + [True, True] and ours[12:16] == [True] * 4
    from hotstuff_tpu_torch.crypto.backend import CpuBackend, make_backend

    assert isinstance(make_backend("cpu"), CpuBackend) and make_backend("cpu").name == "cpu"


def _closed_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_remote_backend_verifies_through_openssl_when_the_sidecar_is_down(caplog):
    """A `RemoteBackend` whose sidecar is unreachable verifies its batches on
    the host through OpenSSL (`host_route == "openssl"`, said in its log
    line), below its crossover and in the outage alike, with the card's
    verdicts."""
    import logging

    from hotstuff_tpu_torch.crypto import remote
    from hotstuff_tpu_torch.crypto.backend import CpuBackend

    _port_cpu_backend()
    msgs, keys, sigs = _signed(6, 32, seed=12)
    sigs[2] = sigs[2][:32] + (int.from_bytes(sigs[2][32:], "little") + L).to_bytes(32, "little")
    pks, sgs = [PublicKey(k) for k in keys], [Signature(s) for s in sigs]
    want = [True, True, False, True, True, True]
    with caplog.at_level(logging.INFO, logger="hotstuff.crypto"):
        client = remote.RemoteBackend(("127.0.0.1", _closed_port()), crossover=4)
    assert client.host_route == "openssl" and isinstance(client._host, CpuBackend)
    assert "verify on the host (openssl)" in caplog.text
    calls = []
    verify = client._host.verify_batch_mask
    client._host.verify_batch_mask = lambda *a: calls.append(len(a[0])) or verify(*a)
    assert client.verify_batch_mask(msgs[:3], pks[:3], sgs[:3]) == want[:3]  # under the crossover
    assert client.verify_batch_mask(msgs, pks, sgs) == want  # the outage path
    assert calls == [3, 6] and client.stats["cpu_sigs"] == 9 and client.stats["remote_sigs"] == 0
    assert remote.RemoteBackend(("127.0.0.1", 1), host="exact").host_route == "exact"
    with pytest.raises(ValueError, match="host must be one of"):
        remote.RemoteBackend(("127.0.0.1", 1), host="dalek")


def test_remote_backend_without_cryptography(monkeypatch):
    """Where `cryptography` does not import, `host=None` takes the exact
    verifier and `host="openssl"` raises."""
    import sys

    from hotstuff_tpu_torch.crypto import remote

    for mod in ("cryptography", "cryptography.exceptions", "cryptography.hazmat.primitives.asymmetric.ed25519"):
        monkeypatch.setitem(sys.modules, mod, None)
    assert remote.RemoteBackend(("127.0.0.1", 1)).host_route == "exact"
    with pytest.raises(ImportError):
        remote.RemoteBackend(("127.0.0.1", 1), host="openssl")
