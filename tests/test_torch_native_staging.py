"""The port's native staging plane (`hotstuff_tpu_torch/native/staging.cpp`
through `crypto/native_staging.py`, built here with g++) byte for byte
against three references: the port's numpy staging (`ops/ed25519.py`
`prepare_batch_*`), the JAX package's own staging functions (its host-hash
form without its native plane), and `hashlib.sha512` with Python integers
for h and s < L. Each entry writes a shard-major (shards, rows, width /
shards) buffer and must zero its pad lanes whatever the buffer held.

The verifier-level comparison (native and numpy staging against the JAX
verifier on the w4/128 corpus) lives in tests/test_torch_backend.py, where
that corpus's reference mask is already computed."""

import hashlib
import random

import numpy as np
import pytest

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu_torch.crypto import native_staging as ns
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops.pipeline import StagingBufferPool
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier, fill_shards
from tests.common_torch_threads import one_torch_thread  # noqa: F401

L = pysigner.L
MSG_LENS = (0, 1, 31, 32, 33, 111, 112, 113, 300)  # R || A || M crosses SHA-512's 112-byte edge
S_EDGES = (0, L - 1, L, L + 1, 2**256 - 1)
N, WIDTH = 120, 128


def _corpus(seed: int, n: int, hashed: bool):
    """n lanes of random keys and signatures, the first five with s at the
    edges around L; messages of every MSG_LENS length in turn (host hash)
    or 32 bytes (device hash); validator indices into 7 keys."""
    rng = np.random.default_rng(seed)
    keys = [bytes(r) for r in rng.integers(0, 256, (n, 32), np.uint8)]
    sigs = [bytes(r) for r in rng.integers(0, 256, (n, 64), np.uint8)]
    for i, s in enumerate(S_EDGES):
        sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
    lens = [MSG_LENS[i % len(MSG_LENS)] if hashed else 32 for i in range(n)]
    msgs = [rng.integers(0, 256, k, np.uint8).tobytes() for k in lens]
    idx = rng.integers(0, 7, n).tolist()
    return msgs, keys, idx, sigs


# form -> (native entry, port numpy function, JAX package function, rows, host hash, arguments)
FORMS = {
    "packed_hh": (ns.stage_packed_hh, ted.prepare_batch_packed,
                  lambda *a: jed.prepare_batch_packed(*a, allow_native=False), 128, True,
                  lambda m, k, i, s: (m, k, s)),
    "packed_dh": (ns.stage_packed_dh, ted.prepare_batch_packed_dh, jed.prepare_batch_packed_dh, 128, False,
                  lambda m, k, i, s: (m, k, s)),
    "committee_hh": (ns.stage_committee_hh, ted.prepare_batch_committee, jed.prepare_batch_committee, 96, True,
                     lambda m, k, i, s: (m, k, i, s)),
    "committee_dh": (ns.stage_committee_dh, ted.prepare_batch_committee_dh, jed.prepare_batch_committee_dh, 96,
                     False, lambda m, k, i, s: (m, i, s)),
}


def _laid_out(arr: np.ndarray, width: int, shards: int) -> np.ndarray:
    out = np.zeros((shards, arr.shape[0], width // shards), np.uint8)
    fill_shards(out, arr)
    return out


def _lanes(out: np.ndarray, n: int) -> np.ndarray:
    """The (rows, n) wire array of the first n lanes of a shard-major buffer."""
    shards, rows, w = out.shape
    return out.transpose(1, 0, 2).reshape(rows, shards * w)[:, :n]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_native_staging_matches_numpy_jax_and_hashlib(form, shards):
    native, ours, theirs, rows, hashed, args_of = FORMS[form]
    msgs, keys, idx, sigs = _corpus(seed=shards, n=N, hashed=hashed)
    args = args_of(msgs, keys, idx, sigs)
    out = np.full((shards, rows, WIDTH // shards), 0xA5, np.uint8)  # a dirty buffer
    got = native(*args, out, WIDTH, shards)
    assert got["packed"] is out
    want, ref = ours(*args), theirs(*args)
    np.testing.assert_array_equal(out, _laid_out(want["packed"], WIDTH, shards))
    np.testing.assert_array_equal(out, _laid_out(ref["packed"], WIDTH, shards))
    np.testing.assert_array_equal(got["s_ok"], want["s_ok"])
    np.testing.assert_array_equal(got["s_ok"], ref["s_ok"])
    assert got["s_ok"].tolist() == [int.from_bytes(s[32:], "little") < L for s in sigs]
    assert got["s_ok"][:5].tolist() == [True, True, False, False, False]
    if "idx" in want:
        assert got["idx"].dtype == np.int32
        np.testing.assert_array_equal(got["idx"], ref["idx"])
    # Rows by hand: R and S always, then A and M (device hash) or h.
    wire = _lanes(out, N)
    r_rows = 32 if rows == 128 else 0
    assert [bytes(wire[r_rows : r_rows + 32, b]) for b in range(N)] == [s[:32] for s in sigs]
    assert [bytes(wire[r_rows + 32 : r_rows + 64, b]) for b in range(N)] == [s[32:] for s in sigs]
    if rows == 128:
        assert [bytes(wire[:32, b]) for b in range(N)] == keys
    last = [bytes(wire[rows - 32 :, b]) for b in range(N)]
    if hashed:
        h = [(int.from_bytes(hashlib.sha512(s[:32] + k + m).digest(), "little") % L).to_bytes(32, "little")
             for m, k, s in zip(msgs, keys, sigs)]
        assert last == h
        assert {len(m) for m in msgs} == set(MSG_LENS)
    else:
        assert last == msgs


@pytest.mark.parametrize("form", sorted(FORMS))
def test_reused_pooled_buffer_is_zeroed_past_n(form):
    """A pooled buffer that held a full chunk, handed back and taken again,
    staged with fewer lanes at a width above n: the pad lanes of every
    shard read zero."""
    native, ours, _, rows, hashed, args_of = FORMS[form]
    msgs, keys, idx, sigs = _corpus(seed=7, n=WIDTH, hashed=hashed)
    pool = StagingBufferPool()
    out = pool.take((2, rows, WIDTH // 2), np.uint8)
    native(*args_of(msgs, keys, idx, sigs), out, WIDTH, 2)
    assert out[1, :, -1].any()
    pool.give(out)
    again = pool.take((2, rows, WIDTH // 2), np.uint8)
    assert again is out
    n = 37
    args = args_of(msgs[:n], keys[:n], idx[:n], sigs[:n])
    native(*args, again, WIDTH, 2)
    np.testing.assert_array_equal(again, _laid_out(ours(*args)["packed"], WIDTH, 2))
    assert not again[0, :, n:].any() and not again[1].any()


def test_empty_batch_zeroes_the_buffer():
    out = np.full((4, 128, 8), 0xFF, np.uint8)
    got = ns.stage_packed_hh([], [], [], out, 32, 4)
    assert got["s_ok"].shape == (0,) and not out.any()


def test_wrapper_rejects_inconsistent_sizes():
    msgs, keys, idx, sigs = _corpus(seed=3, n=8, hashed=False)
    out = np.zeros((2, 128, 4), np.uint8)
    with pytest.raises(ValueError, match="width"):
        ns.stage_packed_dh(msgs, keys, sigs, out, 6, 4)  # does not split
    with pytest.raises(ValueError, match="width"):
        ns.stage_packed_dh(msgs, keys, sigs, np.zeros((1, 128, 4), np.uint8), 4, 1)  # n > width
    with pytest.raises(ValueError, match="out must be"):
        ns.stage_packed_dh(msgs, keys, sigs, np.zeros((2, 96, 4), np.uint8), 8, 2)
    with pytest.raises(ValueError, match="out must be"):
        ns.stage_packed_dh(msgs, keys, sigs, np.zeros((2, 128, 8), np.uint8)[:, :, :4], 8, 2)
    with pytest.raises(ValueError, match="keys"):
        ns.stage_packed_dh(msgs, keys[:-1] + [bytes(31)], sigs, out, 8, 2)
    with pytest.raises(ValueError, match="messages"):
        ns.stage_committee_dh(msgs[:-1] + [b"x"], idx, sigs, np.zeros((2, 96, 4), np.uint8), 8, 2)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile, or a missing
    compiler, raises from `load` and from the verifier's construction,
    with what the compiler said."""
    bad = tmp_path / "staging.cpp"
    bad.write_text("int hs_stage_packed_hh( { this is not C++\n")
    monkeypatch.setattr(ns, "SOURCE", bad)
    monkeypatch.setattr(ns, "BUILD", tmp_path / "build")
    monkeypatch.setattr(ns, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)native staging build failed.*error"):
        ns.load()
    with pytest.raises(RuntimeError, match="native staging build failed"):
        Ed25519TorchVerifier(device="cpu")
    assert not list((tmp_path / "build").rglob("*.so"))
    monkeypatch.setattr(ns, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="not found"):
        ns.load()
    Ed25519TorchVerifier(device="cpu", staging="numpy")  # the numpy staging needs no build
    with pytest.raises(ValueError, match="staging must be one of"):
        Ed25519TorchVerifier(device="cpu", staging="python")


def _signed(n: int, msg_len: int):
    rng = random.Random(msg_len)
    seeds = [rng.randbytes(32) for _ in range(n)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds]
    msgs = [rng.randbytes(msg_len) for _ in range(n)]
    sigs = [pysigner.sign(s, m, public_key=k) for s, m, k in zip(seeds, msgs, keys)]
    sigs[1] = sigs[1][:32] + (int.from_bytes(sigs[1][32:], "little") + L).to_bytes(32, "little")  # s >= L
    return msgs, keys, sigs


@pytest.mark.parametrize("msg_len", [32, 33], ids=["device_hash", "host_hash"])
def test_verifier_stages_natively_unless_numpy_is_asked_for(msg_len):
    """Each chunk of a batch takes one native call of its form, and the
    numpy staging only runs where it is asked for; both give the mask,
    with s >= L rejected."""
    msgs, keys, sigs = _signed(5, msg_len)
    entry = "stage_packed_dh" if msg_len == 32 else "stage_packed_hh"
    masks = {}
    for staging in ("native", "numpy"):
        v = Ed25519TorchVerifier(device="cpu", min_bucket=4, max_bucket=4, chunk=4, pipeline_depth=1,
                                 staging=staging)
        ns.reset_calls()
        masks[staging] = v.verify_batch_mask(msgs, keys, sigs).tolist()
        want = {k: (2 if k == entry and staging == "native" else 0) for k in ns.SIGNATURES}
        assert ns.calls() == want and v.device_hash_fallbacks == 0
    assert masks["native"] == masks["numpy"] == [True, False, True, True, True]


def test_concurrent_callers_stage_their_own_buffers():
    """Sidecar dispatch threads stage at once, each call running without
    the interpreter lock: every buffer holds its own chunk and the call
    count loses no update."""
    import sys
    import threading

    msgs, keys, idx, sigs = _corpus(seed=9, n=64, hashed=True)
    want = _laid_out(ted.prepare_batch_packed(msgs, keys, sigs)["packed"], 64, 2)
    errors, threads, reps = [], 8, 20

    def work():
        out = np.empty((2, 128, 32), np.uint8)
        for _ in range(reps):
            ns.stage_packed_hh(msgs, keys, sigs, out, 64, 2)
            if not np.array_equal(out, want):
                errors.append("a buffer differs")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ns.reset_calls()
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(w.is_alive() for w in workers) and errors == []
    assert ns.calls()["stage_packed_hh"] == threads * reps
