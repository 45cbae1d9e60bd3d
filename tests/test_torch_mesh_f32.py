"""The port's f32-argument mesh path (`parallel/mesh.py` `sharded_verify`,
`ShardedEd25519TorchVerifier(packed=False)`) against the JAX package's
`sharded_verify_fn` (hotstuff_tpu/parallel/mesh.py:96-119), on the CPU.

The reference's `shard_map` runs on two of tests/conftest.py's virtual CPU
devices at kernel "w4" and 256 lanes (the port's 2-shard mesh bucket), one
trace for the file; the port's 2-shard virtual mesh (`default_mesh(2,
device="cpu")`) runs its plain kernels, one call per shard.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.parallel import mesh as jmesh
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import ladder
from hotstuff_tpu_torch.parallel import ShardedEd25519TorchVerifier, default_mesh, sharded_verify
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

WIDTH = 256  # 2 x 128: the mesh verifier's bucket on 2 shards
_M_CHUNKS = metrics.counter("verifier.chunks")
_M_PAD = metrics.counter("verifier.pad_lanes")


@functools.lru_cache(maxsize=None)
def corpus() -> tuple:
    """10 signed 32-byte digests (as `_signed_batch(10, seed=5)` drives the
    reference's mesh test, lane 7 given lane 0's signature), and lane 3's S
    pushed to s + L. Returns (msgs, keys, sigs, expected mask)."""
    msgs, keys, sigs = [], [], []
    for i in range(10):
        seed = hashlib.sha256(b"mesh f32 %d" % i).digest()
        msg = hashlib.sha256(b"digest %d" % i).digest()
        pk = pysigner.keypair_from_seed(seed)[0]
        msgs.append(msg)
        keys.append(pk)
        sigs.append(pysigner.sign(seed, msg, public_key=pk))
    sigs[7] = sigs[0]
    s = int.from_bytes(sigs[3][32:], "little") + pysigner.L
    sigs[3] = sigs[3][:32] + s.to_bytes(32, "little")
    want = [i not in (3, 7) for i in range(10)]
    return tuple(msgs), tuple(keys), tuple(sigs), tuple(want)


@functools.lru_cache(maxsize=None)
def reference_fn():
    return jmesh.sharded_verify_fn(jmesh.default_mesh(2), kernel="w4")


def _split_args(staged: dict) -> tuple:
    """The f32 arguments at WIDTH lanes with lanes 0-4 at the start of the
    first shard's block and lanes 5-9 at the start of the second's, so both
    shards verify real signatures."""
    halves = [jed.kernel_args({k: np.asarray(v)[..., part] for k, v in staged.items()}, WIDTH // 2, "w4")
              for part in (slice(0, 5), slice(5, 10))]
    return tuple(np.concatenate([a, b], axis=-1) for a, b in zip(*halves))


def test_sharded_verify_equals_sharded_verify_fn():
    """Mask and n_valid (a count of the device mask, before s < L) equal the
    reference's on the same arguments; both shards hold real lanes."""
    msgs, keys, sigs, want = corpus()
    staged = jed.prepare_batch(list(msgs), list(keys), list(sigs), allow_native=False)
    args = _split_args(staged)
    ref_mask, ref_n = (np.asarray(x) for x in reference_fn()(*args))
    mask, n_valid = sharded_verify(default_mesh(2, device="cpu"), *convert.kernel_args_from_jax(args, "w4"))
    assert mask.dtype == torch.bool and mask.shape == (WIDTH,)
    assert mask.tolist() == ref_mask.tolist()
    assert n_valid.dtype == torch.int32 and n_valid.shape == () and int(n_valid) == int(ref_n)
    lanes = list(range(5)) + list(range(128, 133))
    assert [bool(mask[i]) for i in lanes] == [i != 7 for i in range(10)]  # lane 3's s + L passes the device
    assert int(n_valid) == int(mask.sum())
    s_ok = np.asarray(staged["s_ok"], bool)
    assert ([bool(mask[i]) for i in lanes] & s_ok).tolist() == list(want)


def test_sharded_verifier_unpacked_matches_the_reference():
    """`ShardedEd25519TorchVerifier(packed=False)` on a 2-shard virtual
    mesh: the reference's `sharded_verify_fn` mask on the verifier's own
    padded arguments, ANDed with s < L, and the expected mask; one piece,
    counted once, padded to the 256-lane mesh bucket."""
    msgs, keys, sigs, want = corpus()
    staged = jed.prepare_batch(list(msgs), list(keys), list(sigs), allow_native=False)
    ref_mask, _ = reference_fn()(*jed.kernel_args(staged, WIDTH, "w4"))
    ref_final = (np.asarray(ref_mask)[:10] & np.asarray(staged["s_ok"], bool)).tolist()
    v = ShardedEd25519TorchVerifier(mesh=default_mesh(2, device="cpu"), packed=False)
    assert (v.mesh_alignment, v.min_bucket, v.packed) == (WIDTH, WIDTH, False)
    chunks, pad = _M_CHUNKS.value, _M_PAD.value
    try:
        mask = v.verify_batch_mask(list(msgs), list(keys), list(sigs))
    finally:
        v.close()
    assert mask.tolist() == ref_final == list(want)
    assert (_M_CHUNKS.value - chunks, _M_PAD.value - pad) == (1, WIDTH - 10)


def test_masks_join_in_lane_order(monkeypatch):
    """Each shard's mask lands at its block of lanes on a 4-shard mesh, and
    n_valid sums the shards' counts (the per-shard verification stubbed: a
    lane's mask is the low bit of its first key byte)."""
    seen = []

    def stub(a_y, a_sign, r_enc, s, h, kernel="w4"):
        seen.append((a_y.shape[-1], kernel, a_y.is_contiguous() and s.is_contiguous()))
        return (a_y[0] & 1).bool()

    monkeypatch.setattr(ladder, "verify_args", stub)
    rng = np.random.default_rng(3)
    a_y = torch.from_numpy(rng.integers(0, 256, (32, 32), np.uint8))
    others = (torch.zeros(32, dtype=torch.uint8), torch.zeros((32, 32), dtype=torch.uint8),
              torch.zeros((253, 32), dtype=torch.uint8), torch.zeros((253, 32), dtype=torch.uint8))
    mask, n_valid = sharded_verify(default_mesh(4, device="cpu"), a_y, *others, kernel="bits")
    assert mask.tolist() == (a_y[0] & 1).bool().tolist()
    assert int(n_valid) == int((a_y[0] & 1).sum())
    assert seen == [(8, "bits", True)] * 4
    with pytest.raises(ValueError, match="do not split evenly"):
        sharded_verify(default_mesh(3, device="cpu"), a_y, *others)


def test_pallas_mesh_aligns_to_the_pallas_block():
    """On a mesh, `kernel="pallas"` aligns buckets to 256 lanes per shard,
    as the reference's mesh verifier does (constructing it compiles
    nothing)."""
    ref = jmesh.ShardedEd25519Verifier(mesh=jmesh.default_mesh(2), kernel="pallas", packed=False)
    ours = ShardedEd25519TorchVerifier(mesh=default_mesh(2, device="cpu"), kernel="pallas", packed=False)
    try:
        assert (ours.mesh_alignment, ours.min_bucket, ours.max_bucket, ours.chunk) == (
            ref.mesh_alignment, ref.min_bucket, ref.max_bucket, ref.chunk) == (512, 512, 8192, 4096)
    finally:
        ours.close()
        ref.close()
