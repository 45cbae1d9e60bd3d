"""The port's sharded verifier at 2 shards against the JAX package's
single-chip mask, on the CPU (a virtual mesh of 2 CPU shards, a 256-lane
bucket).

Generic and committee paths, device hash (two chunks) and host hash (one
33-byte message, one chunk), pipeline depths 1 and 2, on
tests/test_mesh_committee.py's digest-batch classes: valid votes, forged R,
forged s, wrong message, wrong index, s + L. The reference is the JAX
single-chip committee mask of the same triples
(`tests/common_torch_verifier.py`); generic lanes carry the indexed
validator's key, so the wrong-index lane fails on both paths.
"""

from __future__ import annotations

import hashlib

import pytest

from hotstuff_tpu_torch.utils import metrics
from tests.common import rfc8032_sign
from tests.common_torch_mesh import cpu_mesh_verifier, digest_corpus, validators
from tests.common_torch_threads import one_torch_thread  # noqa: F401
from tests.common_torch_verifier import reference_mask

_M_PAD = metrics.counter("verifier.pad_lanes")


@pytest.mark.parametrize(
    "path, hashing, depth",
    [("generic", "device", 1), ("generic", "device", 2), ("committee", "device", 2),
     ("generic", "host", 2), ("committee", "host", 1)],
)
def test_masks_at_two_shards_equal_the_jax_single_chip_mask(path, hashing, depth):
    kps = validators(4)
    committee = [pk for pk, _ in kps]
    msgs, idx, sigs, want = digest_corpus(kps)
    chunk = 7
    if hashing == "host":
        m = hashlib.sha256(b"host hash").digest() + b"\x01"  # 33 bytes
        msgs, idx, sigs, want = msgs + [m], idx + [1], sigs + [rfc8032_sign(kps[1], m)], want + [True]
        chunk = None
    ref = reference_mask("committee", tuple(msgs), tuple(idx), tuple(sigs), tuple(committee))
    assert list(ref) == want
    v = cpu_mesh_verifier(2, max_bucket=256, chunk=chunk, pipeline_depth=depth)
    p0 = _M_PAD.value
    try:
        if path == "generic":
            got = v.verify_batch_mask(msgs, [committee[i] for i in idx], sigs)
        else:
            v.set_committee(committee)
            got = v.verify_batch_mask_committee(msgs, idx, sigs)
    finally:
        v.close()
    assert got.tolist() == want
    n_chunks = -(-len(msgs) // v.chunk)
    assert v.pipeline.depth == depth and v.pipeline.stats["chunks"] == n_chunks
    assert _M_PAD.value == p0 + 256 * n_chunks - len(msgs)
