"""The port's `Ed25519TorchVerifier(device="cpu")` through its dispatch
pipeline against the reference's `Ed25519TpuVerifier`, shared by the
generic-path test (tests/test_torch_backend.py) and the committee-path test
(tests/test_torch_committee.py).

The reference runs at the w4 kernel in one 128-lane bucket, the shape that
those two files and tests/test_timeline.py already compile, and each
corpus's reference mask is computed once per process: the depth 1 and
depth 2 cases of one corpus share it."""

from __future__ import annotations

import functools

import numpy as np

PIPE_KW = dict(min_bucket=128, max_bucket=128, chunk=64)  # two chunks in one 128-lane bucket


@functools.lru_cache(maxsize=None)
def reference_mask(path: str, msgs: tuple, keys: tuple, sigs: tuple, committee: tuple | None) -> tuple:
    """The reference verifier's mask of one corpus. `keys` are validator
    indices into `committee` on the committee path."""
    from hotstuff_tpu.ops.ed25519 import Ed25519TpuVerifier

    ref = Ed25519TpuVerifier(kernel="w4", **PIPE_KW)
    try:
        if path == "generic":
            return tuple(np.asarray(ref.verify_batch_mask(list(msgs), list(keys), list(sigs))).tolist())
        ref.set_committee(list(committee))
        return tuple(np.asarray(ref.verify_batch_mask_committee(list(msgs), list(keys), list(sigs))).tolist())
    finally:
        ref.close()


def check_verifier_depth(path, depth, msgs, keys, sigs, committee=None) -> list:
    """`Ed25519TorchVerifier(device="cpu")` at `depth` against the reference
    verifier: both chunks' masks exact, and the port's timeline holding the
    stage, upload, dispatch and readback of chunks 0 and 1. `keys` are
    validator indices on the committee path."""
    from hotstuff_tpu_torch.ops import timeline
    from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier

    want = reference_mask(path, tuple(msgs), tuple(keys), tuple(sigs), tuple(committee) if committee else None)
    v = Ed25519TorchVerifier(device="cpu", pipeline_depth=depth, **PIPE_KW)
    timeline.reset()
    try:
        if path == "generic":
            got = v.verify_batch_mask(msgs, keys, sigs)
        else:
            v.set_committee(committee)
            got = v.verify_batch_mask_committee(msgs, keys, sigs)
    finally:
        v.close()
    assert tuple(got.tolist()) == want
    assert v.pipeline.depth == depth and v.pipeline.stats["chunks"] == 2
    ivs = timeline.TIMELINE.intervals()
    seen = {(i["chunk"], i["phase"]) for i in ivs}
    assert seen == {(c, p) for c in (0, 1) for p in ("stage", "upload", "dispatch", "readback")}
    assert len({i["batch"] for i in ivs}) == 1 and timeline.summary()["chunks"] == 2
    return got.tolist()
