"""The port's f32-argument verifier path (`Ed25519TorchVerifier(packed=
False)`) against the JAX package's (`Ed25519TpuVerifier(packed=False)`,
hotstuff_tpu/ops/ed25519.py:1154-1163, `_run_chunk` :1273-1297), on the CPU.

The reference runs `kernel="w4"` in one 128-lane bucket, the shape
tests/test_packed_pipeline.py's `test_packed_false_legacy_path` compiles,
once per process; its mask, counters and timeline spans are read from that
one run. The port runs every flavour (w4, pallas, bits) on its plain
kernels (about 1-1.5 s a piece).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import pytest

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.ops import timeline as jtimeline
from hotstuff_tpu.utils import metrics as jmetrics
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import bit_ladder as bl
from hotstuff_tpu_torch.ops import ladder
from hotstuff_tpu_torch.ops import timeline
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

COUNTERS = ("verifier.chunks", "verifier.table_builds", "verifier.decompressions", "verifier.pad_lanes")


@functools.lru_cache(maxsize=None)
def corpus() -> tuple:
    """12 signatures over messages of several lengths: two corrupted S, an
    s >= L, a wrong message. Returns (msgs, keys, sigs, expected mask)."""
    msgs, keys, sigs = [], [], []
    for i in range(12):
        seed = hashlib.sha256(b"unpacked %d" % i).digest()
        msg = hashlib.sha256(b"m%d" % i).digest()[: 5 + 3 * i]
        pk = pysigner.keypair_from_seed(seed)[0]
        msgs.append(msg)
        keys.append(pk)
        sigs.append(pysigner.sign(seed, msg, public_key=pk))
    want = [True] * 12
    for i in (2, 9):
        sigs[i] = sigs[i][:40] + bytes([sigs[i][40] ^ 0x10]) + sigs[i][41:]
        want[i] = False
    s = int.from_bytes(sigs[5][32:], "little") + pysigner.L
    sigs[5] = sigs[5][:32] + s.to_bytes(32, "little")
    want[5] = False
    msgs[7] = msgs[7] + b"!"
    want[7] = False
    return tuple(msgs), tuple(keys), tuple(sigs), tuple(want)


def _counts(registry) -> dict:
    return {k: registry.counter(k).value for k in COUNTERS}


def _spans(intervals) -> list:
    """(batch offset, chunk, phase, n) of each interval, batches numbered
    from the first."""
    first = min(i["batch"] for i in intervals)
    return sorted((i["batch"] - first, i["chunk"], i["phase"], i["n"]) for i in intervals)


@functools.lru_cache(maxsize=None)
def reference_run() -> tuple:
    """The reference verifier's mask, counter deltas and timeline spans on
    the corpus (w4, one 128-lane bucket)."""
    msgs, keys, sigs, _ = corpus()
    ref = jed.Ed25519TpuVerifier(kernel="w4", max_bucket=128, packed=False)
    jtimeline.reset()
    before = _counts(jmetrics)
    try:
        mask = np.asarray(ref.verify_batch_mask(list(msgs), list(keys), list(sigs))).tolist()
    finally:
        ref.close()
    after = _counts(jmetrics)
    return mask, {k: after[k] - before[k] for k in COUNTERS}, _spans(jtimeline.TIMELINE.intervals())


@pytest.mark.parametrize("kernel", ["w4", "pallas", "bits"])
def test_unpacked_verifier_matches_the_reference(kernel):
    """Each flavour's mask equals the reference's and the expected mask; the
    counters move and the timeline spans are recorded as the reference's
    (pallas's 256-lane bucket pads 128 lanes more)."""
    msgs, keys, sigs, want = corpus()
    ref_mask, ref_counts, ref_spans = reference_run()
    v = Ed25519TorchVerifier(device="cpu", kernel=kernel, packed=False, max_bucket=128)
    assert v.packed is False and v.kernel == kernel
    timeline.reset()
    before = _counts(metrics)
    try:
        mask = v.verify_batch_mask(list(msgs), list(keys), list(sigs))
    finally:
        v.close()
    after = _counts(metrics)
    assert mask.dtype == bool and mask.tolist() == ref_mask == list(want)
    counts = {k: after[k] - before[k] for k in COUNTERS}
    extra_pad = 128 if kernel == "pallas" else 0
    assert counts == dict(ref_counts, **{"verifier.pad_lanes": ref_counts["verifier.pad_lanes"] + extra_pad})
    assert _spans(timeline.TIMELINE.intervals()) == ref_spans
    assert {s[2] for s in ref_spans} == {"stage", "dispatch", "readback"}
    assert v.pipeline.stats["chunks"] == 0  # serial, outside the pipeline


def test_packed_defaults_and_pallas_buckets_match_the_reference():
    """`packed` defaults to kernel != "bits"; "pallas" rounds the buckets to
    the 256-lane Pallas block. Constructing the reference compiles nothing."""
    for kernel in ("w4", "pallas", "bits"):
        for kw in ({}, dict(min_bucket=100, max_bucket=1000), dict(min_bucket=300, max_bucket=8192, chunk=512)):
            ref = jed.Ed25519TpuVerifier(kernel=kernel, **kw)
            ours = Ed25519TorchVerifier(device="cpu", kernel=kernel, **kw)
            try:
                assert (ours.packed, ours.min_bucket, ours.max_bucket, ours.chunk) == (
                    ref.packed, ref.min_bucket, ref.max_bucket, ref.chunk)
            finally:
                ours.close()
                ref.close()
    with pytest.raises(ValueError, match="kernel"):
        Ed25519TorchVerifier(device="cpu", kernel="w8")


def test_a_batch_over_max_bucket_splits_as_the_reference(monkeypatch):
    """The f32 loop splits at `max_bucket`, not at `chunk` (:1158): the
    pieces each verifier hands to its `_run_chunk`, with the kernels
    stubbed out, are the same."""
    pieces = {"ref": [], "port": []}

    def stub(label):
        def run(self, messages, keys, signatures):
            pieces[label].append(len(messages))
            return np.ones(len(messages), bool)
        return run

    monkeypatch.setattr(jed.Ed25519TpuVerifier, "_run_chunk", stub("ref"))
    monkeypatch.setattr(Ed25519TorchVerifier, "_run_chunk", stub("port"))
    n = 300
    args = ([b"m"] * n, [bytes(32)] * n, [bytes(64)] * n)
    ref = jed.Ed25519TpuVerifier(kernel="bits", max_bucket=128, chunk=64)
    ours = Ed25519TorchVerifier(device="cpu", kernel="bits", max_bucket=128, chunk=64)
    try:
        assert ref.verify_batch_mask(*args).all() and ours.verify_batch_mask(*args).all()
    finally:
        ours.close()
        ref.close()
    assert pieces["port"] == pieces["ref"] == [128, 128, 44]


def test_pieces_join_in_lane_order():
    """A 12-lane batch through `max_bucket` 8: two pieces of 8 and 4 lanes
    on the plain w4 kernels; the joined mask is the expected one and each
    piece counted once."""
    msgs, keys, sigs, want = corpus()
    v = Ed25519TorchVerifier(device="cpu", kernel="w4", packed=False, min_bucket=4, max_bucket=8)
    before = _counts(metrics)
    try:
        assert v.verify_batch_mask(list(msgs), list(keys), list(sigs)).tolist() == list(want)
    finally:
        v.close()
    after = _counts(metrics)
    assert {k: after[k] - before[k] for k in COUNTERS} == {
        "verifier.chunks": 2, "verifier.table_builds": 2, "verifier.decompressions": 12, "verifier.pad_lanes": 0}


def test_bits_packed_runs_the_packed_k1_path(monkeypatch):
    """`kernel="bits", packed=True` runs the packed path, on K1, as the
    reference's `_packed_fn` gives the packed w4 kernel to every flavour but
    "pallas"; K7 is never reached."""
    ref = jed.Ed25519TpuVerifier(kernel="bits", packed=True)
    try:
        assert ref._packed_fn() is jed._verify_w4p128_jit
    finally:
        ref.close()
    calls = []
    real = ladder.ladder
    monkeypatch.setattr(ladder, "ladder", lambda *a: calls.append("K1") or real(*a))

    def no_k7(*a):
        raise AssertionError("K7 reached on the packed path")

    monkeypatch.setattr(ladder, "bit_ladder", no_k7)
    monkeypatch.setattr(bl, "bit_ladder", no_k7)
    msgs, keys, sigs, want = corpus()
    v = Ed25519TorchVerifier(device="cpu", kernel="bits", packed=True, max_bucket=128)
    try:
        assert v.verify_batch_mask(list(msgs), list(keys), list(sigs)).tolist() == list(want)
    finally:
        v.close()
    assert calls == ["K1"] and v.pipeline.stats["chunks"] == 1
