"""The port's `DispatchPipeline` (`hotstuff_tpu_torch/ops/pipeline.py`)
against the reference's (`hotstuff_tpu/ops/pipeline.py`), side by side.

Every test runs the same paced fake tasks (sleeps of at most 30 ms
standing in for upload, dispatch and readback, as in tests/test_pipeline.py)
through each package's pipeline and asserts of each what
tests/test_pipeline.py asserts of the reference: results in task order,
chunk counts, stalls when the window is full, a pool that stops
allocating, depth 1 inline on the caller thread, errors that settle and
propagate, a closed pipeline that degrades to serial. Counts that depend on
sleeps (stalls) are bounded, never compared between the packages; results,
orders, chunk counts and pool sizes are compared exactly.
"""

import gc
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import pipeline as ref_pipeline
from hotstuff_tpu.ops import timeline as ref_timeline
from hotstuff_tpu.utils import metrics as ref_metrics
from hotstuff_tpu_torch.ops import pipeline as port_pipeline
from hotstuff_tpu_torch.ops import timeline as port_timeline
from hotstuff_tpu_torch.utils import metrics as port_metrics

PACKAGES = {
    "reference": SimpleNamespace(pipeline=ref_pipeline, timeline=ref_timeline, metrics=ref_metrics),
    "port": SimpleNamespace(pipeline=port_pipeline, timeline=port_timeline, metrics=port_metrics),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _paced_tasks(pkg, tl, n, upload_s=0.0, dispatch_s=0.0, readback_s=0.0, log=None, order=None):
    """n ChunkTasks whose legs sleep for the given durations; submit stamps
    upload/dispatch into `tl` (the pipeline stamps stage and readback)."""
    tasks = []
    for ci in range(n):
        def make(ci=ci):
            tlkey = (1, ci, 8)

            def stage():
                if log is not None:
                    log.append(("stage", ci, threading.get_ident()))
                return ci

            def submit(payload):
                if log is not None:
                    log.append(("submit", ci, threading.get_ident()))
                with pkg.timeline.span("upload", *tlkey, timeline=tl):
                    time.sleep(upload_s)
                with pkg.timeline.span("dispatch", *tlkey, timeline=tl):
                    time.sleep(dispatch_s)
                return payload

            def readback(handle):
                if log is not None:
                    log.append(("readback", ci, threading.get_ident()))
                time.sleep(readback_s)
                if order is not None:
                    order.append(handle)
                return handle

            return pkg.pipeline.ChunkTask(stage=stage, submit=submit, readback=readback, tlkey=tlkey)

        tasks.append(make())
    return tasks


def _threads(name: str) -> list:
    return [t for t in threading.enumerate() if name in t.name]


def _wait_gone(name: str) -> None:
    for _ in range(200):
        if not _threads(name):
            return
        time.sleep(0.01)


def test_stage_vocabulary_and_depth_default(pkg, monkeypatch):
    assert pkg.pipeline.TIMELINE_STAGES == ("stage", "upload", "dispatch", "readback")
    assert set(pkg.pipeline.TIMELINE_STAGES) <= set(pkg.timeline.PHASES)
    for env, want in ((None, 2), ("3", 3), ("0", 1), ("junk", 2)):
        if env is None:
            monkeypatch.delenv("HOTSTUFF_PIPELINE_DEPTH", raising=False)
        else:
            monkeypatch.setenv("HOTSTUFF_PIPELINE_DEPTH", env)
        assert pkg.pipeline.default_depth() == want
        assert pkg.pipeline.DispatchPipeline(name="env").depth == want


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fifo_results_and_readback_order(pkg, depth):
    """Results and readbacks come in task order even when early chunks
    upload slower than late ones; `stats` counts every chunk."""
    tl = pkg.timeline.DeviceTimeline(capacity=256)
    order = []
    pipe = pkg.pipeline.DispatchPipeline(depth=depth, name=f"fifo-d{depth}", tl=tl)
    try:
        tasks = []
        for ci in range(6):
            (t,) = _paced_tasks(pkg, tl, 1, upload_s=0.02 if ci % 2 == 0 else 0.0, order=order)
            t.stage = lambda ci=ci: ci
            tasks.append(t)
        assert pipe.run(tasks) == list(range(6))
        assert order == list(range(6))
        assert pipe.stats["chunks"] == 6 and pipe.inflight == 0
        assert pipe.run([]) == [] and pipe.stats["chunks"] == 6
    finally:
        pipe.close()


def test_same_results_orders_and_chunk_counts_across_packages():
    """One task list shape through both packages at depths 1 and 2: the
    results, the readback order and the chunk counts are identical."""
    seen = {}
    for name, p in sorted(PACKAGES.items()):
        for depth in (1, 2):
            tl = p.timeline.DeviceTimeline(capacity=256)
            order = []
            pipe = p.pipeline.DispatchPipeline(depth=depth, name=f"cross-{name}", tl=tl)
            try:
                out = pipe.run(_paced_tasks(p, tl, 8, upload_s=0.002, order=order))
            finally:
                pipe.close()
            seen[(name, depth)] = (out, order, pipe.stats["chunks"], tl.summary()["chunks"])
    assert seen[("port", 1)] == seen[("reference", 1)] == seen[("port", 2)] == seen[("reference", 2)]
    assert seen[("port", 2)][0] == list(range(8)) and seen[("port", 2)][2:] == (8, 8)


def test_buffer_pool_stops_allocating(pkg):
    """Over 100 identically shaped chunks the pool allocates at most depth+1
    buffers and reuses the rest; no free list grows past its cap."""
    allocs = pkg.metrics.counter("pipeline.buffer_allocs")
    reuse = pkg.metrics.counter("pipeline.buffer_reuse")
    allocs0, reuse0 = allocs.value, reuse.value
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="pool")
    pool = pipe.pool
    try:
        tasks = []
        for ci in range(100):
            release: list = []

            def stage(ci=ci, release=release):
                buf = pool.pad(np.full((3, 50), ci, np.uint8), 64)
                release.append(buf)
                return buf

            def submit(buf):
                assert buf.shape == (3, 64) and not buf[:, 50:].any()
                return int(buf[0, 0])

            tasks.append(pkg.pipeline.ChunkTask(stage=stage, submit=submit, readback=lambda h: h, release=release))
        assert pipe.run(tasks) == list(range(100))
        assert allocs.value - allocs0 <= pipe.depth + 1
        assert reuse.value - reuse0 >= 100 - (pipe.depth + 1)
        sizes = pool.sizes()
        assert list(sizes) == [((3, 64), np.dtype(np.uint8).str)]
        assert 1 <= sizes[((3, 64), "|u1")] <= pool.max_per_shape == pipe.depth + 1
    finally:
        pipe.close()


def test_pool_pad_zeroes_padding_and_reuses(pkg):
    pool = pkg.pipeline.StagingBufferPool(max_per_shape=2)
    a = pool.pad(np.arange(5, dtype=np.int32), 8)
    assert a.shape == (8,) and a.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    a[:] = -1  # dirty it, give it back, take it again: padding re-zeroed
    pool.give(a)
    b = pool.pad(np.arange(3, dtype=np.int32), 8)
    assert b is a and b.tolist() == [0, 1, 2, 0, 0, 0, 0, 0]
    for _ in range(4):
        pool.give(np.empty(8, np.int32))
    assert pool.sizes() == {((8,), np.dtype(np.int32).str): 2}


def test_port_pool_pins_on_the_card_and_raises_without_one():
    """`pin=True` hands out numpy views of page-locked tensors; on a host
    without CUDA it raises rather than handing out pageable memory."""
    pool = port_pipeline.StagingBufferPool(max_per_shape=2, pin=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pool.take((4, 8), np.uint8)
        assert pool.sizes() == {}
        return
    buf = pool.pad(np.ones((4, 5), np.uint8), 8)
    assert isinstance(buf, np.ndarray) and torch.from_numpy(buf).is_pinned()
    assert buf[:, :5].all() and not buf[:, 5:].any()
    assert isinstance(port_pipeline.StagingBufferPool().take((3,), np.bool_), np.ndarray)


def test_stall_when_window_full(pkg):
    """Staging chunk k+depth waits for chunk k's readback, and each wait is
    counted as a stall (bounded below: the count depends on sleeps)."""
    stalls = pkg.metrics.counter("pipeline.stalls")
    stalls0 = stalls.value
    tl = pkg.timeline.DeviceTimeline(capacity=256)
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="stall", tl=tl)
    try:
        assert pipe.run(_paced_tasks(pkg, tl, 5, dispatch_s=0.03)) == list(range(5))
        assert 2 <= pipe.stats["stalls"] <= 3
        assert stalls.value - stalls0 >= 2
        assert pipe.inflight == 0
    finally:
        pipe.close()


def test_depth1_is_serial_inline_on_caller_thread(pkg):
    tl = pkg.timeline.DeviceTimeline(capacity=256)
    log = []
    pipe = pkg.pipeline.DispatchPipeline(depth=1, name="inline-d1", tl=tl)
    assert pipe.run(_paced_tasks(pkg, tl, 3, log=log)) == [0, 1, 2]
    me = threading.get_ident()
    assert all(tid == me for _, _, tid in log)
    assert [(kind, ci) for kind, ci, _ in log] == [
        (k, ci) for ci in range(3) for k in ("stage", "submit", "readback")
    ]
    assert pipe.stats == {"chunks": 3, "stalls": 0}
    assert not _threads("inline-d1")
    # every chunk stamped all four phases
    seen = {(i["chunk"], i["phase"]) for i in tl.intervals()}
    assert seen == {(c, p) for c in range(3) for p in pkg.pipeline.TIMELINE_STAGES}


def test_set_depth_clamps_and_a_depth_of_one_runs_inline(pkg):
    """`set_depth` clamps to at least 1; a pipeline set to depth 1 after a
    windowed run takes the inline path on the caller thread."""
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    pipe = pkg.pipeline.DispatchPipeline(depth=3, name="set-depth", tl=tl)
    try:
        assert pipe.run(_paced_tasks(pkg, tl, 3)) == [0, 1, 2]
        pipe.set_depth(0)
        assert pipe.depth == 1
        log = []
        assert pipe.run(_paced_tasks(pkg, tl, 2, log=log)) == [0, 1]
        assert all(tid == threading.get_ident() for _, _, tid in log)
        pipe.set_depth(2)
        assert pipe.depth == 2 and pipe.run(_paced_tasks(pkg, tl, 2)) == [0, 1]
    finally:
        pipe.close()


def test_error_in_stage_settles_and_pipeline_survives(pkg):
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="stage-err", tl=tl)
    try:
        tasks = _paced_tasks(pkg, tl, 2, dispatch_s=0.01)
        order = []
        tasks[0].readback = lambda h: order.append(h) or h

        def boom():
            raise RuntimeError("stage exploded")

        tasks.append(pkg.pipeline.ChunkTask(stage=boom, submit=lambda p: p, readback=lambda h: h))
        with pytest.raises(RuntimeError, match="stage exploded"):
            pipe.run(tasks)
        assert pipe.inflight == 0 and order == [0]  # chunk 0 settled before the raise
        assert pipe.run(_paced_tasks(pkg, tl, 2)) == [0, 1]
    finally:
        pipe.close()


def test_error_in_submit_settles_every_chunk_then_propagates(pkg):
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="submit-err", tl=tl)
    try:
        order = []
        tasks = _paced_tasks(pkg, tl, 3, order=order)
        orig = tasks[1].submit

        def bad(payload):
            orig(payload)
            raise ValueError("upload died")

        tasks[1].submit = bad
        with pytest.raises(ValueError, match="upload died"):
            pipe.run(tasks)
        assert pipe.inflight == 0 and order == [0, 2]  # the others still read back
    finally:
        pipe.close()


def test_close_reaps_workers_and_degrades_to_serial(pkg):
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="closing", tl=tl)
    assert pipe.run(_paced_tasks(pkg, tl, 3)) == [0, 1, 2]
    assert _threads("closing")
    pipe.close()
    pipe.close()  # idempotent
    _wait_gone("closing")
    assert not _threads("closing")
    log = []
    assert pipe.run(_paced_tasks(pkg, tl, 2, log=log)) == [0, 1]
    assert all(tid == threading.get_ident() for _, _, tid in log)
    assert not _threads("closing")


def test_dropped_pipeline_is_reaped_by_finalizer(pkg):
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="dropped", tl=tl)
    assert pipe.run(_paced_tasks(pkg, tl, 2)) == [0, 1]
    assert _threads("dropped")
    del pipe
    gc.collect()
    _wait_gone("dropped")
    assert not _threads("dropped")


def test_close_all_drains_live_pipelines(pkg):
    pipe = pkg.pipeline.DispatchPipeline(depth=2, name="close-all")
    tl = pkg.timeline.DeviceTimeline(capacity=64)
    assert pipe.run(_paced_tasks(pkg, tl, 2)) == [0, 1]
    pkg.pipeline.close_all()
    _wait_gone("close-all")
    assert not _threads("close-all") and pipe._closed
