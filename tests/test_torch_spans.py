"""The verification plane's own spans (`utils/metrics.py` `span`), on the
CPU: a few lanes of a `TorchBackend(device="cpu")` behind the service.

Under `torch.profiler` with every thread recorded, each span is also a
`record_function` range of its histogram's name on the thread that ran
it: the service's on the event loop, the backend's and the verifier's
call on the worker thread, the chunk legs on the pipeline's two workers.
With no profiler recording, no range is entered. The collector watch, the
hand-off samples and the pipeline's wait are histograms alone."""

from __future__ import annotations

import asyncio
import gc
import json
import os
import random
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.ops import ladder
from hotstuff_tpu_torch.ops import pipeline as port_pipeline
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LANES = 32  # two 16-lane chunks, above the crossover of 16
SERVICE = ("service.submit_s", "service.assemble_s", "service.resolve_s")


@pytest.fixture(scope="module")
def corpus():
    rng = random.Random(28)
    seeds = [rng.randbytes(32) for _ in range(4)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds]
    msgs = [rng.randbytes(32) for _ in range(LANES)]
    pairs = [(PublicKey(keys[i % 4]), Signature(pysigner.sign(seeds[i % 4], m, public_key=keys[i % 4])))
             for i, m in enumerate(msgs)]
    return msgs, pairs


@pytest.fixture(scope="module")
def backend():
    tb = TorchBackend(device="cpu", crossover=16, min_bucket=16, max_bucket=16, chunk=16)
    yield tb
    tb.close()


def _hist(name: str) -> tuple[int, float]:
    h = metrics.dump(include_buckets=False)["histograms"].get(name, {"count": 0, "sum": 0.0})
    return h["count"], h["sum"]


def _verify(backend, msgs, pairs, inline=False, **kw):
    async def body():
        svc = BatchVerificationService(backend, inline=inline)
        return await svc.verify_group(msgs, pairs, dedup=False, **kw)

    return asyncio.run(asyncio.wait_for(body(), 60))


def _all_threads_profile():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True))


def _ranges(prof) -> list[tuple[str, int, float, float]]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    return [(e["name"], e["tid"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_each_span_is_a_range_on_the_thread_that_ran_it(backend, corpus, monkeypatch):
    # The kernels' plain versions run thousands of ops a chunk, each an
    # event the profiler takes: a mask of every lane stands in for them.
    monkeypatch.setattr(ladder, "verify_packed128_dh", lambda packed: torch.ones(packed.shape[-1], dtype=torch.bool))
    msgs, pairs = corpus
    waits = _hist("pipeline.wait_s")[0]
    prof = _all_threads_profile()
    prof.start()
    try:
        mask = _verify(backend, msgs, pairs)
    finally:
        prof.stop()
    assert mask == [True] * LANES
    ranges = _ranges(prof)
    tids = {}
    for name, tid, _, _ in ranges:
        tids.setdefault(name, set()).add(tid)
    loop = threading.get_native_id()
    for name in SERVICE:
        assert tids[name] == {loop}, name
    (worker,) = tids["backend.generic_s"]
    assert worker != loop
    assert tids["verifier.e2e_s"] == tids["verifier.stage_s"] == {worker}
    (upload,) = tids["verifier.upload_s"]
    assert tids["verifier.dispatch_s"] == {upload}
    (readback,) = tids["verifier.readback_s"]
    assert len({loop, worker, upload, readback}) == 4
    (outer,) = [(t, d) for n, _, t, d in ranges if n == "backend.generic_s"]
    (inner,) = [(t, d) for n, _, t, d in ranges if n == "verifier.e2e_s"]
    assert outer[0] <= inner[0] and inner[0] + inner[1] <= outer[0] + outer[1]
    # The pipeline's wait is a histogram alone: one sample a chunk.
    assert "pipeline.wait_s" not in tids
    assert _hist("pipeline.wait_s")[0] - waits == LANES // 16


def test_a_batch_under_the_crossover_is_a_host_span(backend, corpus):
    msgs, pairs = corpus
    before = {name: _hist(name)[0] for name in ("backend.host_s", "backend.generic_s")}
    prof = _all_threads_profile()
    prof.start()
    try:
        mask = backend.verify_batch_mask(msgs[:4], [k for k, _ in pairs[:4]], [s for _, s in pairs[:4]])
    finally:
        prof.stop()
    assert mask == [True] * 4
    assert _hist("backend.host_s")[0] == before["backend.host_s"] + 1
    assert _hist("backend.generic_s")[0] == before["backend.generic_s"]
    assert [n for n, *_ in _ranges(prof) if n != "runtime.gc_s"] == ["backend.host_s"]


def test_no_range_is_entered_without_a_profiler(backend, corpus, monkeypatch):
    class Refused:
        def __init__(self, *args, **kwargs):
            raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    msgs, pairs = corpus
    e2e = _hist("verifier.e2e_s")[0]
    assert _verify(backend, msgs, pairs) == [True] * LANES
    assert _hist("verifier.e2e_s")[0] == e2e + 1
    metrics.watch_collector()
    gc.collect()


def test_the_registry_module_imports_no_torch():
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('m', {str(ROOT / 'hotstuff_tpu_torch/utils/metrics.py')!r})\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "with m.span(m.histogram('x')): pass\n"
            "m.watch_collector(); import gc; gc.collect()\n"
            "print('torch' in sys.modules, m.counter('runtime.gc_collections').value)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60, check=True)
    assert out.stdout.split() == ["False", "1"]


def test_each_collection_is_one_count_and_one_pause():
    metrics.watch_collector()
    metrics.watch_collector()
    assert sum(type(cb).__name__ == "_CollectorWatch" for cb in gc.callbacks) == 1
    was = gc.isenabled()
    gc.disable()  # no collection but the one below
    try:
        n0, (c0, s0) = metrics.counter("runtime.gc_collections").value, _hist("runtime.gc_s")
        gc.collect()
        n1, (c1, s1) = metrics.counter("runtime.gc_collections").value, _hist("runtime.gc_s")
    finally:
        if was:
            gc.enable()
    assert (n1 - n0, c1 - c0) == (1, 1) and s1 > s0


@pytest.mark.parametrize("urgent, inline, bulk, critical", [
    (False, False, 1, 0), (True, False, 0, 1), (True, True, 0, 0), (False, True, 0, 0),
], ids=["bulk-thread", "critical-thread", "critical-inline", "bulk-inline"])
def test_a_threaded_call_gives_one_handoff_sample_to_its_class(backend, corpus, urgent, inline, bulk, critical):
    msgs, pairs = corpus
    b0, c0 = _hist("service.handoff_bulk_s")[0], _hist("service.handoff_critical_s")[0]
    s0 = [_hist(name)[0] for name in SERVICE]
    assert _verify(backend, msgs[:4], pairs[:4], inline=inline, urgent=urgent) == [True] * 4
    assert (_hist("service.handoff_bulk_s")[0] - b0, _hist("service.handoff_critical_s")[0] - c0) == (bulk, critical)
    assert [_hist(name)[0] - c for name, c in zip(SERVICE, s0)] == [1, 1, 1]


def _paced(n: int, upload_s: float) -> list:
    def task(ci):
        return port_pipeline.ChunkTask(stage=lambda: ci, submit=lambda p: time.sleep(upload_s) or p,
                                       readback=lambda h: h)
    return [task(ci) for ci in range(n)]


@pytest.mark.parametrize("depth, samples", [(1, 0), (2, 3)])
def test_the_pipeline_wait_is_one_sample_a_windowed_chunk(depth, samples):
    """Three chunks whose uploads take 30 ms: on the window, chunks 1 and 2
    each wait for the upload worker while the one before them uploads."""
    pipe = port_pipeline.DispatchPipeline(depth=depth)
    try:
        c0, s0 = _hist("pipeline.wait_s")
        assert pipe.run(_paced(3, 0.03)) == [0, 1, 2]
        c1, s1 = _hist("pipeline.wait_s")
    finally:
        pipe.close()
    assert c1 - c0 == samples
    assert (s1 - s0 >= 0.03) == (depth > 1)
