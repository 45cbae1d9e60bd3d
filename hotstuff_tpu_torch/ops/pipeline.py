"""Bounded-depth dispatch pipeline for the verifier chunk loops.

Counterpart of `hotstuff_tpu/ops/pipeline.py`, with the same semantics:

  * **depth** (default 2 = double buffering) bounds how many chunks may be
    between staging-start and readback-complete. Staging chunk k+depth
    blocks until chunk k's mask is on the host — backpressure, counted as
    `pipeline.stalls` / `pipeline.stall_s`.
  * **Staging-buffer pool.** Padded wire buffers come from a per-shape
    free list and go back once the chunk's READBACK settles (the upload is
    asynchronous and reads the host bytes until it lands), so packing
    chunk k+2 allocates nothing in steady state (`pipeline.buffer_reuse`
    vs `pipeline.buffer_allocs`). On the card the buffers are page-locked
    (`pin=True`): PyTorch tensors from `torch.empty(..., pin_memory=True)`,
    handed out as numpy views, so an upload from them is a true
    asynchronous copy. The reference's buffers are plain numpy arrays,
    which cannot be page-locked.
  * **Streamed readback.** Each chunk's mask is fetched on a dedicated
    readback worker as soon as its dispatch handle exists, so the fetch of
    chunk k overlaps the dispatch of chunk k+1.
  * **FIFO order.** Both workers are single-threaded FIFO executors, so
    upload order is dispatch order is readback order, and results come
    back in task order. Concurrent `run` calls (the sidecar's dispatch
    threads share one backend) each keep their own window and share the
    two workers. The time a chunk waits for each worker, from the end of
    its previous leg to the start of the next, is `pipeline.wait_s`.
  * **Owned, closeable workers**, created on the first depth > 1 run;
    `close()` shuts them down, `weakref.finalize` reaps them when the owner
    is collected, and one atexit hook (`close_all`) drains every live
    pipeline.
  * **depth=1 is the serial inline mode**: stage, upload, dispatch and
    readback run on the caller thread with no worker threads at all.

The pipeline stamps the `stage` and `readback` phases of each task's
DeviceTimeline key; the task's `submit` owns `upload` and `dispatch` (the
verifier's `_upload_dispatch` / `_upload_dispatch_committee` seams).
Which CUDA stream a chunk runs on is the submit's business
(`ops/verifier.py`): the workers are plain threads.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..utils import metrics
from . import timeline

__all__ = [
    "TIMELINE_STAGES",
    "ChunkTask",
    "StagingBufferPool",
    "DispatchPipeline",
    "default_depth",
    "close_all",
]

# Every DeviceTimeline phase a DispatchPipeline run can stamp (directly —
# stage/readback — or through its tasks' submit callables — upload/
# dispatch); each is one of timeline.PHASES.
TIMELINE_STAGES: tuple[str, ...] = ("stage", "upload", "dispatch", "readback")

_M_CHUNKS = metrics.counter("pipeline.chunks")
_M_DEPTH = metrics.gauge("pipeline.depth")
_M_INFLIGHT = metrics.gauge("pipeline.inflight")
_M_STALLS = metrics.counter("pipeline.stalls")
_M_STALL_S = metrics.histogram("pipeline.stall_s")
# One sample a chunk of the windowed path: (upload leg's start - stage's end)
# + (readback leg's start - submit's end), the chunk's wait between the
# threads (a busy worker, its wake-up, the interpreter lock); a histogram
# alone, since its two pieces lie on two threads.
_M_WAIT_S = metrics.histogram("pipeline.wait_s")
_M_BUF_REUSE = metrics.counter("pipeline.buffer_reuse")
_M_BUF_ALLOC = metrics.counter("pipeline.buffer_allocs")


def default_depth() -> int:
    """Pipeline depth when the caller passes none: HOTSTUFF_PIPELINE_DEPTH
    (>= 1), default 2 — stage the next chunk while one is on the device."""
    try:
        return max(1, int(os.environ.get("HOTSTUFF_PIPELINE_DEPTH", "2")))
    except ValueError:
        return 2


@dataclass(slots=True)
class ChunkTask:
    """One chunk's three pipeline legs.

    `stage`    — pack the chunk's wire bytes (caller thread; CPU only).
    `submit`   — upload the staged payload and launch the kernels, returning
                 a handle (upload worker; stamps `upload` / `dispatch`).
    `readback` — resolve the handle to a host result (readback worker).
    `tlkey`    — the chunk's (batch, chunk, n) DeviceTimeline key, None
                 when recording is off.
    `release`  — pooled staging buffers to return once the chunk has fully
                 settled (filled by `stage`, drained after `readback`).
    """

    stage: Callable[[], Any]
    submit: Callable[[Any], Any]
    readback: Callable[[Any], Any]
    tlkey: tuple | None = None
    release: list = field(default_factory=list)


class StagingBufferPool:
    """Reusable host staging buffers, one free list per (shape, dtype).

    Every chunk of a batch pads to the same bucket width, so a small free
    list per shape gives steady-state zero-allocation staging. With `pin`
    each buffer is the numpy view of a page-locked PyTorch tensor (the view
    keeps its tensor alive), which needs a CUDA device; without it, a plain
    numpy array. Thread-safe: the caller thread takes, the readback worker
    gives back.
    """

    def __init__(self, max_per_shape: int = 4, pin: bool = False) -> None:
        self.max_per_shape = max(1, max_per_shape)
        self.pin = pin
        self._free: dict[tuple, list[np.ndarray]] = {}
        self._lock = threading.Lock()

    def take(self, shape: tuple, dtype) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            if free:
                _M_BUF_REUSE.inc()
                return free.pop()
        _M_BUF_ALLOC.inc()
        if self.pin:
            tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
            return torch.empty(tuple(shape), dtype=tdtype, pin_memory=True).numpy()
        return np.empty(shape, dtype)

    def give(self, arr: np.ndarray) -> None:
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            free = self._free.setdefault(key, [])
            if len(free) < self.max_per_shape:
                free.append(arr)

    def pad(self, arr: np.ndarray, width: int) -> np.ndarray:
        """Zero-pad the last axis of `arr` to `width` lanes in a pooled
        buffer. Always copies (even at zero pad): the staged array is about
        to be handed to an asynchronous upload, and only pooled buffers have
        a defined give-back point."""
        shape = (*arr.shape[:-1], width)
        out = self.take(shape, arr.dtype)
        n = arr.shape[-1]
        out[..., :n] = arr
        if n < width:
            out[..., n:] = 0
        return out

    def sizes(self) -> dict[tuple, int]:
        """Free-list occupancy per shape (test/diagnostic hook)."""
        with self._lock:
            return {k: len(v) for k, v in self._free.items()}


# Live pipelines, reaped at interpreter exit: worker threads must never
# outlive the process teardown.
_LIVE: "weakref.WeakSet[DispatchPipeline]" = weakref.WeakSet()


def close_all() -> None:
    """Drain every live pipeline's workers (the atexit hook)."""
    for p in list(_LIVE):
        p.close(wait=False)


atexit.register(close_all)


def _drain(execs: dict) -> None:
    """Finalizer body: owns only the executor dict, never the pipeline (a
    bound method would keep the pipeline alive forever)."""
    for ex in list(execs.values()):
        ex.shutdown(wait=False, cancel_futures=True)
    execs.clear()


class DispatchPipeline:
    """Bounded-depth upload/dispatch/readback window over FIFO workers.

    `run(tasks)` executes each `ChunkTask`'s stage on the calling thread,
    its submit on the single upload worker and its readback on the single
    readback worker, holding at most `depth` chunks between staging-start
    and readback-complete. Results return in task order. An exception
    propagates after every submitted leg has settled. `pin` page-locks the
    pool's buffers (a verifier on the card).
    """

    def __init__(
        self,
        depth: int | None = None,
        name: str = "verify",
        tl: "timeline.DeviceTimeline | None" = None,
        pin: bool = False,
    ) -> None:
        self.depth = max(1, depth if depth is not None else default_depth())
        self.name = name
        # depth+1 buffers per shape: `depth` chunks in flight (each holds its
        # buffers until readback settles) plus the one being packed.
        self.pool = StagingBufferPool(max_per_shape=self.depth + 1, pin=pin)
        self._tl = tl  # None -> the process-global timeline (span_for)
        self._execs: dict[str, ThreadPoolExecutor] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._inflight = 0
        self.stats = {"chunks": 0, "stalls": 0}
        self._finalizer = weakref.finalize(self, _drain, self._execs)
        _LIVE.add(self)

    # -- lifecycle -----------------------------------------------------------

    @property
    def inflight(self) -> int:
        """Chunks currently between staging-start and readback-complete."""
        return self._inflight

    def set_depth(self, depth: int) -> None:
        """Clamp the in-flight window after construction."""
        self.depth = max(1, int(depth))

    def close(self, wait: bool = True) -> None:
        """Shut the owned workers down. Idempotent; a closed pipeline still
        runs — every later run takes the serial inline path."""
        with self._lock:
            self._closed = True
            execs, to_stop = self._execs, list(self._execs.values())
            execs.clear()
        for ex in to_stop:
            ex.shutdown(wait=wait, cancel_futures=not wait)

    def _executor(self, kind: str) -> ThreadPoolExecutor:
        ex = self._execs.get(kind)
        if ex is None:
            with self._lock:
                ex = self._execs.get(kind)
                if ex is None:
                    ex = ThreadPoolExecutor(
                        1, thread_name_prefix=f"pipe-{kind}-{self.name}"
                    )
                    self._execs[kind] = ex
        return ex

    # -- timeline spans ------------------------------------------------------

    def _span(self, phase: str, tlkey: tuple | None, start: float | None = None):
        if tlkey is None:
            return timeline.NULL
        if self._tl is not None:
            return timeline.span(phase, *tlkey, timeline=self._tl, start=start)
        return timeline.span_for(phase, tlkey, start=start)

    # -- execution -----------------------------------------------------------

    def _staged(self, task: ChunkTask):
        with self._lock:
            self.stats["chunks"] += 1
        _M_CHUNKS.inc()
        with self._span("stage", task.tlkey):
            return task.stage()

    def _submitted(self, task: ChunkTask, payload, staged_t: float | None = None):
        """(the submit's handle, its end, the upload worker's wait since the
        stage ended at `staged_t`: 0 inline)."""
        up_wait = 0.0 if staged_t is None else time.monotonic() - staged_t
        return task.submit(payload), time.monotonic(), up_wait

    def _release_buffers(self, task: ChunkTask) -> None:
        """Hand the chunk's pooled staging buffers back — only once its
        READBACK has settled: an upload from a pinned buffer is
        asynchronous, and a mask on the host proves the inputs were
        consumed."""
        while task.release:
            self.pool.give(task.release.pop())

    def _read(self, task: ChunkTask, handle_fut: "Future") -> Any:
        try:
            handle, dispatched_t, up_wait = handle_fut.result()
            _M_WAIT_S.record(up_wait + time.monotonic() - dispatched_t)
            # The readback span opens at dispatch completion: the device has
            # been computing since the launches returned, so the readback
            # worker's dequeue latency is not device idle.
            with self._span("readback", task.tlkey, start=dispatched_t):
                return task.readback(handle)
        finally:
            self._release_buffers(task)

    def run(self, tasks) -> list:
        """Run every task through the window; returns readbacks in task
        order. depth=1 (or a closed pipeline) runs fully inline."""
        tasks = list(tasks)
        if not tasks:
            return []
        # The depth of the pipeline that ran most recently.
        _M_DEPTH.set(self.depth)
        if self.depth <= 1 or self._closed:
            return [self._run_serial(t) for t in tasks]
        return self._run_windowed(tasks)

    def _run_serial(self, task: ChunkTask) -> Any:
        """The inline leg: caller-thread stage -> submit -> readback."""
        try:
            payload = self._staged(task)
            handle, dispatched_t, _ = self._submitted(task, payload)
            # The same backdate rule as the windowed path (a fair A/B).
            with self._span("readback", task.tlkey, start=dispatched_t):
                return task.readback(handle)
        finally:
            self._release_buffers(task)

    def _run_windowed(self, tasks: list[ChunkTask]) -> list:
        up = self._executor("upload")
        rb = self._executor("readback")
        window = threading.Semaphore(self.depth)
        results: list[Future] = []

        def _release(_fut: Future) -> None:
            with self._lock:
                self._inflight -= 1
                _M_INFLIGHT.set(self._inflight)
            window.release()

        try:
            for task in tasks:
                if not window.acquire(blocking=False):
                    # Window full: the device is `depth` chunks behind the
                    # host.
                    with self._lock:
                        self.stats["stalls"] += 1
                    _M_STALLS.inc()
                    t0 = time.monotonic()
                    window.acquire()
                    _M_STALL_S.record(time.monotonic() - t0)
                with self._lock:
                    self._inflight += 1
                    _M_INFLIGHT.set(self._inflight)
                # Until _release is attached, a failing stage must free the
                # slot (and the staged buffers) itself.
                attached = False
                handle_fut = None
                try:
                    payload = self._staged(task)
                    handle_fut = up.submit(self._submitted, task, payload, time.monotonic())
                    res_fut = rb.submit(self._read, task, handle_fut)
                    res_fut.add_done_callback(_release)
                    attached = True
                finally:
                    if not attached:
                        if handle_fut is not None:
                            # An upload may already be reading the buffers:
                            # settle it before pooling them.
                            try:
                                handle_fut.result()
                            except BaseException:
                                pass
                        self._release_buffers(task)
                        _release(None)
                results.append(res_fut)
        except BaseException:
            # A failed stage must not strand earlier chunks: settle every
            # submitted future before the raise.
            for f in results:
                try:
                    f.result()
                except BaseException:
                    pass
            raise
        # Settle EVERY chunk before surfacing the first failure.
        out, first_exc = [], None
        for f in results:
            try:
                out.append(f.result())
            except BaseException as e:  # re-raised below
                if first_exc is None:
                    first_exc = e
                out.append(None)
        if first_exc is not None:
            raise first_exc
        return out
