"""Device-occupancy timeline: per-chunk (stage, upload, dispatch, readback)
intervals of the verifier chunk loops, for host<->device gap attribution.

Counterpart of `hotstuff_tpu/ops/timeline.py`, with the same phases,
output keys and summary arithmetic. Every pipeline phase of a verifier
chunk is recorded as an INTERVAL on one monotonic host clock, from which
`summary()` derives:

  * **occupancy** — the fraction of the recorded span in which the
    device-facing phases (upload / dispatch / readback) were busy; the
    complement is host-only time in which the card had nothing from this
    loop.
  * **idle gaps** — the gaps between consecutive busy segments (count /
    total / p50 / max).
  * **overlap headroom** — for consecutive chunks of one batch,
    sum(min(upload_dur(N+1), dispatch_dur(N))) / sum(upload_dur): how much
    of chunk N+1's upload fits under chunk N's dispatch.

The intervals are host intervals on CUDA as on the TPU: an upload of a
pinned buffer and a kernel launch return once queued, so the device's own
compute shows in the `readback` span, which the dispatch pipeline opens at
dispatch completion (`ops/pipeline.py`) and closes when the chunk's
readback event has fired.

Recording is a deque append into a ring of 4,096 intervals (oldest
evicted), gated on `HOTSTUFF_TIMELINE=0`; timestamps are `time.monotonic()`, and dumps carry a
(mono, wall) anchor pair.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..utils import metrics

__all__ = [
    "PHASES",
    "DEVICE_PHASES",
    "DeviceTimeline",
    "TIMELINE",
    "enabled",
    "enable",
    "span",
    "span_for",
    "NULL",
    "summary",
    "dump",
    "write_json",
    "reset",
]

# The four pipeline phases of one verifier chunk, in pipeline order.
# `stage` is host CPU (numpy wire-format staging); the other three face the
# device and define occupancy.
PHASES: tuple[str, ...] = ("stage", "upload", "dispatch", "readback")
DEVICE_PHASES: frozenset[str] = frozenset({"upload", "dispatch", "readback"})

_M_INTERVALS = metrics.counter("timeline.intervals")
_M_DROPPED = metrics.counter("timeline.dropped")

_enabled = os.environ.get("HOTSTUFF_TIMELINE", "1") != "0"


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


class DeviceTimeline:
    """Ring of (batch, chunk, phase, t0, t1, n) intervals.

    `batch` numbers one verify_batch_mask[_committee] call; `chunk` is the
    chunk's index within its batch (the upload worker is a 1-worker FIFO,
    so chunk order is dispatch order). The caller thread and both pipeline
    workers record; appends are deque-atomic."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = max(16, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._count = 0
        self._batch_seq = 0
        self._lock = threading.Lock()

    def next_batch(self) -> int:
        with self._lock:
            self._batch_seq += 1
            return self._batch_seq

    def note(
        self, batch: int, chunk: int, phase: str, t0: float, t1: float, n: int = 0
    ) -> None:
        if not _enabled:
            return
        with self._lock:
            self._count += 1
        _M_INTERVALS.inc()
        if self._count > self.capacity:
            _M_DROPPED.inc()
        self._ring.append((batch, chunk, phase, t0, t1, n))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return max(0, self._count - self.capacity)

    def intervals(self) -> list[dict]:
        return [
            {
                "batch": b,
                "chunk": c,
                "phase": p,
                "t0": round(t0, 6),
                "t1": round(t1, 6),
                "n": n,
            }
            for b, c, p, t0, t1, n in list(self._ring)
        ]

    # -- derived numbers -----------------------------------------------------

    def summary(self) -> dict:
        """Occupancy / idle-gap / overlap-headroom over the whole ring, from
        ONE ring snapshot. An empty ring gives zeros in the same shape."""
        iv = list(self._ring)
        out = {
            "batches": 0,
            "chunks": 0,
            "span_s": 0.0,
            "occupancy": 0.0,
            "overlap_headroom": 0.0,
            "phase_s": {p: 0.0 for p in PHASES},
            "idle": {"count": 0, "total_s": 0.0, "p50_s": 0.0, "max_s": 0.0},
        }
        if not iv:
            return out
        t_lo = min(t0 for _b, _c, _p, t0, _t1, _n in iv)
        t_hi = max(t1 for _b, _c, _p, _t0, t1, _n in iv)
        phase_s = {p: 0.0 for p in PHASES}
        busy: list[tuple[float, float]] = []
        chunks = set()
        batches = set()
        upload_dur: dict[tuple[int, int], float] = {}
        dispatch_dur: dict[tuple[int, int], float] = {}
        for b, c, p, t0, t1, n in iv:
            dur = max(0.0, t1 - t0)
            phase_s[p] = phase_s.get(p, 0.0) + dur
            chunks.add((b, c))
            batches.add(b)
            if p in DEVICE_PHASES:
                busy.append((t0, t1))
            if p == "upload":
                upload_dur[(b, c)] = upload_dur.get((b, c), 0.0) + dur
            elif p == "dispatch":
                dispatch_dur[(b, c)] = dispatch_dur.get((b, c), 0.0) + dur
        # merge the device-busy segments into a union, then read occupancy
        # and the idle gaps off the merged cover
        busy.sort()
        merged: list[list[float]] = []
        for t0, t1 in busy:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        busy_s = sum(t1 - t0 for t0, t1 in merged)
        span_s = max(t_hi - t_lo, 1e-12)
        gaps = [
            merged[i + 1][0] - merged[i][1]
            for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]
        ]
        # overlap headroom: chunk N+1's upload vs chunk N's dispatch, paired
        # within one batch
        total_upload = sum(upload_dur.values())
        hideable = sum(
            min(dur, dispatch_dur.get((b, c - 1), 0.0))
            for (b, c), dur in upload_dur.items()
            if c > 0
        )
        out.update(
            {
                "batches": len(batches),
                "chunks": len(chunks),
                "span_s": round(span_s, 6),
                "occupancy": round(busy_s / span_s, 6),
                "overlap_headroom": round(
                    hideable / total_upload if total_upload > 0 else 0.0, 6
                ),
                "phase_s": {p: round(s, 6) for p, s in phase_s.items()},
                "idle": {
                    "count": len(gaps),
                    "total_s": round(sum(gaps), 6),
                    "p50_s": round(metrics.percentile(gaps, 0.50), 6),
                    "max_s": round(max(gaps), 6) if gaps else 0.0,
                },
            }
        )
        return out

    def dump(self) -> dict:
        """Structured artifact with a (mono, wall) anchor pair, so a reader
        can place the monotonic intervals on the wall clock."""
        return {
            "v": 1,
            "kind": "device_timeline",
            # The reference's node label; the port records no node.
            "node": None,
            "capacity": self.capacity,
            "recorded": self._count,
            "dropped": self.dropped,
            # graftlint: allow[determinism] dump-alignment stamp, mirrors the flight recorder's (mono, wall) anchor
            "anchor": {"mono": time.monotonic(), "wall": time.time()},
            "intervals": self.intervals(),
            "summary": self.summary(),
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=2, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        self._ring.clear()
        self._count = 0


TIMELINE = DeviceTimeline()


class _Span:
    """Context manager recording one interval (monotonic enter/exit).

    `start` backdates the interval's opening edge to a moment the caller
    already observed (clamped to never sit in the future): the dispatch
    pipeline opens each `readback` span at dispatch completion, because the
    device has been computing since then even if the readback worker
    dequeued the chunk late.
    """

    __slots__ = ("_tl", "_batch", "_chunk", "_phase", "_n", "_t0", "_start")

    def __init__(
        self,
        tl: DeviceTimeline,
        phase: str,
        batch: int,
        chunk: int,
        n: int,
        start: float | None = None,
    ):
        self._tl = tl
        self._phase = phase
        self._batch = batch
        self._chunk = chunk
        self._n = n
        self._t0 = 0.0
        self._start = start

    def __enter__(self) -> "_Span":
        now = time.monotonic()
        self._t0 = now if self._start is None else min(self._start, now)
        return self

    def __exit__(self, *exc) -> None:
        self._tl.note(
            self._batch, self._chunk, self._phase, self._t0, time.monotonic(), self._n
        )


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL = _NullSpan()


def span(
    phase: str,
    batch: int,
    chunk: int,
    n: int = 0,
    timeline: DeviceTimeline | None = None,
    start: float | None = None,
):
    """`with timeline.span("upload", b, c, n): ...` — no-op when disabled."""
    if not _enabled:
        return NULL
    # `is None`, not truthiness: an EMPTY DeviceTimeline is falsy (__len__).
    return _Span(
        TIMELINE if timeline is None else timeline, phase, batch, chunk, n, start
    )


def span_for(phase: str, tlkey: tuple | None, start: float | None = None):
    """`span` over the chunk loops' optional (batch, chunk, n) key: NULL
    when the key is None (their "timeline off" sentinel)."""
    if tlkey is None:
        return NULL
    return span(phase, *tlkey, start=start)


def summary() -> dict:
    return TIMELINE.summary()


def dump() -> dict:
    return TIMELINE.dump()


def write_json(path: str) -> None:
    TIMELINE.write_json(path)


def reset() -> None:
    TIMELINE.reset()
