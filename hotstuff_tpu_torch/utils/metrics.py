"""In-process metrics registry for the port's verifier, batch service,
scheduler and BLS committee table.

A trimmed copy of `hotstuff_tpu/utils/metrics.py`: only what
`crypto/batch_service.py`, `crypto/scheduler.py`, the verifier's chunk
loop (`ops/verifier.py`, `ops/pipeline.py`, `ops/timeline.py`) and the
BLS committee table (`ops/bls.py`: `bls.table_builds`, `bls.aggregations`,
`bls.points_aggregated`; the reference's `bls.host_fallbacks` has no
counterpart, since the port has no host fallback) and `TorchBackend`'s
routing (`crypto.*`, `verifier.crossover_fallbacks`, ...) and the
telemetry plane (`utils/telemetry.py`: `telemetry.*`) record into, and
what reads and clears it: `dump`, `snapshot_json` and `write_json` (the
bench's `--metrics-out`, in the reference's layout,
`hotstuff_tpu/utils/metrics.py:354-386`) and `reset`.

  * `counter(name)` / `gauge(name)` / `histogram(name)` — get-or-create
    metrics in a process-global registry. Counters are monotonic;
    histograms use fixed bucket bounds and derive p50/p95/p99 by
    interpolation inside the owning bucket.
  * `span(histogram)` — a context manager timing its block into a
    histogram; while a torch profiler records, also a `record_function`
    range of the histogram's name on the thread that runs the block.
  * `watch_collector()` — each garbage collection's pause into
    `runtime.gc_s` and `runtime.gc_collections` (`gc.callbacks`).
  * `percentile(values, q)` — the nearest-rank percentile over raw samples
    (the scheduler's `LaneStats`, the timeline's idle gaps);
    `bucket_percentile` — the interpolated one over bucket counts (the
    histograms' own, and the telemetry plane's windowed percentiles).

Metric names are the reference's (`scheduler.*`, `verifier.*`,
`pipeline.*`, `timeline.*`, `bls.*`), so a dump of either package reads the
same; the port's own (`service.*`, `backend.*`, `pipeline.wait_s`,
`runtime.*`) have no counterpart there. Every metric guards its state with
its own lock: the service's dispatch threads, the pipeline's workers and
the event loop record concurrently.

`start_periodic_emitter(interval_s)` logs the dump without bucket counts
as one `METRICS {json}` line on `hotstuff.metrics` every `interval_s`
from a daemon thread (`emit_snapshot`), as the reference node does
(`hotstuff_tpu/utils/metrics.py:456-483`); the port's node starts it.
Metric locks are re-entrant, as the reference's: the node writes its dump
from a SIGTERM handler on the main thread, which may be parked inside a
`record()`.

`timed`, the recording switch and the eagerly registered namespace are
not ported: a dump's `enabled` is always true.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import sys
import threading
import time
from bisect import bisect_left
from typing import Sequence

log = logging.getLogger("hotstuff.metrics")

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "TIME_BUCKETS_S",
    "SIZE_BUCKETS",
    "counter",
    "gauge",
    "histogram",
    "dump",
    "emit_snapshot",
    "bucket_percentile",
    "percentile",
    "snapshot_json",
    "write_json",
    "reset",
    "span",
    "start_periodic_emitter",
    "watch_collector",
]

# Re-entrant: a SIGTERM handler that dumps on the main thread must not
# deadlock on a lock that thread holds mid-record.
_new_lock = threading.RLock

# Wall-seconds buckets (1-2-5 series, 10 us .. 60 s).
TIME_BUCKETS_S: tuple[float, ...] = (
    1e-5, 2e-5, 5e-5, 1e-4, 2e-4, 5e-4, 1e-3, 2e-3, 5e-3,
    1e-2, 2e-2, 5e-2, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0,
)

# Power-of-two buckets for batch/queue sizes (1 .. 128k).
SIZE_BUCKETS: tuple[float, ...] = tuple(float(2**i) for i in range(18))


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over raw samples (ceil rank), 0.0 on empty
    input."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))
    return ordered[idx]


def bucket_percentile(
    bounds: Sequence[float], counts: Sequence[int], total: int, lo: float, hi: float, q: float
) -> float:
    """Interpolated percentile over bucket counts, clamped to the observed
    [lo, hi]; `counts` has one overflow entry past `bounds`."""
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c and cum + c >= target:
            b_lo = float(bounds[i - 1]) if i > 0 else lo
            b_hi = float(bounds[i]) if i < len(bounds) else hi
            b_lo = max(b_lo, lo)
            b_hi = max(min(b_hi, hi), b_lo)
            return b_lo + (b_hi - b_lo) * ((target - cum) / c)
        cum += c
    return hi


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = _new_lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = _new_lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles. `bounds` are
    the inclusive upper edges of the finite buckets; one overflow bucket
    catches everything above the last."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Sequence[float] = TIME_BUCKETS_S) -> None:
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be sorted and non-empty")
        self.name = name
        self.bounds = tuple(float(b) for b in buckets)
        self._lock = _new_lock()
        self._reset()

    def record(self, v: float) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def summary(self) -> dict:
        """count, sum, min, max, mean, p50, p95, p99 from one locked
        snapshot."""
        with self._lock:
            counts, total, s, lo, hi = list(self._counts), self._count, self._sum, self._min, self._max
        if total == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        pct = lambda q: bucket_percentile(self.bounds, counts, total, lo, hi, q)
        return {"count": total, "sum": s, "min": lo, "max": hi, "mean": s / total,
                "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}

    def buckets_dict(self) -> dict:
        with self._lock:
            counts = list(self._counts)
        return {"le": list(self.bounds) + ["+inf"], "counts": counts}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")


class Registry:
    """Named metrics, get-or-create."""

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = _new_lock()

    def _get_or_create(self, name: str, kind, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {kind.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, buckets: Sequence[float] = TIME_BUCKETS_S) -> Histogram:
        return self._get_or_create(name, Histogram, lambda: Histogram(name, buckets))

    def dump(self, include_buckets: bool = True) -> dict:
        """{v, enabled, counters, gauges, histograms (summaries, with each
        histogram's bucket counts unless `include_buckets` is False)} by
        name: the reference's `--metrics-out` layout."""
        with self._lock:
            metrics = list(self._metrics.values())
        out = {"v": 1, "enabled": True, "counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            else:
                summary = m.summary()
                if include_buckets:
                    summary["buckets"] = m.buckets_dict()
                out["histograms"][m.name] = summary
        return out

    def snapshot_json(self) -> str:
        """One-line JSON of the dump without bucket counts."""
        return json.dumps(self.dump(include_buckets=False), separators=(",", ":"), sort_keys=True)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=2, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        """Zero every metric; registrations are kept."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = TIME_BUCKETS_S) -> Histogram:
    return REGISTRY.histogram(name, buckets)


def _profiler():
    """`torch.autograd.profiler` while a torch profiler records, else None.

    Read from `sys.modules`, so this module imports no torch. The flag is
    torch's process-wide one, true on every thread from a profiler's start
    to its stop: `torch.autograd._profiler_enabled()` reads the calling
    thread's profiler state, which is false on threads the profiler did not
    start on and, with `profile_all_threads`, on every thread."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class _Span:
    """Context manager timing one stage into a histogram (see `span`)."""

    __slots__ = ("_hist", "_t0", "_range")

    def __init__(self, hist: Histogram) -> None:
        self._hist = hist
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "_Span":
        prof = _profiler()
        if prof is not None:
            self._range = prof.record_function(self._hist.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.record(time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)


def span(hist: Histogram) -> _Span:
    """`with metrics.span(h): ...` — time the block's wall seconds into
    histogram `h`. While a torch profiler records, the block is also a
    `record_function` range named as the histogram, on the thread that runs
    it, so the registry's spans lie on the device trace's clock."""
    return _Span(hist)


class _CollectorWatch:
    """A `gc.callbacks` entry: each collection's pause into `runtime.gc_s`
    (a `span`, so a range on the collecting thread while a profiler records)
    and one count into `runtime.gc_collections`. CPython runs one collection
    at a time, so one open span suffices."""

    def __init__(self) -> None:
        self._pause = histogram("runtime.gc_s")
        self._collections = counter("runtime.gc_collections")
        self._open: _Span | None = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._open = span(self._pause).__enter__()
        elif self._open is not None:
            s, self._open = self._open, None
            s.__exit__(None, None, None)
            self._collections.inc()


_collector_watch: _CollectorWatch | None = None
_watch_lock = threading.Lock()


def watch_collector() -> None:
    """Time every collection of the process from now on (idempotent). The
    `runtime.*` metrics exist from the first call."""
    global _collector_watch
    with _watch_lock:
        if _collector_watch is None:
            _collector_watch = _CollectorWatch()
            gc.callbacks.append(_collector_watch)


def dump(include_buckets: bool = True) -> dict:
    return REGISTRY.dump(include_buckets)


def snapshot_json() -> str:
    return REGISTRY.snapshot_json()


def write_json(path: str) -> None:
    REGISTRY.write_json(path)


def reset() -> None:
    REGISTRY.reset()


def emit_snapshot() -> None:
    """Log one `METRICS {json}` line (the benchmark log parser's contract)."""
    log.info("METRICS %s", snapshot_json())


_emitter_stop: threading.Event | None = None
_emitter_lock = threading.Lock()


def start_periodic_emitter(interval_s: float = 5.0) -> threading.Event | None:
    """Emit a snapshot line every `interval_s` from a daemon thread; returns
    the stop event (set() to halt), or None when interval <= 0 or an emitter
    is already running."""
    global _emitter_stop
    if interval_s <= 0:
        return None
    with _emitter_lock:
        if _emitter_stop is not None and not _emitter_stop.is_set():
            return None
        stop = _emitter_stop = threading.Event()

    def _loop() -> None:
        while not stop.wait(interval_s):
            emit_snapshot()

    threading.Thread(target=_loop, name="metrics-emitter", daemon=True).start()
    return stop
