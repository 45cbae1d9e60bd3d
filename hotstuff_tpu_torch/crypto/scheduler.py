"""Continuous-batching device scheduler with preemptive priority lanes.

A copy of `hotstuff_tpu/crypto/scheduler.py` for the port's batch service.
Typed sources, each with a priority class and a latency SLO, feed one
admission -> bucket -> dispatch loop:

  * **Preemptive critical lane.** Consensus-critical groups never wait out
    a lower-class flush timer: pending critical work is drained and
    dispatched first on every loop pass, outside the bulk dispatch bound.
    A critical arrival also closes the forming bulk bucket early, so
    preemption never re-delays bulk.
  * **Alignment-grid bucket sizing.** Bulk buckets are sized against the
    backend's bucket alignment (`TorchBackend.bucket_alignment`, its
    `min_bucket`): once a full grid row of work is pending the bucket
    closes. Backends without a grid flush on deadline or size alone.
  * **Continuous refill.** Bucket formation runs beside the bounded
    in-flight dispatches (`BULK_CONCURRENCY`): as one bucket dispatches,
    the next forms.
  * **Cross-backend work stealing** (`n_backends > 1`). The owning service
    may register sibling backends: each gets its own `BULK_CONCURRENCY`
    in-flight account, and a bulk bucket dispatches to the first backend
    with a free slot, home (0) preferred. A dispatch to any other backend
    counts into `pipeline.steals`. Critical work always rides home. With
    `n_backends == 1` the accounting and the dispatch hook's arity are
    those of a scheduler without stealing.

Only the consensus and mempool lanes are reachable from the sidecar: its
wire carries the urgent bit alone, which `resolve_source` maps to those
two. The other three classes are taken through `verify_group(source=...)`
by in-process callers.

The scheduler owns admission, per-lane queueing and bucket formation; the
owning `BatchVerificationService` is the dispatch executor.

Observability: per-lane queueing-delay histograms
(`scheduler.queue_<lane>_s`), bucket and flush counters in the
`scheduler.*` namespace, `pipeline.steals`, and a per-service `LaneStats`
reservoir, which the telemetry plane windows (`utils/telemetry.py`).

No wall-clock reads (event-loop time only) and no threads of its own, so
under the chaos plane's virtual-time loop, with the service's inline
dispatch, a scheduled run replays bit for bit. `SchedulerConfig.
pace_s_per_sig` models finite device occupancy in loop time (a bucket of n
signatures holds the bulk pipeline for n x pace seconds), which makes
queueing observable under a clock where Python work costs no virtual
time; its default, 0, leaves the loop as the card's path runs it.
`drain_order` simulates the loop's selection for the starvation lint.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass
from typing import Callable

from ..utils import metrics

__all__ = [
    "SourceClass",
    "SOURCE_CLASSES",
    "BULK_CONCURRENCY",
    "CONSENSUS",
    "AGGREGATE",
    "SYNC",
    "INGRESS",
    "MEMPOOL",
    "LaneStats",
    "SchedulerConfig",
    "DeviceScheduler",
    "note_queue_delay",
    "resolve_source",
    "drain_order",
]


@dataclass(frozen=True, slots=True)
class SourceClass:
    """One typed verification source: a priority class and latency SLO.

    `priority` orders lane draining (lower drains first); `slo_s` is the
    queueing-delay target (reported, never enforced); `max_delay_s` bounds
    how long a forming bucket may wait once this class has a group
    pending; `preemptive` marks the critical lane."""

    name: str
    priority: int
    slo_s: float
    max_delay_s: float
    preemptive: bool = False


# The five registered sources. QC/TC/vote/proposal checks gate round
# advancement: preemptive, no flush timer. AGGREGATE (overlay partial
# bundles) sits between consensus and sync; sync re-verification has a
# tight deadline; ingress is client-latency-sensitive bulk; mempool is
# measurement load and starves first under pressure.
CONSENSUS = SourceClass("consensus", 0, slo_s=0.002, max_delay_s=0.0, preemptive=True)
AGGREGATE = SourceClass("aggregate", 1, slo_s=0.010, max_delay_s=0.0005)
SYNC = SourceClass("sync", 2, slo_s=0.020, max_delay_s=0.001)
INGRESS = SourceClass("ingress", 3, slo_s=0.100, max_delay_s=0.002)
MEMPOOL = SourceClass("mempool", 4, slo_s=0.500, max_delay_s=0.004)

SOURCE_CLASSES: dict[str, SourceClass] = {
    c.name: c for c in (CONSENSUS, AGGREGATE, SYNC, INGRESS, MEMPOOL)
}


def resolve_source(source: str | None, urgent: bool) -> SourceClass:
    """Map a verify_group call to its SourceClass. An explicit `source`
    wins; otherwise `urgent` means consensus-critical, anything else is
    mempool bulk."""
    if source is not None:
        try:
            return SOURCE_CLASSES[source]
        except KeyError:
            raise ValueError(
                f"unknown verification source {source!r}; registered: "
                f"{sorted(SOURCE_CLASSES)}"
            ) from None
    return CONSENSUS if urgent else MEMPOOL


# A deadline within this bound of `now` counts as due, in form_bucket and
# the run loop alike, so an armed timer that fires without the loop clock
# advancing cannot re-arm forever.
RESOLUTION_S = 1e-6

_M_SUBMITTED = metrics.counter("scheduler.submitted")
# A bulk bucket dispatched to any backend but home (0); the pipeline.*
# namespace, as the reference, since each backend's slots mirror its
# dispatch pipeline's window.
_M_STEALS = metrics.counter("pipeline.steals")
_M_DISPATCHED = metrics.counter("scheduler.dispatched_groups")
_M_BUCKETS = metrics.counter("scheduler.buckets")
_M_CRITICAL = metrics.counter("scheduler.critical_dispatches")
_M_SIZE_FLUSHES = metrics.counter("scheduler.size_flushes")
_M_GRID_FLUSHES = metrics.counter("scheduler.grid_flushes")
_M_DEADLINE_FLUSHES = metrics.counter("scheduler.deadline_flushes")
_M_PREEMPT_CLOSES = metrics.counter("scheduler.preempt_closes")
_M_DEPTH = metrics.gauge("scheduler.depth")
_M_BUCKET_SIZE = metrics.histogram("scheduler.bucket_size", metrics.SIZE_BUCKETS)
# Per-lane queueing delay (submit -> dequeue into a bucket).
_QUEUE_HIST = {
    name: metrics.histogram(f"scheduler.queue_{name}_s") for name in SOURCE_CLASSES
}


def note_queue_delay(lane_stats: "LaneStats", source: str, queue_s: float) -> None:
    """Record one group's queueing delay into the lane's histogram and the
    service's reservoir. Shared by the scheduler's dequeue and the
    service's legacy flush loop, so both loops' delays read alike."""
    hist = _QUEUE_HIST.get(source)
    if hist is not None:
        hist.record(queue_s)
    lane_stats.note(source, queue_s)


class LaneStats:
    """Per-service per-lane queueing-delay reservoir: a rotating ring of
    the last CAP samples per lane, and a monotonic count of every sample
    noted (`total`), which the telemetry plane's windows key on, so that a
    window keeps seeing fresh samples after the ring rotates."""

    CAP = 65_536

    def __init__(self) -> None:
        self._samples: dict[str, deque] = {
            name: deque(maxlen=self.CAP) for name in SOURCE_CLASSES
        }
        self._total: dict[str, int] = {name: 0 for name in SOURCE_CLASSES}

    def note(self, lane: str, queue_s: float) -> None:
        ring = self._samples.get(lane)
        if ring is None:
            ring = self._samples.setdefault(lane, deque(maxlen=self.CAP))
        ring.append(queue_s)
        self._total[lane] = self._total.get(lane, 0) + 1

    def lanes(self) -> list[str]:
        return list(self._samples)

    def total(self, lane: str) -> int:
        """Samples ever noted for the lane, immune to ring rotation."""
        return self._total.get(lane, 0)

    def tail(self, lane: str, n: int) -> list[float]:
        """The most recent min(n, retained) samples, oldest first."""
        ring = self._samples.get(lane)
        if not ring or n <= 0:
            return []
        if n >= len(ring):
            return list(ring)
        out = [x for _, x in zip(range(n), reversed(ring))]
        out.reverse()
        return out

    def summary(self) -> dict[str, dict]:
        """{lane: {count, p50_ms, p99_ms, max_ms}} for lanes that saw work."""
        out = {}
        for lane, samples in self._samples.items():
            if not samples:
                continue
            ordered = sorted(samples)
            out[lane] = {
                "count": len(ordered),
                "p50_ms": round(metrics.percentile(ordered, 0.50) * 1e3, 3),
                "p99_ms": round(metrics.percentile(ordered, 0.99) * 1e3, 3),
                "max_ms": round(ordered[-1] * 1e3, 3),
            }
        return out


# In-flight non-critical buckets (2 = double buffering: stage the next
# bucket while one is on the device); the reference's default.
BULK_CONCURRENCY = 2


@dataclass(slots=True)
class SchedulerConfig:
    """Knobs beyond what the owning service carries: `pace_s_per_sig` is
    the chaos plane's virtual device-occupancy model (0 = backend-bound,
    the card's path)."""

    pace_s_per_sig: float = 0.0


class _Lane:
    __slots__ = ("cls", "queue", "enqueued", "dispatched")

    def __init__(self, cls: SourceClass) -> None:
        self.cls = cls
        self.queue: deque = deque()
        self.enqueued = 0
        self.dispatched = 0


class DeviceScheduler:
    """The admission -> bucket -> dispatch loop.

    `dispatch(groups, total, critical)` is the owning service's executor
    hook (`BatchVerificationService._spawn_dispatch`): it returns the
    spawned task, whose completion frees a bulk slot. With `n_backends >
    1` a bulk bucket's call carries a fourth argument, the index of the
    backend it goes to. Groups need only `.source`, `.t_submit`,
    `.t_dequeue` and `__len__`."""

    def __init__(
        self,
        dispatch: Callable[..., "asyncio.Task"],
        *,
        max_batch: int = 8192,
        alignment_fn: Callable[[], int] | None = None,
        lane_stats: LaneStats | None = None,
        config: SchedulerConfig | None = None,
        n_backends: int = 1,
    ) -> None:
        self._dispatch = dispatch
        self.max_batch = max_batch
        self._alignment_fn = alignment_fn or (lambda: 0)
        self.lane_stats = lane_stats or LaneStats()
        self.config = config or SchedulerConfig()
        ordered = sorted(SOURCE_CLASSES.values(), key=lambda c: c.priority)
        self._critical = [c.name for c in ordered if c.preemptive]
        self._batched = [c.name for c in ordered if not c.preemptive]
        self.lanes: dict[str, _Lane] = {c.name: _Lane(c) for c in ordered}
        # One in-flight account of bulk buckets per backend; 0 is home.
        self.n_backends = max(1, n_backends)
        self._inflight = [0] * self.n_backends
        self._wake: asyncio.Event | None = None  # bound lazily to the loop
        self.stats = {
            "submitted": 0,
            "buckets": 0,
            "critical_dispatches": 0,
            "preempt_closes": 0,
            "steals": 0,
        }

    def _pick_backend(self) -> int | None:
        """The first backend with a free bulk slot, home (0) preferred;
        None while every backend's slots are taken."""
        for idx in range(self.n_backends):
            if self._inflight[idx] < BULK_CONCURRENCY:
                return idx
        return None

    # -- admission -----------------------------------------------------------

    def submit(self, group) -> None:
        """Admit one group into its lane (lanes are unbounded; backpressure
        stays with the callers)."""
        self.lanes[group.source].queue.append(group)
        self.lanes[group.source].enqueued += 1
        self.stats["submitted"] += 1
        _M_SUBMITTED.inc()
        _M_DEPTH.set(self.depth())
        if self._wake is not None:
            self._wake.set()

    def depth(self) -> int:
        return sum(len(lane.queue) for lane in self.lanes.values())

    # -- bucket formation ----------------------------------------------------

    def _take(self, group, now: float, bucket: list) -> None:
        group.t_dequeue = now
        self.lanes[group.source].dispatched += 1
        note_queue_delay(self.lane_stats, group.source, max(0.0, now - group.t_submit))
        bucket.append(group)

    def drain_critical(self, now: float) -> list:
        """Pop every pending preemptive-lane group into one hot bucket."""
        out: list = []
        for name in self._critical:
            queue = self.lanes[name].queue
            while queue:
                self._take(queue.popleft(), now, out)
        return out

    def form_bucket(self, now: float, force: bool = False) -> tuple[list, str] | None:
        """Close and return one batched-lane bucket, or None if the loop
        should keep waiting. Close conditions, in order: `force` (a
        critical dispatch preempted the forming bucket), size (pending
        work fills max_batch), grid (a full alignment row is pending; the
        bucket closes at the largest full multiple), deadline (the oldest
        pending group aged past its class's max_delay_s). Groups are
        indivisible, so the last group taken may overshoot the target."""
        pending = sum(len(g) for name in self._batched for g in self.lanes[name].queue)
        if pending == 0:
            return None
        reason = None
        target = self.max_batch
        if force:
            reason = "preempt"
        elif pending >= self.max_batch:
            reason = "size"
        else:
            align = self._alignment_fn()
            if align > 0 and pending >= align:
                reason = "grid"
                target = (pending // align) * align
            else:
                deadline = self._next_deadline()
                if deadline is not None and now >= deadline - RESOLUTION_S:
                    reason = "deadline"
        if reason is None:
            return None
        bucket: list = []
        total = 0
        for name in self._batched:
            queue = self.lanes[name].queue
            while queue and (total < target or not bucket):
                g = queue.popleft()
                self._take(g, now, bucket)
                total += len(g)
            if total >= target:
                break
        return bucket, reason

    def _next_deadline(self) -> float | None:
        """Earliest (t_submit + class max_delay) across pending batched
        groups (lanes are FIFO, so only each lane's head matters)."""
        deadline = None
        for name in self._batched:
            lane = self.lanes[name]
            if lane.queue:
                d = lane.queue[0].t_submit + lane.cls.max_delay_s
                if deadline is None or d < deadline:
                    deadline = d
        return deadline

    # -- dispatch loop -------------------------------------------------------

    def note_bulk_done(self, _task=None, backend: int = 0) -> None:
        """Done-callback of a bulk dispatch: frees its backend's slot and
        wakes the loop (continuous refill)."""
        self._inflight[backend] -= 1
        if self._wake is not None:
            self._wake.set()

    def _ship_critical(self, now: float) -> bool:
        hot = self.drain_critical(now)
        if not hot:
            return False
        self.stats["critical_dispatches"] += 1
        _M_CRITICAL.inc()
        _M_DISPATCHED.inc(len(hot))
        _M_DEPTH.set(self.depth())
        # Outside the bulk bound: critical work never waits on a busy bulk
        # pipeline.
        self._dispatch(hot, sum(len(g) for g in hot), True)
        return True

    async def _pace_busy(self, dur: float, loop) -> None:
        """Hold the bulk pipeline busy for `dur` seconds of loop time
        (virtual under chaos) without ever delaying the critical lane:
        wake-ups inside the window ship any pending critical work, then
        the remaining occupancy elapses."""
        end = loop.time() + dur
        while True:
            remaining = end - loop.time()
            if remaining <= RESOLUTION_S:
                return  # sub-resolution remainder: same livelock class
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), remaining)
            except asyncio.TimeoutError:
                return
            self._ship_critical(loop.time())

    async def run(self) -> None:
        """The single admission -> bucket -> dispatch loop, spawned by the
        owning service."""
        loop = asyncio.get_running_loop()
        if self._wake is None:
            self._wake = asyncio.Event()
        pace = self.config.pace_s_per_sig
        while True:
            now = loop.time()
            # 1. Critical lane first; remember whether it preempted.
            preempted = self._ship_critical(now)
            # 2. One batched bucket, if a backend has a free bulk slot and
            #    a close condition holds; home preferred, any other backend
            #    is a steal.
            target = self._pick_backend()
            if target is not None:
                formed = self.form_bucket(now, force=preempted)
                if formed is not None:
                    bucket, reason = formed
                    total = sum(len(g) for g in bucket)
                    self.stats["buckets"] += 1
                    _M_BUCKETS.inc()
                    _M_DISPATCHED.inc(len(bucket))
                    _M_BUCKET_SIZE.record(total)
                    _M_DEPTH.set(self.depth())
                    if reason == "preempt":
                        self.stats["preempt_closes"] += 1
                        _M_PREEMPT_CLOSES.inc()
                    elif reason == "size":
                        _M_SIZE_FLUSHES.inc()
                    elif reason == "grid":
                        _M_GRID_FLUSHES.inc()
                    else:
                        _M_DEADLINE_FLUSHES.inc()
                    self._inflight[target] += 1
                    if target != 0:
                        self.stats["steals"] += 1
                        _M_STEALS.inc()
                    if self.n_backends == 1:
                        task = self._dispatch(bucket, total, False)
                        task.add_done_callback(self.note_bulk_done)
                    else:
                        task = self._dispatch(bucket, total, False, target)
                        task.add_done_callback(lambda t, b=target: self.note_bulk_done(t, b))
                    if pace > 0.0:
                        # The virtual occupancy model: the bulk pipeline is
                        # busy for total * pace seconds, but a critical
                        # arrival ships mid-occupancy.
                        await self._pace_busy(total * pace, loop)
                    continue
            # 3. Nothing dispatchable: wait for new work, a freed bulk slot,
            #    or the earliest pending deadline.
            self._wake.clear()
            if self.depth() > 0 and self._ship_critical(loop.time()):
                continue  # raced a critical submit against the clear
            deadline = self._next_deadline()
            timeout = None
            if deadline is not None and self._pick_backend() is not None:
                timeout = max(deadline - loop.time(), RESOLUTION_S)
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass

    def summary(self) -> dict:
        """Structured per-lane snapshot (a chaos report embeds one per node)."""
        return {
            "backends": self.n_backends,
            "inflight": list(self._inflight),
            "lanes": {
                name: {
                    "priority": lane.cls.priority,
                    "slo_ms": round(lane.cls.slo_s * 1e3, 3),
                    "enqueued": lane.enqueued,
                    "dispatched": lane.dispatched,
                    "depth": len(lane.queue),
                }
                for name, lane in self.lanes.items()
            },
            "queue_delay": self.lane_stats.summary(),
            **self.stats,
        }


# ---------------------------------------------------------------------------
# Starvation lint support


class _StubGroup:
    """Minimal group shape for the drain-order simulation: the scheduler's
    formation logic only reads source/t_submit/len()."""

    __slots__ = ("source", "t_submit", "t_dequeue", "n")

    def __init__(self, source: str, t_submit: float, n: int = 1) -> None:
        self.source = source
        self.t_submit = t_submit
        self.t_dequeue = 0.0
        self.n = n

    def __len__(self) -> int:
        return self.n


def drain_order(classes: tuple[SourceClass, ...] | None = None) -> list[str]:
    """Simulate the loop's selection over one group per registered class
    with NO further arrivals, advancing a synthetic clock past each pending
    deadline, and return the lane names in the order their groups were
    dequeued. A registered class missing from the result can be enqueued
    but never selected: the starvation condition."""
    sched = DeviceScheduler(lambda groups, total, critical: None)
    classes = classes or tuple(SOURCE_CLASSES.values())
    now = 0.0
    for cls in classes:
        sched.submit(_StubGroup(cls.name, now))
    order: list[str] = []
    for _ in range(4 * len(classes) + 4):  # bounded: no arrivals, must drain
        for g in sched.drain_critical(now):
            order.append(g.source)
        formed = sched.form_bucket(now)
        if formed is not None:
            order.extend(g.source for g in formed[0])
        if sched.depth() == 0:
            break
        deadline = sched._next_deadline()
        now = (deadline if deadline is not None else now) + 1e-6
    return order
