"""Actor/channel utilities: the node's async substrate.

A copy of `hotstuff_tpu/utils/actors.py` for the port: bounded channels
(`channel`), tracked spawns (`spawn`), a select-like multiplexer for
(channel, timer) loops (`Selector`) and the pacemaker's resettable
`Timer`. The reference is an actor-per-subsystem design on tokio: every
component owns an mpsc receiver and runs an infinite select! loop in its
own task, with no shared mutable state; this module gives the same
discipline on asyncio.

Not copied: the chaos runner's `SpawnScope` (the port has no chaos
runner).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Coroutine

log = logging.getLogger("hotstuff.actors")

# Default channel capacity, matching the reference's mpsc bounds (100-1000).
CHANNEL_CAPACITY = 1_000


def channel(capacity: int = CHANNEL_CAPACITY) -> asyncio.Queue:
    return asyncio.Queue(capacity)


_tasks: set[asyncio.Task] = set()


def spawn(coro: Coroutine, name: str | None = None) -> asyncio.Task:
    """Spawn a long-lived actor task. Keeps a strong reference (asyncio only
    holds weak refs) and logs unexpected termination -- actors are expected to
    run forever, like the reference's spawned loops."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _tasks.add(task)

    def _done(t: asyncio.Task) -> None:
        _tasks.discard(t)
        if t.cancelled():
            return
        exc = t.exception()
        if exc is not None:
            log.error("actor %s crashed: %r", t.get_name(), exc, exc_info=exc)

    task.add_done_callback(_done)
    return task


class Selector:
    """Multiplexes many awaitable sources into one loop, like tokio::select!.

    Each source is re-armed after it yields, so no message is lost. Branches
    are (name, factory) where factory() returns a fresh awaitable.
    """

    # A ready branch that loses this many consecutive selections is served
    # regardless of priority. Priorities express TIE-BREAKS (who wins a
    # same-instant race), not precedence: without the bound, a flooded
    # higher-priority source (e.g. a peer spraying cheap SyncRequests)
    # starves the pacemaker branch indefinitely — strictly weaker liveness
    # than the reference's randomized select!, which serves any ready branch
    # with p >= 1/2 per iteration.
    STARVATION_BOUND = 8

    def __init__(self, starvation_bound: int = STARVATION_BOUND) -> None:
        self._factories: dict[str, Any] = {}
        self._pending: dict[str, asyncio.Task] = {}
        self._priority: dict[str, int] = {}
        self._last: str | None = None  # round-robin fairness cursor
        self._starvation_bound = starvation_bound
        self._deferred: dict[str, int] = {}  # consecutive ready-but-passed

    def add(self, name: str, factory, priority: int = 0) -> None:
        """Register a branch. Lower `priority` wins ties (same-instant
        readiness); rotation for fairness applies only WITHIN a priority
        class. Use a higher number for branches that must lose ties, e.g.
        a pacemaker timer that should not beat a proposal already queued
        (firing the timeout first would bump last_voted_round and withhold
        the vote for a block that arrived in time)."""
        self._factories[name] = factory
        self._priority[name] = priority

    def remove(self, name: str) -> None:
        self._factories.pop(name, None)
        self._priority.pop(name, None)
        self._deferred.pop(name, None)
        task = self._pending.pop(name, None)
        if task is not None:
            task.cancel()

    def ready(self, name: str) -> bool:
        """True iff `name`'s armed awaitable has already completed — i.e. a
        value is waiting to be returned by the next `next()` call. Lets a
        branch handler's inner fast-path loop yield to a higher-priority
        branch (the armed task consumes the queue item, so checking the
        queue's emptiness misses it)."""
        task = self._pending.get(name)
        return task is not None and task.done()

    async def next(self) -> tuple[str, Any]:
        """Wait for the first ready branch; returns (name, value)."""
        for name, factory in self._factories.items():
            if name not in self._pending:
                self._pending[name] = asyncio.ensure_future(factory())
        while True:
            done, _ = await asyncio.wait(
                self._pending.values(), return_when=asyncio.FIRST_COMPLETED
            )
            # Deterministic round-robin within each priority class: start
            # AFTER the branch served last, so a branch whose source is
            # continuously ready (e.g. a flooded tx channel) cannot starve
            # later-registered branches (tokio's select! randomizes for the
            # same reason; rotation keeps tests deterministic).
            names = sorted(
                self._factories, key=lambda n: self._priority.get(n, 0)
            )
            if self._last in names:
                prio = self._priority.get(self._last, 0)
                cls = [n for n in names if self._priority.get(n, 0) == prio]
                i = cls.index(self._last) + 1
                rotated = cls[i:] + cls[:i]
                it = iter(rotated)
                names = [
                    next(it) if self._priority.get(n, 0) == prio else n
                    for n in names
                ]
            ready = [
                n
                for n in names
                if (t := self._pending.get(n)) is not None and t.done()
            ]
            if not ready:
                continue
            winner = ready[0]
            # Bounded deferral: branches passed over while ready accumulate a
            # loss count; one that reaches the bound is served now. At most
            # one branch can cross the bound per call (counts reset on win).
            for n in ready[1:]:
                self._deferred[n] = self._deferred.get(n, 0) + 1
                if self._deferred[n] >= self._starvation_bound:
                    winner = n
            self._deferred.pop(winner, None)
            task = self._pending.pop(winner)
            self._last = winner
            return winner, task.result()

    def close(self) -> None:
        for task in self._pending.values():
            task.cancel()
        self._pending.clear()


class Timer:
    """Resettable timer (reference consensus/src/timer.rs:10-34): `wait()`
    resolves `delay_ms` after the most recent reset(). Deadline-based so that
    a wait() armed BEFORE a reset still honours the new deadline (an
    event-based version orphans pending waiters on reset, silently killing
    the pacemaker of any replica that processed a block)."""

    # Remainders below this count as due, in wait() AND expired() alike.
    # A remainder inside the event loop's clock resolution (~1 ns) makes
    # wait_for schedule a timeout the loop treats as ALREADY due: it fires
    # without the clock advancing, the recomputed remainder is unchanged,
    # and the waiter livelocks re-arming it (observed on the chaos
    # virtual-time loop, where nothing else nudges the clock). One
    # microsecond is far below any protocol-relevant delay.
    RESOLUTION_S = 1e-6

    def __init__(self, delay_ms: int) -> None:
        self._delay = delay_ms / 1000.0
        self._deadline = 0.0
        self._moved: asyncio.Event | None = None
        self.reset()

    def reset(self) -> None:
        from . import tracing

        if tracing.enabled():
            tracing.event("timer.arm", delay_ms=round(self._delay * 1000.0, 3))
        loop = asyncio.get_event_loop()
        self._deadline = loop.time() + self._delay
        # Wake pending waiters: an in-flight sleep targets the OLD deadline,
        # and if the new one is EARLIER (pacemaker backoff shrinking the
        # delay back to base) the waiter would silently oversleep by the
        # difference. Waiters re-check the fresh deadline and re-sleep.
        if self._moved is not None:
            moved, self._moved = self._moved, None
            moved.set()

    def set_delay_ms(self, delay_ms: float) -> None:
        """Change the delay applied by FUTURE reset() calls (pacemaker
        backoff); the current deadline is untouched."""
        self._delay = delay_ms / 1000.0

    @property
    def delay_ms(self) -> float:
        return self._delay * 1000.0

    def expired(self) -> bool:
        """True iff the CURRENT deadline has passed (within RESOLUTION_S —
        must agree with wait(), or a sub-resolution remainder spins the
        selector: wait() returns 'due' while expired() says 'stale').
        Consumers multiplexing wait() with message channels must re-check
        this when the timer branch wins: a completed wait() may predate a
        reset() that raced it (a stale expiry must not fire a timeout for
        the new round)."""
        return (
            asyncio.get_event_loop().time() >= self._deadline - self.RESOLUTION_S
        )

    async def wait(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            remaining = self._deadline - loop.time()
            if remaining <= self.RESOLUTION_S:
                from . import tracing

                tracing.event("timer.fire")
                return
            if self._moved is None:
                self._moved = asyncio.Event()
            moved = self._moved
            try:
                await asyncio.wait_for(moved.wait(), remaining)
            except asyncio.TimeoutError:
                pass  # deadline may have moved either way; loop re-checks
