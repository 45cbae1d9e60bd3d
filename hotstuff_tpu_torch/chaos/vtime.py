"""Virtual-time event loop: the determinism substrate of the chaos runner.

Bit-identical replay (same --seed => same fault trace, same commit
sequence) is impossible on a wall-clock loop: pacemaker timers race real
message-processing jitter, and the race winner changes between runs. This
loop removes the race by making time LOGICAL: whenever no callback is
ready, the clock jumps straight to the next scheduled deadline. Timers
still fire in exactly the order (and at exactly the virtual instants)
their delays imply, but zero wall time is spent waiting — a 60-second
scenario replays in however long its Python work takes.

Requirements this imposes on the code under test (all satisfied by the
chaos orchestrator's configuration):
  * no real sockets — the FaultyTransport replaces the TCP plane;
  * no worker threads — BatchVerificationService runs inline=True and the
    stores stay below their compaction threshold (`asyncio.to_thread`
    completions arrive on wall time, which no longer advances);
  * control-flow clocks read `loop.time()` (the synchronizers do).

Implementation note: subclasses SelectorEventLoop and advances the clock
in `_run_once` before delegating; the base implementation then computes a
zero select() timeout for the now-due deadline. `_scheduled`/`_ready` are
private but stable across CPython 3.8-3.13 (the asynctest/looptime
projects rely on the same seam).
"""

from __future__ import annotations

import asyncio
import heapq
import selectors


class VirtualTimeLoop(asyncio.SelectorEventLoop):
    """Event loop whose clock jumps to the next deadline when idle."""

    def __init__(self) -> None:
        super().__init__(selectors.SelectSelector())
        self._virtual_now = 0.0

    def time(self) -> float:
        return self._virtual_now

    def _run_once(self) -> None:
        if not self._ready:
            # Mirror the base loop's cancelled-timer cleanup BEFORE reading
            # the heap top: jumping to a cancelled deadline would inflate
            # virtual time (and could fire pacemakers that a reset already
            # disarmed).
            while self._scheduled and self._scheduled[0]._cancelled:
                self._timer_cancelled_count -= 1
                handle = heapq.heappop(self._scheduled)
                handle._scheduled = False
            if self._scheduled:
                when = self._scheduled[0]._when
                if when > self._virtual_now:
                    # Overshoot by a nanosecond, the way a real clock always
                    # lands PAST a deadline. Jumping to `when` exactly
                    # leaves float-epsilon positive remainders in code that
                    # recomputes `deadline - now` (e.g. Timer.wait), whose
                    # re-armed sub-resolution timeout fires instantly and
                    # livelocks the loop at a frozen virtual instant.
                    self._virtual_now = when + 1e-9
        super()._run_once()


def run(coro, timeout: float | None = None, wall_timeout: float | None = None):
    """asyncio.run() on a fresh VirtualTimeLoop.

    `timeout` is VIRTUAL seconds — it bounds runaway virtual time (e.g. a
    scenario whose stop condition never fires). It can NOT catch a frozen
    virtual clock: if ready callbacks fire forever without the clock
    advancing (the livelock class Timer.RESOLUTION_S exists for), a
    virtual deadline never arrives. `wall_timeout` covers that: a daemon
    watchdog thread cancels the main task after real seconds. It never
    fires on a healthy run, so determinism is unaffected."""
    import threading

    loop = VirtualTimeLoop()
    asyncio.set_event_loop(loop)
    watchdog = None
    try:
        main = coro
        if timeout is not None:
            main = asyncio.wait_for(coro, timeout)
        # graftlint: allow[task-hygiene] loop bootstrap: run_until_complete + the wall watchdog own this task; no loop is running yet for actors.spawn to query
        task = loop.create_task(main)
        fired = threading.Event()  # explicit: is_alive() races the thread exit
        if wall_timeout is not None:

            def _expire() -> None:
                fired.set()
                loop.call_soon_threadsafe(task.cancel)

            watchdog = threading.Timer(wall_timeout, _expire)
            watchdog.daemon = True
            watchdog.start()
        try:
            return loop.run_until_complete(task)
        except asyncio.CancelledError:
            if fired.is_set():
                raise TimeoutError(
                    f"chaos run exceeded wall_timeout={wall_timeout}s "
                    "(frozen virtual clock / livelock?)"
                ) from None
            raise
    finally:
        if watchdog is not None:
            watchdog.cancel()
        try:
            # Iterate: cancellation handlers may spawn further tasks (e.g.
            # re-armed selector branches); a single pass leaves "Task was
            # destroyed but it is pending" noise at loop close.
            for _ in range(5):
                pending = [t for t in asyncio.all_tasks(loop) if not t.done()]
                if not pending:
                    break
                for t in pending:
                    t.cancel()
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
        finally:
            asyncio.set_event_loop(None)
            loop.close()
