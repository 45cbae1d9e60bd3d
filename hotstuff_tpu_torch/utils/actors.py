"""Tracked task spawning for the port's asyncio loops.

A trimmed copy of `hotstuff_tpu/utils/actors.py:75-94`: `spawn` only. The
reference's channels, selector, timers and chaos `SpawnScope` are not
ported; the sidecar needs none of them.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Coroutine

log = logging.getLogger("hotstuff.actors")

_tasks: set[asyncio.Task] = set()


def spawn(coro: Coroutine, name: str | None = None) -> asyncio.Task:
    """Spawn a long-lived task. Keeps a strong reference (asyncio holds
    tasks weakly) and logs a task that ends on an exception."""
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
