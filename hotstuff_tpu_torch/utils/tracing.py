"""The flight recorder: a process-wide ring of structured trace events.

A trimmed copy of `hotstuff_tpu/utils/tracing.py` for the port: the
recording switch (`enabled`, `enable`, `set_clock`, `:158-177`),
`trace_id` (`:179`), `FlightRecorder` (`:287-383`), `event` (`:384`),
`dump` and `write_json` (`:398-408`) and `reset` (`:667`). The ingress
pipeline (`ingress/pipeline.py`) and the batch service's traced groups
(`verify.batch`, `crypto/batch_service.py`) record into it, and the
bench's `--trace-out` writes its dump, in the reference's JSON layout.

Recording is one `deque.append` (thread-safe under the interpreter lock;
`maxlen` evicts the oldest) gated on a module flag: a disabled `event()`
is one global read and a return. `HOTSTUFF_TRACE=0` starts it disabled,
as in the reference; the ring holds the reference's default of 16,384
events. Event times use a pluggable clock (`time.monotonic` by
default); a dump carries a (mono, wall) anchor pair, so rings dumped by
different processes line up.

Not copied: `TraceContext` and the frame trailers, the hop memory and the
`AnomalyWatchdog` (`:196-286`, `:410-666`), which only the consensus core
and the network reach, and neither is ported; nor `NODE_LABEL` and the
per-node filters of `events` and `dump`, since the port runs no node. A
dump's `node` is null, as the reference's is outside a node.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable

from . import metrics

__all__ = [
    "FlightRecorder",
    "RECORDER",
    "enabled",
    "enable",
    "set_clock",
    "event",
    "trace_id",
    "dump",
    "write_json",
    "reset",
]

_M_EVENTS = metrics.counter("trace.events")
_M_DROPPED = metrics.counter("trace.dropped")
_M_DUMPS = metrics.counter("trace.dumps")

_enabled = os.environ.get("HOTSTUFF_TRACE", "1") != "0"

_clock: Callable[[], float] = time.monotonic

# The reference's default ring size (its HOTSTUFF_TRACE_RING unset).
RING_CAPACITY = 16384


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def set_clock(fn: Callable[[], float] | None) -> Callable[[], float]:
    """Install a clock for event timestamps; returns the previous one.
    Pass None to restore the default monotonic clock."""
    global _clock
    prev, _clock = _clock, (fn or time.monotonic)
    return prev


def trace_id(round_: int, digest: bytes) -> str:
    """Canonical trace id: round + 8-byte digest prefix."""
    return f"r{round_}-{digest[:8].hex()}"


class FlightRecorder:
    """Fixed-size ring of structured events. `dump()` snapshots the ring
    without stopping writers."""

    def __init__(self, capacity: int = RING_CAPACITY) -> None:
        self.capacity = max(16, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._count = 0  # total ever recorded (dropped = count - capacity)

    def record(self, kind: str, trace: str | None = None, dur: float | None = None, data: dict | None = None) -> None:
        if not _enabled:
            return
        self._count += 1
        _M_EVENTS.inc()
        if self._count > self.capacity:
            _M_DROPPED.inc()
        self._ring.append((_clock(), kind, trace, dur, data))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return max(0, self._count - self.capacity)

    def events(self) -> list[dict]:
        """Snapshot as dicts."""
        out = []
        for t, kind, trace, dur, data in list(self._ring):
            e: dict = {"t": round(t, 6), "kind": kind}
            if trace is not None:
                e["trace"] = trace
            if dur is not None:
                e["dur"] = round(dur, 6)
            if data:
                e["data"] = data
            out.append(e)
        return out

    def dump(self) -> dict:
        """The whole artifact, with the (mono, wall) anchor pair."""
        _M_DUMPS.inc()
        return {
            "v": 1,
            "enabled": _enabled,
            "node": None,
            "capacity": self.capacity,
            "recorded": self._count,
            "dropped": self.dropped,
            "anchor": {"mono": _clock(), "wall": time.time()},
            "events": self.events(),
        }

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dump(), f, indent=2, sort_keys=True)
            f.write("\n")

    def reset(self) -> None:
        self._ring.clear()
        self._count = 0


RECORDER = FlightRecorder()


def event(kind: str, trace: str | None = None, dur: float | None = None, **data) -> None:
    """Record one event into the process flight recorder. Disabled mode is
    one global read and a return."""
    if not _enabled:
        return
    RECORDER.record(kind, trace, dur, data or None)


def dump() -> dict:
    return RECORDER.dump()


def write_json(path: str) -> None:
    RECORDER.write_json(path)


def reset() -> None:
    """Clear the recorder (test isolation, and a fresh bench run)."""
    RECORDER.reset()
