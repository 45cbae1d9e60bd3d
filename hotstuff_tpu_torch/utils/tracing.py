"""Causal tracing, the flight recorder and the anomaly watchdog.

A copy of `hotstuff_tpu/utils/tracing.py` for the port, so a dump, a
trace id and a frame trailer of either package read the same:

  * **Causal trace context**: `TraceContext(round, digest8, hop)`, an
    18-byte token for one block's journey, rides an optional 22-byte
    trailer inside a network frame (`network/net.py`), self-delimited by
    a magic suffix, so trailer-less frames parse unchanged and trailered
    ones are stripped (`strip_trailer`) before the codec sees them. The
    bytes are the reference's (`TRAILER_MAGIC`, `_CTX`), so port and
    reference nodes read each other's frames.
  * **Flight recorder**: a process-wide ring of `RING_CAPACITY` (16,384,
    the reference's default) structured events; recording is one
    `deque.append` gated on a module flag (`HOTSTUFF_TRACE=0` starts it
    disabled). A dump carries a (mono, wall) anchor pair and the node
    label (`NODE_LABEL`, the keys-file stem in a node process; null
    elsewhere).
  * **Anomaly watchdog** (`WATCHDOG`): dumps the ring when a round stalls
    past N timeouts (the consensus core), egress backpressure is
    sustained (the payload maker), the per-signature verification cost
    regresses against the run's own baseline (the batch service,
    `note_verify`), an epoch handoff breaks its contract (the epoch
    manager), or an SLO burns its error budget (the telemetry plane,
    `note_slo_burn`). `node/main.py --trace-out` arms its
    file-writing hook. Context hooks (`add_context_hook`) add sections to
    every auto-dump: a telemetry plane's `attach_watchdog` registers one,
    so each dump carries the plane's last snapshots.

The chaos runner's parts are copied too: the `chaos.fault`, `chaos.crash`
and `chaos.restart` event kinds, an explicit `record` label (an in-process
node's index) and the per-node filter and cap of `events`.

Not copied: the ring size from `HOTSTUFF_TRACE_RING` and the per-node
filters of `dump` / `write_json` (the chaos runner reads `events`).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Callable

from . import metrics

log = logging.getLogger("hotstuff.tracing")

__all__ = [
    "TraceContext",
    "FlightRecorder",
    "AnomalyWatchdog",
    "RECORDER",
    "WATCHDOG",
    "NODE_LABEL",
    "STAGES",
    "EVENT_KINDS",
    "TRAILER_MAGIC",
    "TRAILER_SIZE",
    "enabled",
    "enable",
    "set_clock",
    "event",
    "trace_id",
    "context_for",
    "note_received",
    "strip_trailer",
    "dump",
    "write_json",
    "reset",
]

# The six per-block lifecycle stages stitched into the commit-latency
# breakdown (in order: proposal -> payload-fetch -> verify -> vote ->
# QC-assembly -> commit).
STAGES: tuple[str, ...] = (
    "propose", "payload", "verify", "vote", "qc", "commit",
)

# Auxiliary event kinds the recorder accepts (everything `event()` may be
# called with; the lint enforces literals against this set).
EVENT_KINDS: frozenset[str] = frozenset(STAGES) | {
    "net.send",
    "net.recv",
    "net.probe",
    "timer.arm",
    "timer.fire",
    "timeout",
    "sync.request",
    "sync.retry",
    "payload.gossip",
    "payload.stored",
    "payload.served",
    "ingress.recv",
    "ingress.admit",
    "ingress.shed",
    "ingress.verify",
    "ingress.forward",
    "ingress.reject",
    "verify.batch",
    "agg.bundle",
    "agg.fallback",
    "backpressure.on",
    "backpressure.off",
    "chaos.fault",
    "chaos.crash",
    "chaos.restart",
    "watchdog.round_stall",
    "watchdog.verify_regression",
    "watchdog.backpressure",
    "watchdog.slo_burn",
    "slo.clear",
    "dump",
}

_M_EVENTS = metrics.counter("trace.events")
_M_DROPPED = metrics.counter("trace.dropped")
_M_DUMPS = metrics.counter("trace.dumps")
_M_TRIGGERS = metrics.counter("trace.watchdog_triggers")
_M_FRAMES_STRIPPED = metrics.counter("trace.frames_stripped")

_enabled = os.environ.get("HOTSTUFF_TRACE", "1") != "0"

# Pluggable clock: production uses the monotonic clock; the chaos
# orchestrator installs its virtual-time loop's `loop.time` so recorded
# timelines follow the deterministic replay.
_clock: Callable[[], float] = time.monotonic

# The reference's default ring size (its HOTSTUFF_TRACE_RING unset).
RING_CAPACITY = 16384

# Which logical node is executing (an index in the chaos runner, a name
# in a real node process). Inherited by every task/thread spawned while
# set, so one in-process recorder can attribute events per node.
NODE_LABEL: contextvars.ContextVar[object | None] = contextvars.ContextVar(
    "trace-node-label", default=None
)


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


# ---------------------------------------------------------------------------
# Trace context + frame trailer


def trace_id(round_: int, digest: bytes) -> str:
    """Canonical trace id for one block: round + 8-byte digest prefix.
    Derivable anywhere the block (or its QC / a vote on it) is in hand."""
    return f"r{round_}-{digest[:8].hex()}"


# Trailer layout (appended INSIDE the 4-byte-length frame):
#   [0x01 version][round u64 BE][digest prefix 8B][hop u8][4B magic]
# Detection keys on the magic suffix + version byte: a trailer-less frame
# whose payload happens to end with these 5 bytes misparses with
# probability ~2^-40 per frame — accepted (the trailer is observability,
# never a correctness dependency).
TRAILER_MAGIC = b"\x9c\x54\x52\x31"  # \x9c 'TR1'
_CTX = struct.Struct(">BQ8sB")
TRAILER_SIZE = _CTX.size + len(TRAILER_MAGIC)  # 22 bytes


class TraceContext:
    """Compact causal token: (round, block-digest prefix, hop counter)."""

    __slots__ = ("round", "digest8", "hop")

    def __init__(self, round_: int, digest8: bytes, hop: int = 0) -> None:
        self.round = round_
        self.digest8 = bytes(digest8[:8]).ljust(8, b"\0")
        self.hop = min(hop, 255)

    @property
    def trace_id(self) -> str:
        return f"r{self.round}-{self.digest8.hex()}"

    def encode(self) -> bytes:
        return _CTX.pack(1, self.round, self.digest8, self.hop)

    @staticmethod
    def decode(data: bytes) -> "TraceContext":
        ver, round_, digest8, hop = _CTX.unpack(data)
        if ver != 1:
            raise ValueError(f"unknown trace-context version {ver}")
        return TraceContext(round_, digest8, hop)

    def trailer(self) -> bytes:
        return self.encode() + TRAILER_MAGIC

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}, hop={self.hop})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.round == other.round
            and self.digest8 == other.digest8
            and self.hop == other.hop
        )


def strip_trailer(
    data: bytes, count: bool = True
) -> tuple[bytes, TraceContext | None]:
    """Split one framed payload into (codec bytes, trace context or None).
    Trailer-less frames pass through untouched, so trailer-enabled and
    trailer-less peers interoperate in both directions. `count=False`
    skips the inbound-frame counter (for send-side peeks — the chaos
    transport strips for its adversary policies and re-appends)."""
    if len(data) >= TRAILER_SIZE and data.endswith(TRAILER_MAGIC):
        try:
            ctx = TraceContext.decode(data[-TRAILER_SIZE:-len(TRAILER_MAGIC)])
        except (ValueError, struct.error):
            return data, None
        if count:
            _M_FRAMES_STRIPPED.inc()
        return data[:-TRAILER_SIZE], ctx
    return data, None


# Received-hop memory: trace_id -> hop of the last inbound frame carrying
# it, so a relayed message (vote for a received proposal) can extend the
# causal chain instead of restarting it. Bounded insertion-ordered dict.
_HOP_CAP = 1024
_hops: dict[str, int] = {}
_hops_lock = threading.Lock()


def note_received(ctx: TraceContext) -> None:
    """Record an inbound context (called by NetReceiver / the chaos
    transport after stripping a trailer)."""
    with _hops_lock:
        _hops[ctx.trace_id] = ctx.hop
        while len(_hops) > _HOP_CAP:
            _hops.pop(next(iter(_hops)))


def context_for(round_: int, digest: bytes) -> TraceContext:
    """Context for an OUTBOUND message about block (round, digest): hop
    extends the received chain when this node saw the block arrive, else
    starts at 0 (this node originated it)."""
    ctx = TraceContext(round_, digest)
    with _hops_lock:
        prev = _hops.get(ctx.trace_id)
    if prev is not None:
        ctx.hop = min(prev + 1, 255)
    return ctx


# ---------------------------------------------------------------------------
# Flight recorder


class FlightRecorder:
    """Fixed-size ring of structured events.

    Recording is a single `deque.append` (thread-safe under the GIL,
    maxlen evicts the oldest) — cheap enough for per-frame and per-stage
    stamping on the hot path. `dump()` snapshots the ring without
    stopping writers (a torn tail of one in-flight event is acceptable
    for a diagnostic artifact; a lock on the hot path is not)."""

    def __init__(self, capacity: int = RING_CAPACITY) -> None:
        self.capacity = max(16, capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._count = 0  # total ever recorded (dropped = count - len)

    _USE_CTX = object()  # record(): default = read NODE_LABEL

    def record(
        self,
        kind: str,
        trace: str | None = None,
        dur: float | None = None,
        data: dict | None = None,
        label: object = _USE_CTX,
    ) -> None:
        if not _enabled:
            return
        self._count += 1
        _M_EVENTS.inc()
        if self._count > self.capacity:
            _M_DROPPED.inc()
        if label is self._USE_CTX:
            label = NODE_LABEL.get()
        self._ring.append((_clock(), label, kind, trace, dur, data))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return max(0, self._count - self.capacity)

    def events(self, node: object | None = None, limit: int | None = None) -> list[dict]:
        """Snapshot as dicts, optionally filtered to one node label and
        capped to the most recent `limit` events."""
        out = []
        for t, label, kind, trace, dur, data in list(self._ring):
            if node is not None and label != node:
                continue
            e: dict = {"t": round(t, 6), "kind": kind}
            if label is not None:
                e["node"] = label
            if trace is not None:
                e["trace"] = trace
            if dur is not None:
                e["dur"] = round(dur, 6)
            if data:
                e["data"] = data
            out.append(e)
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def dump(self) -> dict:
        """Full structured artifact. The (mono, wall) anchor pair lets
        `tools/trace_report.py` align rings dumped by different
        processes onto one wall-clock timeline."""
        _M_DUMPS.inc()
        return {
            "v": 1,
            "enabled": _enabled,
            "node": NODE_LABEL.get(),
            "capacity": self.capacity,
            "recorded": self._count,
            "dropped": self.dropped,
            # graftlint: allow[determinism] dump-alignment stamp (merges per-process dumps onto one wall timeline)
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


def event(
    kind: str,
    trace: str | None = None,
    dur: float | None = None,
    **data,
) -> None:
    """Record one event into the process flight recorder. Hot paths pass
    positional (kind, trace, dur) only — the kwargs dict is for cold
    sites. Disabled mode is a single global read + return."""
    if not _enabled:
        return
    RECORDER.record(kind, trace, dur, data or None)


def dump() -> dict:
    return RECORDER.dump()


def write_json(path: str) -> None:
    RECORDER.write_json(path)


# ---------------------------------------------------------------------------
# Anomaly watchdog


class AnomalyWatchdog:
    """Event-driven anomaly detector that triggers recorder dumps.

    Layers feed it observations (no polling thread — it must work
    unmodified under the chaos runner's virtual clock):

      * `note_timeout(round, consecutive)` — consensus pacemaker firings;
        `consecutive >= stall_timeouts` means the round is wedged beyond
        the ordinary crash-fault view-change (2 per rotation).
      * `note_backpressure(active)` — egress cold-lane backpressure
        transitions from the payload maker; active for longer than
        `backpressure_s` means gossip fan-out cannot reach a majority.
      * `note_verify(dur_s, n)` — per-flush verification cost from the
        BatchVerificationService; a sustained per-signature cost above
        `p99_factor` x the run's own baseline (the MEDIAN of the first
        BASELINE_SAMPLES flushes, so cold-compile outliers do not poison
        it) is a verify regression (the card's route fell to the host, a
        relay degraded, ...).
      * `note_handoff_violation(...)` — an epoch handoff that broke its
        contract, from the epoch manager.
      * `note_slo_burn(slo, burn_short, burn_long)` — an SLO burn-rate
        alert from the telemetry plane (`utils/telemetry.py`).

    Each reason fires at most once per `cooldown_s`; firing records a
    `watchdog.<reason>` event and invokes every registered dump hook
    with (reason, detail). `node/main.py` installs a file-writing hook
    next to `--trace-out`; its dumps carry the sections of every context
    hook under `context`.
    """

    # note_verify: samples whose median is the baseline, and consecutive
    # regressed flushes required before firing (one slow flush is noise).
    BASELINE_SAMPLES = 32
    REGRESSION_STREAK = 8

    def __init__(
        self,
        stall_timeouts: int | None = None,
        backpressure_s: float | None = None,
        p99_factor: float | None = None,
        cooldown_s: float | None = None,
    ) -> None:
        env = os.environ.get
        self.stall_timeouts = stall_timeouts if stall_timeouts is not None else int(
            env("HOTSTUFF_TRACE_STALL_TIMEOUTS", "3")
        )
        self.backpressure_s = backpressure_s if backpressure_s is not None else float(
            env("HOTSTUFF_TRACE_BACKPRESSURE_S", "5")
        )
        self.p99_factor = p99_factor if p99_factor is not None else float(
            env("HOTSTUFF_TRACE_P99_FACTOR", "4")
        )
        self.cooldown_s = cooldown_s if cooldown_s is not None else float(
            env("HOTSTUFF_TRACE_COOLDOWN_S", "30")
        )
        self._hooks: list[Callable[[str, dict], None]] = []
        # Callables returning sections merged into every auto-dump (a
        # telemetry plane's last snapshots).
        self._context_hooks: list[Callable[[], dict]] = []
        self._last_fired: dict[str, float] = {}
        self._bp_since: float | None = None
        self._verify_samples: list[float] = []
        self._verify_baseline: float | None = None
        self._verify_streak = 0
        self.triggers: list[dict] = []

    # -- hooks ---------------------------------------------------------------

    def add_dump_hook(self, fn: Callable[[str, dict], None]) -> None:
        self._hooks.append(fn)

    def remove_dump_hook(self, fn: Callable[[str, dict], None]) -> None:
        try:
            self._hooks.remove(fn)
        except ValueError:
            pass

    def add_context_hook(self, fn: Callable[[], dict]) -> None:
        self._context_hooks.append(fn)

    def remove_context_hook(self, fn: Callable[[], dict]) -> None:
        try:
            self._context_hooks.remove(fn)
        except ValueError:
            pass

    def context(self) -> dict:
        """The sections of every context hook, merged (dict-valued keys
        merge shallowly, so several planes each add under 'telemetry'); a
        failing hook is skipped, never the dump."""
        out: dict = {}
        for fn in list(self._context_hooks):
            try:
                d = fn() or {}
            except Exception as e:
                log.warning("watchdog context hook failed: %r", e)
                continue
            for k, v in d.items():
                if isinstance(v, dict) and isinstance(out.get(k), dict):
                    out[k].update(v)
                else:
                    out[k] = v
        return out

    def set_auto_dump(self, path_prefix: str) -> Callable[[str, dict], None]:
        """Install (and return) a hook writing `<prefix>.watchdog-<reason>-<n>.json`
        per trigger."""
        seq = {"n": 0}

        def _write(reason: str, detail: dict) -> None:
            seq["n"] += 1
            path = f"{path_prefix}.watchdog-{reason}-{seq['n']}.json"
            try:
                d = RECORDER.dump()
                d["watchdog"] = {"reason": reason, **detail}
                ctx = self.context()
                if ctx:
                    d["context"] = ctx  # e.g. the telemetry plane's last snapshots
                with open(path, "w") as f:
                    json.dump(d, f, indent=2, sort_keys=True)
                    f.write("\n")
                log.warning("watchdog %s: flight recorder dumped to %s", reason, path)
            except OSError as e:
                log.warning("watchdog %s: dump failed: %r", reason, e)

        self.add_dump_hook(_write)
        return _write

    def _trigger(self, reason: str, **detail) -> None:
        now = _clock()
        last = self._last_fired.get(reason)
        if last is not None and now - last < self.cooldown_s:
            return
        self._last_fired[reason] = now
        _M_TRIGGERS.inc()
        RECORDER.record(f"watchdog.{reason}", None, None, detail or None)
        self.triggers.append({"t": round(now, 6), "reason": reason, **detail})
        log.warning("anomaly watchdog fired: %s %s", reason, detail)
        for hook in list(self._hooks):
            try:
                hook(reason, detail)
            except Exception as e:
                log.warning("watchdog hook failed: %r", e)

    # -- observations --------------------------------------------------------

    def note_timeout(self, round_: int, consecutive: int) -> None:
        if not _enabled:
            return
        if consecutive >= self.stall_timeouts:
            self._trigger("round_stall", round=round_, consecutive=consecutive)
        # A stall is also the moment to check whether backpressure has
        # been pinning the egress plane (the freeze signature:
        # stalled rounds WITH a saturated cold lane).
        if self._bp_since is not None:
            self.note_backpressure(True)

    def note_backpressure(self, active: bool) -> None:
        if not _enabled:
            return
        now = _clock()
        if active:
            if self._bp_since is None:
                self._bp_since = now
                RECORDER.record("backpressure.on", None, None, None)
            elif now - self._bp_since >= self.backpressure_s:
                self._trigger(
                    "backpressure",
                    sustained_s=round(now - self._bp_since, 3),
                )
        elif self._bp_since is not None:
            RECORDER.record(
                "backpressure.off", None, None,
                {"sustained_s": round(now - self._bp_since, 3)},
            )
            self._bp_since = None

    def note_slo_burn(self, slo: str, burn_short: float, burn_long: float) -> None:
        """Both of an SLO's evaluation windows burn error budget past the
        plane's factor: fires the `slo_burn` reason under the usual
        cooldown (the plane keeps each SLO's fired/cleared state)."""
        if not _enabled:
            return
        self._trigger("slo_burn", slo=slo, burn_short=round(burn_short, 3), burn_long=round(burn_long, 3))

    def note_handoff_violation(
        self, epoch: int, activation_round: int, trigger_round: int
    ) -> None:
        """An epoch-final handoff contract violation from the epoch
        manager (consensus/reconfig.py): a committed EpochChange's
        2-chain completion landed at/past its declared activation round,
        so gap rounds were certified by the old committee. Under the
        certification wall this requires a Byzantine quorum or a broken
        wall — fire the `handoff_violation` reason (recorder event +
        auto-dump hooks) so the run is diagnosed, not just counted."""
        if not _enabled:
            return
        self._trigger(
            "handoff_violation",
            epoch=epoch,
            activation_round=activation_round,
            trigger_round=trigger_round,
        )

    def note_verify(self, dur_s: float, n: int) -> None:
        if not _enabled or n <= 0:
            return
        per_sig = dur_s / n
        if self._verify_baseline is None:
            # Median, not mean: the first flushes may include a cold
            # kernel build; a mean baseline would sit far above the warm
            # cost and the trigger would never fire for the runs it is for.
            self._verify_samples.append(per_sig)
            if len(self._verify_samples) >= self.BASELINE_SAMPLES:
                ordered = sorted(self._verify_samples)
                self._verify_baseline = ordered[len(ordered) // 2]
                self._verify_samples = []
                log.info("watchdog verify baseline: %.3f us a signature (the median of %d flushes)",
                         1e6 * self._verify_baseline, len(ordered))
            return
        baseline = self._verify_baseline
        if baseline > 0 and per_sig > self.p99_factor * baseline:
            self._verify_streak += 1
            if self._verify_streak >= self.REGRESSION_STREAK:
                self._verify_streak = 0
                self._trigger(
                    "verify_regression",
                    per_sig_s=round(per_sig, 9),
                    baseline_s=round(baseline, 9),
                )
        else:
            self._verify_streak = 0

    def reset(self) -> None:
        self._last_fired.clear()
        self._context_hooks = []
        self._bp_since = None
        self._verify_samples = []
        self._verify_baseline = None
        self._verify_streak = 0
        self.triggers = []


WATCHDOG = AnomalyWatchdog()


def reset() -> None:
    """Clear recorder, hop memory, and watchdog state (test isolation)."""
    RECORDER.reset()
    WATCHDOG.reset()
    with _hops_lock:
        _hops.clear()
