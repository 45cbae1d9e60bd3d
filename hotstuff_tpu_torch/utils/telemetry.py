"""Live telemetry plane: delta snapshots, SLO burn-rate alerts, and a
scrapeable per-node endpoint.

The port's copy of `hotstuff_tpu/utils/telemetry.py`, its imports rewritten
to this package, so a port node answers a scrape as a reference node does:

  * **Delta-snapshot ring** — `TelemetryPlane.snapshot()` reads the
    process metrics registry and records DELTAS since the previous
    snapshot: counter/gauge movement, windowed histogram percentiles
    (computed from bucket-count deltas, so each snapshot's p50/p99
    describe that window's samples, not the whole run), and per-lane
    queueing stats from the owning service's `LaneStats`
    (`crypto/scheduler.py`, windowed on its monotonic `total()`, so a
    window survives the ring's rotation). Snapshots carry only the
    injected clock, so a plane fed the same observations at the same
    `now` gives the same ring.

  * **SLO burn-rate evaluator** — `SLOSpec` binds a latency objective to a
    metrics histogram or a `LaneStats` lane. Each snapshot contributes
    (good, bad) events per SLO; the evaluator keeps TWO windows, counted
    in snapshots (short reacts fast, long filters blips), and fires when
    BOTH burn error budget faster than `burn_factor`x. Firing raises the
    `slo_burn` watchdog reason (`tracing.WATCHDOG.note_slo_burn`:
    auto-dump, cooldown); the alert clears when the short window is back
    under budget. Transitions are logged ("SLO burn fired: ...") and kept
    in `alerts`.

  * **Scrape endpoint** — `TelemetryServer` answers framed JSON requests
    ({"cmd": "scrape"}) on the stack's 4-byte length framing
    (`network/net.py` `frame`, `FrameReader`), serving the plane's dump:
    snapshot ring, alert history, active alerts, cumulative lane stats,
    the device-occupancy timeline summary (`ops/timeline.py`) and the
    per-peer link ledger (`network/net.py` `peer_snapshot`) when attached.
    The bytes on the wire are the reference's, so its
    `tools/telemetry_dash.py --poll` reads a port node and each package's
    `scrape_sync` reads the other's server. `node.main run
    --telemetry-port` and `bench --telemetry-port` expose it.

A plane registered with `attach_watchdog` feeds the watchdog's context
hooks: every `<path>.watchdog-<reason>-<n>.json` auto-dump embeds the last
`dump_snapshots` ring entries.

`default_slos` keeps the reference's set. `proofs.serve` reads no events
in the port until the commit-proof plane is ported (`proofs.serve_s` is
never recorded), and `reconfig.handoff` reads `reconfig.handoff_lag_rounds`
from the port's epoch manager. `peer_latency_map` (RTT EWMA per directed link, which the chaos
plane's WAN scenarios read) is copied; `fleet_rollup`, which distils a
chaos report into the scenario matrix's cell record, waits for the port's
scenario matrix.

Imports only the standard library and the port's `utils.metrics` /
`utils.tracing` (`crypto.scheduler`, `network.net` and `utils.actors`
lazily), never torch.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from collections import deque
import threading
from dataclasses import dataclass

from . import metrics, tracing

log = logging.getLogger("hotstuff.telemetry")

__all__ = [
    "SLOSpec",
    "VERIFY_E2E_SLO_S",
    "default_slos",
    "TelemetryConfig",
    "TelemetryPlane",
    "TelemetryServer",
    "PeerView",
    "peer_views",
    "infer_fleet_regions",
    "peer_latency_map",
    "scrape",
    "scrape_sync",
    "serve_in_thread",
    "weighted_percentile",
    "merge_lane_summaries",
]

_M_SNAPSHOTS = metrics.counter("telemetry.snapshots")
_M_FIRED = metrics.counter("telemetry.slo_burn_fired")
_M_CLEARED = metrics.counter("telemetry.slo_burn_cleared")
_M_SCRAPES = metrics.counter("telemetry.scrapes")
_M_PEER_VIEWS = metrics.counter("telemetry.peer_views")

# End-to-end verify-latency target for one device batch
# (verifier.e2e_s): a batch habitually slower than this is a degraded
# relay / host-fallback signature, the same class of anomaly the
# watchdog's verify_regression streak looks for — the SLO form makes it
# a budgeted, scrapeable objective instead of a streak heuristic.
VERIFY_E2E_SLO_S = float(os.environ.get("HOTSTUFF_VERIFY_E2E_SLO_S", "0.25"))


@dataclass(frozen=True)
class SLOSpec:
    """One latency objective the telemetry plane evaluates.

    `metric` names a histogram row of the metrics registry. With `lane`
    set, events come from the attached LaneStats lane instead
    (per-service, fresh per run — the scheduler lane SLOs); otherwise from the global histogram's
    bucket-count deltas (a delta bucket counts as violating when its
    LOWER edge is already past the threshold — conservative by one
    bucket). `objective` is the target fraction of samples under
    `threshold_s`; the error budget is its complement."""

    name: str
    metric: str
    threshold_s: float
    objective: float = 0.99
    lane: str | None = None


def default_slos() -> tuple[SLOSpec, ...]:
    """The evaluated SLO set of record: one lane SLO per registered
    scheduler source class (threshold = the class's published slo_s)
    plus the device verify-latency target, the epoch handoff and the
    commit-proof serving targets: the reference's set."""
    from ..crypto.scheduler import SOURCE_CLASSES

    slos = [
        SLOSpec(
            name=f"lane.{name}",
            metric=f"scheduler.queue_{name}_s",
            threshold_s=cls.slo_s,
            objective=0.99,
            lane=name,
        )
        for name, cls in sorted(SOURCE_CLASSES.items())
    ]
    slos.append(
        SLOSpec(
            name="verify.e2e",
            metric="verifier.e2e_s",
            threshold_s=VERIFY_E2E_SLO_S,
            objective=0.99,
        )
    )
    # Epoch-final handoff contract (consensus/reconfig.py). The
    # histogram's unit is ROUNDS, not seconds: every healthy handoff
    # records lag 0 (bucket lower edge 0 < threshold — never burns), a
    # violated handoff records >= 1 (lower edge 0.5 > threshold — burns
    # immediately), so a delayed-commit handoff fires the slo_burn
    # alert + auto-dump instead of only logging.
    slos.append(
        SLOSpec(
            name="reconfig.handoff",
            metric="reconfig.handoff_lag_rounds",
            threshold_s=0.4,
            objective=0.99,
        )
    )
    # Commit-proof serving: time from a proof query arriving to the proof
    # in the reply (the sub-second finality-read contract). The port
    # records no proofs.serve_s until it has the commit-proof plane, so
    # this SLO reads no events.
    slos.append(
        SLOSpec(
            name="proofs.serve",
            metric="proofs.serve_s",
            threshold_s=1.0,
            objective=0.99,
        )
    )
    return tuple(slos)


# Counter/gauge prefixes worth shipping in snapshots (the reference's:
# counts, deterministic under a virtual clock; wall-time-valued histograms
# are excluded unless explicitly configured).
_DEFAULT_PREFIXES = (
    "chaos.",
    "consensus.",
    "crypto.",
    "ingress.",
    "mempool.",
    "net.",
    "proofs.",
    "reconfig.",
    "scheduler.",
    "telemetry.",
    "timeline.",
    "trace.",
    "verifier.",
)


@dataclass
class TelemetryConfig:
    """Knobs for one plane.

    `histograms` lists the namespace histograms whose windowed
    percentiles ride in snapshots; the default covers the scheduler's
    loop-time queue rows (deterministic under a virtual clock — a
    wall-time histogram such as `verifier.e2e_s` would break a replay's
    bit-identical ring, so it is read only by its SLO).
    Window sizes are in SNAPSHOTS: short reacts within
    `short_window * interval_s`, long filters blips."""

    interval_s: float = 5.0
    ring: int = 256
    short_window: int = 2
    long_window: int = 6
    burn_factor: float = 2.0
    dump_snapshots: int = 8  # last K embedded in watchdog auto-dumps
    counter_prefixes: tuple[str, ...] = _DEFAULT_PREFIXES
    histograms: tuple[str, ...] = (
        "scheduler.queue_consensus_s",
        "scheduler.queue_aggregate_s",
        "scheduler.queue_sync_s",
        "scheduler.queue_ingress_s",
        "scheduler.queue_mempool_s",
        "scheduler.bucket_size",
    )


def _delta_percentile(bounds: tuple, counts: list[int], q: float) -> float:
    """Interpolated percentile over DELTA bucket counts (no observed
    min/max for a window, so edges clamp to [0, last finite bound])."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    return metrics.bucket_percentile(
        bounds, counts, total, 0.0, float(bounds[-1]), q
    )


class _SloState:
    """Per-SLO evaluation window + alert latch."""

    __slots__ = ("spec", "window", "active")

    def __init__(self, spec: SLOSpec, long_window: int) -> None:
        self.spec = spec
        self.window: deque = deque(maxlen=max(1, long_window))
        self.active = False

    @property
    def warmed(self) -> bool:
        """True once the long window is FULL. Firing before that would
        judge burn_long over a handful of entries — a single bad snapshot
        right after plane start would satisfy both windows at once,
        exactly the blip the long window exists to filter."""
        return len(self.window) == self.window.maxlen

    @staticmethod
    def _burn(entries, budget: float) -> float:
        good = sum(g for g, _b in entries)
        bad = sum(b for _g, b in entries)
        total = good + bad
        if total <= 0:
            return 0.0  # no data = no burn (lets an idle lane clear)
        return (bad / total) / max(budget, 1e-9)

    def observe(self, good: int, bad: int, short_window: int) -> tuple[float, float]:
        self.window.append((good, bad))
        budget = 1.0 - self.spec.objective
        entries = list(self.window)
        return (
            self._burn(entries[-max(1, short_window):], budget),
            self._burn(entries, budget),
        )


class TelemetryPlane:
    """One node's live telemetry: snapshot ring + SLO evaluator.

    `lane_stats` is the owning BatchVerificationService's LaneStats (or a
    zero-arg callable resolving it — the chaos runner re-resolves across
    crash/restart); `timeline_fn` returns the device-occupancy summary
    (ops/timeline.py `TIMELINE.summary`) for dumps; `peers_fn` returns
    the node's per-peer observatory snapshot (`network/net.py
    peer_snapshot` — injected rather than imported, keeping utils/ free
    of a network dependency); `clock` defaults to `time.monotonic` and
    the chaos orchestrator passes its virtual `loop.time`."""

    def __init__(
        self,
        label: object | None = None,
        config: TelemetryConfig | None = None,
        slos: tuple[SLOSpec, ...] | None = None,
        lane_stats=None,
        timeline_fn=None,
        peers_fn=None,
        registry: metrics.Registry | None = None,
        clock=None,
    ) -> None:
        self.label = label
        self.config = config or TelemetryConfig()
        self.slos = tuple(slos if slos is not None else default_slos())
        self._lane_stats = lane_stats
        self._timeline_fn = timeline_fn
        self._peers_fn = peers_fn
        self._registry = registry or metrics.REGISTRY
        self._clock = clock or time.monotonic
        self._ring: deque = deque(maxlen=max(4, self.config.ring))
        self._seq = 0
        self._prev_counters: dict[str, float] = {}
        self._prev_buckets: dict[str, list[int]] = {}
        self._lane_cursor: dict[str, int] = {}
        self._lane_src = None  # the LaneStats the cursors index into
        self._slo_state = {
            spec.name: _SloState(spec, self.config.long_window)
            for spec in self.slos
        }
        self.alerts: list[dict] = []
        self._watchdog: tracing.AnomalyWatchdog | None = None
        self._context_hook = None
        # Baseline the delta state at plane BIRTH: the registry is
        # process-global and outlives the plane (tests run planes
        # back to back), so the first snapshot must not report the whole
        # process history as one giant delta — same-seed chaos runs would
        # otherwise differ in exactly that first entry.
        self._prime()

    def _prime(self) -> None:
        d = self._registry.dump(include_buckets=True)
        self._prev_counters = {
            name: v
            for name, v in d["counters"].items()
            if name.startswith(self.config.counter_prefixes)
        }
        self._prev_buckets = {
            name: list(row["buckets"]["counts"])
            for name, row in d["histograms"].items()
            if "buckets" in row
        }

    # -- watchdog context (auto-dumps embed the metric trajectory) -----------

    def attach_watchdog(
        self, watchdog: tracing.AnomalyWatchdog | None = None
    ) -> None:
        self.detach_watchdog()
        self._watchdog = watchdog or tracing.WATCHDOG

        def _ctx() -> dict:
            return {
                "telemetry": {
                    str(self.label): self.snapshots(
                        last=self.config.dump_snapshots
                    )
                }
            }

        self._context_hook = _ctx
        self._watchdog.add_context_hook(_ctx)

    def detach_watchdog(self) -> None:
        if self._watchdog is not None and self._context_hook is not None:
            self._watchdog.remove_context_hook(self._context_hook)
        self._watchdog = None
        self._context_hook = None

    # -- snapshotting --------------------------------------------------------

    def _resolve_lane_stats(self):
        ls = self._lane_stats
        return ls() if callable(ls) else ls

    def snapshot(self, now: float | None = None) -> dict:
        """Take one delta snapshot, append it to the ring, and evaluate
        every SLO. Deterministic: derives only from registry/LaneStats
        state and the injected clock."""
        now = self._clock() if now is None else now
        cfg = self.config
        d = self._registry.dump(include_buckets=True)
        snap: dict = {"seq": self._seq, "t": round(now, 6)}
        self._seq += 1

        counters = {}
        for name in sorted(d["counters"]):
            if not name.startswith(cfg.counter_prefixes):
                continue
            v = d["counters"][name]
            delta = v - self._prev_counters.get(name, 0)
            self._prev_counters[name] = v
            if delta:
                counters[name] = delta
        if counters:
            snap["counters"] = counters
        gauges = {
            name: round(v, 6)
            for name, v in sorted(d["gauges"].items())
            if v and name.startswith(cfg.counter_prefixes)
        }
        if gauges:
            snap["gauges"] = gauges

        # windowed histogram percentiles from bucket-count deltas
        hist_events: dict[str, tuple[int, int]] = {}  # metric -> (good, bad)
        hists = {}
        hist_rows = dict(d["histograms"])
        wanted = set(cfg.histograms) | {
            s.metric for s in self.slos if s.lane is None
        }
        for name in sorted(wanted):
            row = hist_rows.get(name)
            if row is None or "buckets" not in row:
                continue
            counts = row["buckets"]["counts"]
            bounds = tuple(
                b for b in row["buckets"]["le"] if not isinstance(b, str)
            )
            prev = self._prev_buckets.get(name)
            delta = [
                c - (prev[i] if prev and i < len(prev) else 0)
                for i, c in enumerate(counts)
            ]
            self._prev_buckets[name] = list(counts)
            total = sum(delta)
            spec = next(
                (s for s in self.slos if s.lane is None and s.metric == name),
                None,
            )
            if spec is not None:
                bad = sum(
                    c
                    for i, c in enumerate(delta)
                    if i > 0 and float(bounds[i - 1]) >= spec.threshold_s
                )
                hist_events[name] = (max(0, total - bad), bad)
            if total > 0 and name in cfg.histograms:
                hists[name] = {
                    "count": total,
                    "p50": round(_delta_percentile(bounds, delta, 0.50), 6),
                    "p99": round(_delta_percentile(bounds, delta, 0.99), 6),
                }
        if hists:
            snap["hist"] = hists

        # per-lane windows from the service-local LaneStats
        lane_events: dict[str, tuple[int, int]] = {}  # lane -> (good, bad)
        lane_thresholds = {
            s.lane: s.threshold_s for s in self.slos if s.lane is not None
        }
        ls = self._resolve_lane_stats()
        if ls is not None:
            if ls is not self._lane_src:
                # Fresh LaneStats (a chaos restart rebuilds the service):
                # stale cursors would hide every post-restart sample until
                # the new lists outgrew them — restart the windows at zero.
                self._lane_src = ls
                self._lane_cursor.clear()
            lanes = {}
            for lane in ls.lanes():
                # Cursor in MONOTONIC-total terms, not list positions:
                # LaneStats rotates its reservoir at CAP, so a position
                # cursor would freeze once the list stops growing — the
                # live lane SLOs would go permanently blind (and clear
                # active alerts via the no-data rule) after ~CAP verifies.
                total = ls.total(lane)
                cur = self._lane_cursor.get(lane, 0)
                if cur > total:  # same object, counters reset
                    cur = 0
                fresh = total - cur
                self._lane_cursor[lane] = total
                if fresh <= 0:
                    lane_events.setdefault(lane, (0, 0))
                    continue
                # More arrivals than the reservoir retains in one window:
                # judge the retained tail (the overflow is unknowable).
                new = ls.tail(lane, fresh)
                threshold = lane_thresholds.get(lane)
                bad = (
                    sum(1 for s in new if s > threshold)
                    if threshold is not None
                    else 0
                )
                lane_events[lane] = (len(new) - bad, bad)
                lanes[lane] = {
                    "count": len(new),
                    "p50_ms": round(metrics.percentile(new, 0.50) * 1e3, 3),
                    "p99_ms": round(metrics.percentile(new, 0.99) * 1e3, 3),
                    "bad": bad,
                }
            if lanes:
                snap["lanes"] = lanes

        self._evaluate(now, hist_events, lane_events, ls is not None)
        active = sorted(
            name for name, st in self._slo_state.items() if st.active
        )
        if active:
            snap["active"] = active
        self._ring.append(snap)
        _M_SNAPSHOTS.inc()
        if self._timeline_fn is not None:
            # One scrapeable line per snapshot (benchmark/logs.py folds
            # these into the report's `+ TELEMETRY:` section). Log-only:
            # the ring stays device-free so chaos rings (no timeline)
            # and device rings share one schema.
            try:
                dev = self._timeline_fn()
            except Exception:
                dev = None
            if dev and dev.get("chunks"):
                log.info(
                    "TELEMETRY device occupancy %.1f%% overlap headroom "
                    "%.1f%%",
                    dev["occupancy"] * 100.0,
                    dev["overlap_headroom"] * 100.0,
                )
        return snap

    def _evaluate(
        self,
        now: float,
        hist_events: dict[str, tuple[int, int]],
        lane_events: dict[str, tuple[int, int]],
        have_lane_stats: bool,
    ) -> None:
        cfg = self.config
        for spec in self.slos:
            if spec.lane is not None:
                if not have_lane_stats:
                    continue  # no lane source attached: nothing to judge
                good, bad = lane_events.get(spec.lane, (0, 0))
            else:
                good, bad = hist_events.get(spec.metric, (0, 0))
            state = self._slo_state[spec.name]
            burn_short, burn_long = state.observe(
                good, bad, cfg.short_window
            )
            if (
                not state.active
                and state.warmed
                and burn_short >= cfg.burn_factor
                and burn_long >= cfg.burn_factor
            ):
                state.active = True
                _M_FIRED.inc()
                self.alerts.append(
                    {
                        "slo": spec.name,
                        "event": "fired",
                        "t": round(now, 6),
                        "burn_short": round(burn_short, 3),
                        "burn_long": round(burn_long, 3),
                    }
                )
                log.warning(
                    "SLO burn fired: %s (burn %.1fx short / %.1fx long, "
                    "threshold %.3fs)",
                    spec.name,
                    burn_short,
                    burn_long,
                    spec.threshold_s,
                )
                (self._watchdog or tracing.WATCHDOG).note_slo_burn(
                    spec.name, burn_short, burn_long
                )
            elif state.active and burn_short < 1.0:
                state.active = False
                _M_CLEARED.inc()
                self.alerts.append(
                    {
                        "slo": spec.name,
                        "event": "cleared",
                        "t": round(now, 6),
                        "burn_short": round(burn_short, 3),
                        "burn_long": round(burn_long, 3),
                    }
                )
                log.warning("SLO burn cleared: %s", spec.name)
                tracing.event("slo.clear", None, None, slo=spec.name)

    async def run(self) -> None:
        """Periodic snapshot loop; spawn with actors.spawn so a chaos
        crash/teardown cancels it with the owning scope. Virtual-time
        safe: only `asyncio.sleep` + `loop.time`."""
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.config.interval_s)
            self.snapshot(loop.time())

    # -- read side -----------------------------------------------------------

    def snapshots(self, last: int | None = None) -> list[dict]:
        out = list(self._ring)
        if last is not None and len(out) > last:
            out = out[-last:]
        return out

    def active_alerts(self) -> list[str]:
        return sorted(n for n, st in self._slo_state.items() if st.active)

    def dump(self, last: int | None = None) -> dict:
        """The scrape payload / report embed. `commits` sums the
        consensus.commits deltas across the ring — accurate for a real
        one-node process; the chaos orchestrator overwrites it with the
        per-node truth (its registry is process-global across nodes)."""
        ls = self._resolve_lane_stats()
        snaps = self.snapshots(last)
        commits = sum(
            s.get("counters", {}).get("consensus.commits", 0) for s in snaps
        )
        return {
            "v": 1,
            "kind": "telemetry",
            "node": self.label,
            "interval_s": self.config.interval_s,
            # graftlint: allow[determinism] cross-process alignment stamp in scrape metadata; excluded from bit-identity checks
            "anchor": {"mono": self._clock(), "wall": time.time()},
            "snapshots": snaps,
            "alerts": list(self.alerts),
            "active_alerts": self.active_alerts(),
            "slos": [
                {
                    "name": s.name,
                    "metric": s.metric,
                    "threshold_s": s.threshold_s,
                    "objective": s.objective,
                    "lane": s.lane,
                }
                for s in self.slos
            ],
            "lanes": ls.summary() if ls is not None else {},
            "device": self._timeline_fn() if self._timeline_fn else None,
            "peers": self._peer_section(),
            "commits": commits,
        }

    def _peer_section(self) -> dict | None:
        if self._peers_fn is None:
            return None
        peers = self._peers_fn()
        if peers:
            _M_PEER_VIEWS.inc()
        return peers


# ---------------------------------------------------------------------------
# Fleet merges: many nodes' lane summaries into one record (a dashboard
# polling several nodes; the reference's `fleet_rollup` builds on them).
#
# Cross-node percentile merge rule (documented because it is an
# approximation, not magic): true percentiles are not mergeable from
# per-node summaries, and per-node planes deliberately ship summaries,
# not sample rings (a 100-node cell would otherwise carry ~100x65k
# floats). Each node-lane summary (count, p50, p99, max) is therefore
# re-expanded into three weighted points — 50% of the count at p50, 49%
# at p99, the remainder at max — and the fleet percentile is the
# weighted nearest-rank over the pooled points. Exactness properties:
# the merged max is EXACT (max of maxes); the merged p99 is bounded
# above by the worst node's max and below by the best node's p50; and
# when every node saw the same distribution the merge reproduces that
# distribution's summary. Rollups additionally carry the worst NODE per
# lane, which needs no merge at all and is usually the number a
# regression hunt starts from.


def weighted_percentile(points: list[tuple[float, float]], q: float) -> float:
    """Nearest-rank percentile over (value, weight) points: the smallest
    value whose cumulative weight reaches q of the total. Degenerates to
    metrics.percentile when every weight is 1."""
    if not points:
        return 0.0
    total = sum(w for _v, w in points if w > 0)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for v, w in sorted(points):
        if w <= 0:
            continue
        cum += w
        if cum >= target - 1e-12:
            return v
    return sorted(points)[-1][0]


def merge_lane_summaries(per_node: dict[str, dict]) -> dict[str, dict]:
    """{node: {lane: {count, p50_ms, p99_ms[, max_ms]}}} -> one merged
    summary per lane across the fleet (see the merge rule above), plus
    the worst node by p99 — {lane: {count, p50_ms, p99_ms, max_ms,
    worst_node, worst_node_p99_ms}}."""
    pooled: dict[str, list[tuple[float, float]]] = {}
    counts: dict[str, int] = {}
    worst: dict[str, tuple[float, str]] = {}  # lane -> (p99, node)
    for node, lanes in sorted(per_node.items()):
        for lane, s in (lanes or {}).items():
            count = int(s.get("count", 0))
            if count <= 0:
                continue
            p50 = float(s.get("p50_ms", 0.0))
            p99 = float(s.get("p99_ms", p50))
            mx = float(s.get("max_ms", p99))
            # Fractional weights on purpose: integer rounding would skew
            # the max share above 1% for small counts, dragging the
            # merged p99 of IDENTICAL per-node distributions up to max —
            # the fixed-point property the unit test pins.
            w50 = 0.50 * count
            w99 = 0.49 * count
            wmax = 0.01 * count
            pooled.setdefault(lane, []).extend(
                [(p50, w50), (p99, w99), (mx, wmax)]
            )
            counts[lane] = counts.get(lane, 0) + count
            if lane not in worst or p99 > worst[lane][0]:
                worst[lane] = (p99, str(node))
    out = {}
    for lane, points in pooled.items():
        out[lane] = {
            "count": counts[lane],
            "p50_ms": round(weighted_percentile(points, 0.50), 3),
            "p99_ms": round(weighted_percentile(points, 0.99), 3),
            "max_ms": round(max(v for v, w in points if w > 0), 3),
            "worst_node": worst[lane][1],
            "worst_node_p99_ms": round(worst[lane][0], 3),
        }
    return out


# ---------------------------------------------------------------------------
# Per-peer observatory views (the `peers` section of a telemetry dump,
# fed by network/net.py's PeerLink ledger through `peers_fn`).


@dataclass(frozen=True)
class PeerView:
    """One directed link's normalized observatory row — the shape the
    dashboard renders and a future region-aware LeaderElector consumes."""

    peer: str
    rtt_ewma_ms: float | None
    rtt_p50_ms: float | None
    frames_sent: int
    bytes_sent: int
    backoff_drops: int
    probes_sent: int
    pongs_received: int

    @staticmethod
    def from_snapshot(peer: str, snap: dict) -> "PeerView":
        return PeerView(
            peer=str(peer),
            rtt_ewma_ms=snap.get("rtt_ewma_ms"),
            rtt_p50_ms=snap.get("rtt_p50_ms"),
            frames_sent=int(snap.get("frames_sent") or 0),
            bytes_sent=int(snap.get("bytes_sent") or 0),
            backoff_drops=int(snap.get("backoff_drops") or 0),
            probes_sent=int(snap.get("probes_sent") or 0),
            pongs_received=int(snap.get("pongs_received") or 0),
        )


def peer_views(peers: dict[str, dict] | None) -> list[PeerView]:
    """A dump's `peers` section as sorted PeerView rows."""
    return [
        PeerView.from_snapshot(peer, snap or {})
        for peer, snap in sorted((peers or {}).items())
    ]


# Fleet region inference: two nodes share a region iff a measured RTT
# EWMA between them sits under this bound. The chaos WanMatrix separates
# intra-region (4 ms) from the closest inter-region RTT (62 ms) by more
# than a decade, so 30 ms recovers the seeded geometry exactly while
# tolerating per-frame jitter folded into the EWMAs.
REGION_RTT_THRESHOLD_MS = 30.0


def infer_fleet_regions(
    latency_ms: dict[str, dict[str, float]],
    threshold_ms: float = REGION_RTT_THRESHOLD_MS,
) -> dict[str, str]:
    """Partition nodes into RTT-derived regions: union-find over every
    measured link whose EWMA is under `threshold_ms` (either direction
    suffices — links are directed but latency is symmetric enough).
    Labels are synthetic (`rtt-0`, `rtt-1`, ... ordered by each group's
    smallest member), so callers compare PARTITIONS against ground
    truth, not label strings. Pure and deterministic."""
    nodes = sorted(
        set(latency_ms) | {b for m in latency_ms.values() for b in m}
    )
    parent = {n: n for n in nodes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a in sorted(latency_ms):
        for b, rtt in sorted((latency_ms.get(a) or {}).items()):
            if rtt is not None and rtt <= threshold_ms:
                ra, rb = find(a), find(b)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
    groups: dict[str, list[str]] = {}
    for n in nodes:
        groups.setdefault(find(n), []).append(n)
    labels = {
        root: f"rtt-{k}"
        for k, root in enumerate(
            sorted(groups, key=lambda r: min(groups[r]))
        )
    }
    return {n: labels[find(n)] for n in nodes}


# ---------------------------------------------------------------------------
# Scrape endpoint: framed JSON request/response on the stack's 4-byte
# length framing (network/net.py), one response per request frame.


def peer_latency_map(peers: dict[str, dict]) -> dict[str, dict[str, float]]:
    """{node: {peer: link snapshot}} -> {node: {peer: RTT EWMA ms}},
    keeping only links with at least one closed probe loop."""
    out: dict[str, dict[str, float]] = {}
    for a, links in sorted((peers or {}).items()):
        row = {
            str(b): float(s["rtt_ewma_ms"])
            for b, s in sorted((links or {}).items())
            if isinstance(s, dict) and s.get("rtt_ewma_ms") is not None
        }
        if row:
            out[str(a)] = row
    return out


class TelemetryServer:
    """Serves scrape requests for one plane — or for a STATIC dump dict
    (e.g. a node's telemetry section replayed out of a chaos report,
    which is how the dashboard's live-vs-offline equivalence is tested:
    the same dict serves both paths verbatim)."""

    def __init__(self, address: tuple[str, int], source) -> None:
        self._address = address
        self.source = source
        self._server: asyncio.AbstractServer | None = None

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.sockets[0].getsockname()[1]

    async def start(self) -> int:
        """Bind and start serving; returns the bound port (0 in the
        requested address picks a free one — tests rely on this)."""
        self._server = await asyncio.start_server(
            self._handle, host=self._address[0], port=self._address[1]
        )
        log.info("telemetry scrape endpoint on %s:%d", self._address[0], self.port)
        return self.port

    def launch(self):
        """Spawn the accept loop as an actor task (node run / bench)."""
        from .actors import spawn

        return spawn(self._serve(), name="telemetry-server")

    async def _serve(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    def _payload(self, last: int | None) -> dict:
        if isinstance(self.source, dict):
            return self.source
        return self.source.dump(last=last)

    async def _handle(self, reader, writer) -> None:
        from ..network.net import FrameReader, frame

        frames = FrameReader(reader)
        try:
            while True:
                data = await frames.next_frame()
                if data is None:
                    break
                try:
                    req = json.loads(data)
                    cmd = req.get("cmd")
                except Exception:
                    req, cmd = {}, None
                if cmd == "scrape":
                    _M_SCRAPES.inc()
                    last = req.get("last")
                    if last is None or (
                        isinstance(last, int)
                        and not isinstance(last, bool)
                        and last >= 0
                    ):
                        resp = self._payload(last)
                    else:
                        resp = {"error": "last must be a non-negative integer"}
                else:
                    resp = {"error": f"unknown cmd {cmd!r} (try 'scrape')"}
                body = json.dumps(resp, sort_keys=True).encode()
                writer.write(frame(body))
                await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


async def scrape(
    address: tuple[str, int], last: int | None = None, timeout: float = 5.0
) -> dict:
    """One scrape round-trip against a TelemetryServer."""
    from ..network.net import FrameReader, frame

    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(address[0], address[1]), timeout
    )
    try:
        req: dict = {"cmd": "scrape"}
        if last is not None:
            req["last"] = last
        writer.write(frame(json.dumps(req).encode()))
        await writer.drain()
        data = await asyncio.wait_for(FrameReader(reader).next_frame(), timeout)
        if data is None:
            raise ConnectionError("telemetry endpoint closed mid-scrape")
        return json.loads(data)
    finally:
        try:
            writer.close()
        except Exception:
            pass


def scrape_sync(
    address: tuple[str, int], last: int | None = None, timeout: float = 5.0
) -> dict:
    return asyncio.run(scrape(address, last=last, timeout=timeout))


def serve_in_thread(
    source,
    port: int = 0,
    host: str = "127.0.0.1",
    snapshot_interval_s: float | None = None,
    stop: threading.Event | None = None,
) -> int:
    """Run a TelemetryServer on a daemon thread with its own event loop
    (the seam for synchronous hosts like the bench). Optionally ticks the
    plane's snapshot loop at `snapshot_interval_s`. Returns the bound
    port; the thread dies with the process, or, when `stop` is given,
    once it is set (the endpoint closes and the snapshot loop ends)."""
    started = threading.Event()
    box: dict = {}

    def _thread() -> None:
        async def main() -> None:
            server = TelemetryServer((host, port), source)
            box["port"] = await server.start()
            started.set()
            if snapshot_interval_s and isinstance(source, TelemetryPlane):
                source.config.interval_s = snapshot_interval_s
                # actors.spawn (not bare ensure_future): keeps a strong
                # reference, and its done-callback ERROR-logs a crashed
                # snapshot loop — the ring must not silently freeze while
                # scrapes keep serving stale data.
                from .actors import spawn

                spawn(source.run(), name="telemetry-snapshots")
            async with server._server:
                if stop is None:
                    await server._server.serve_forever()
                while not stop.is_set():
                    await asyncio.sleep(0.05)

        try:
            asyncio.run(main())
        except Exception as e:  # pragma: no cover - diagnostics only
            box["error"] = e
            started.set()

    threading.Thread(target=_thread, name="telemetry-server", daemon=True).start()
    if not started.wait(10) or "port" not in box:
        raise RuntimeError(f"telemetry server failed to start: {box.get('error')}")
    return box["port"]
