"""Run-level incident plane: fault→alert→recovery attribution (§5.5r).

The chaos plane can inject faults (plan crash windows, partitions, lossy
links, floods, boundary crashes, epoch switches) and the fleet can fire
alerts (the telemetry plane's two-window SLO burn evaluator, the
AnomalyWatchdog's stall/backpressure/handoff reasons) — this module is
the ledger that connects the two, on the run's virtual clock, after the
fact and from report data alone:

  * **Fault windows** — `(kind, start, end, nodes)` intervals extracted
    from the orchestrator's report: crash/restart event pairs, plan
    partitions, lossy links (drop/duplicate/reorder > 0 — pure
    delay/jitter is geometry, not a fault), late boots, epoch switches,
    plus the injected-load windows (flood, ingress spike) the
    orchestrator passes explicitly because their parameters never land
    in the report. `end=None` means the fault was never healed.
  * **Alert spans** — `(class, name, node, fired, cleared)` from every
    node's telemetry `alerts` stream (SLO fire/clear pairs; a fire with
    no clear is a RESIDUAL span) and the process-global watchdog
    triggers (instantaneous spans; `slo_burn` triggers are skipped —
    they mirror the plane's own fired alert through `note_slo_burn`).
  * **Attribution** — interval overlap: an alert attributes to a fault
    window iff it FIRED inside `[start, end + grace]` (grace =
    `ATTRIBUTION_GRACE_S`: burn windows and backlog drain legitimately
    trail the fault) on a node the window covers. When several windows
    match, the latest-starting one wins — the innermost fault of a
    nested pair is the proximate cause. Alerts no window explains land
    in an explicit **unattributed** class: those are findings, not
    noise, and scenarios pin `unattributed == 0`.

Every fault window becomes one **incident** row — including alert-less
ones (the undetected class). Per incident: `mttd_s` (first attributed
fire − window start), `mttr_s` (last attributed clear − window start;
None while any attributed span is residual), and a `residual` flag.
Fleet MTTD/MTTR percentiles per fault class merge the per-node samples
through `telemetry.merge_lane_summaries` (fault classes as lanes), so
the rollup carries the same worst-node attribution as every other
fleet percentile. The **burn budget** sums seconds-in-violation per
SLO row (span seconds, unclosed spans run to end-of-run) against a
scenario-declared per-row budget; the `health` verdict block —
embedded in every chaos report and `fleet_rollup` — is green iff
`unattributed == 0` and every declared budget row is within budget.

Determinism contract: the ledger is a pure function of report data
(virtual-clock timestamps, already rounded to 6 dp at the source),
every collection is sorted before use, and nothing here reads the wall
clock — a same-seed rerun yields a bit-identical ledger, which
tests/test_incidents.py pins.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from . import metrics
from .telemetry import merge_lane_summaries

log = logging.getLogger("hotstuff.incidents")

__all__ = [
    "ATTRIBUTION_GRACE_S",
    "WATCHDOG_ALERT_CLASSES",
    "FaultWindow",
    "AlertSpan",
    "fault_windows_from_report",
    "alert_spans_from_report",
    "build_ledger",
    "report_ledger",
    "record_metrics",
    "log_ledger",
]

# An alert may legitimately trail the fault that explains it (burn
# evaluation windows, backlog drain): a fire within this many virtual
# seconds after a window closes still attributes to it. One constant for
# every scenario — per-scenario grace would make MTTD/MTTR figures
# non-comparable across matrix revisions.
ATTRIBUTION_GRACE_S = 5.0

# Every AnomalyWatchdog reason string resolves to a ledger alert class
# (the graftlint `incidents` pass enforces completeness against the
# `_trigger(...)` call sites in utils/tracing.py — an unmapped reason
# would silently fall out of attribution).
WATCHDOG_ALERT_CLASSES: dict[str, str] = {
    "round_stall": "stall",
    "backpressure": "backpressure",
    "slo_burn": "slo_burn",
    "handoff_violation": "handoff",
    "verify_regression": "verify",
}

_M_OPENED = metrics.counter("incident.opened")
_M_ATTRIBUTED = metrics.counter("incident.attributed")
_M_UNATTRIBUTED = metrics.counter("incident.unattributed")
_M_MTTD = metrics.histogram("incident.mttd_s")
_M_MTTR = metrics.histogram("incident.mttr_s")
_M_BURN = metrics.histogram("incident.budget_burn_s")


@dataclass(frozen=True)
class FaultWindow:
    """One injected disruption on the virtual clock. `end=None` = never
    healed (open at run end); `nodes=None` = fleet-wide."""

    kind: str
    start: float
    end: float | None = None
    nodes: tuple[int, ...] | None = None


@dataclass(frozen=True)
class AlertSpan:
    """One alert lifetime. `cleared=None` = residual (never cleared);
    `node=None` = process-global (the shared watchdog)."""

    alert_class: str
    name: str
    node: int | None
    fired: float
    cleared: float | None = None


def _link_is_faulty(link: dict) -> bool:
    # drop/duplicate/reorder mutate traffic; delay/jitter shape it —
    # healthy scenarios run 10-150 ms links, which must not become a
    # run-long window that attributes every alert by construction.
    return any(
        float(link.get(k) or 0.0) > 0.0
        for k in ("drop", "duplicate", "reorder")
    )


def fault_windows_from_report(
    report: dict, extra: tuple[FaultWindow, ...] = ()
) -> list[FaultWindow]:
    """Extract every injected fault window from a chaos report: the plan
    (partitions, lossy links), the event stream (crash/restart pairs at
    their EXECUTED times — covers boundary crashes too — plus late
    boots and epoch switches), and any `extra` windows the orchestrator
    knows about that the report does not parameterize (flood/ingress
    spans)."""
    windows: list[FaultWindow] = list(extra)
    run_end = float(report.get("virtual_seconds") or 0.0)
    plan = report.get("plan") or {}
    if _link_is_faulty(plan.get("default_link") or {}):
        windows.append(FaultWindow("link_fault", 0.0, run_end, None))
    lossy_pair_nodes: set[int] = set()
    for key, link in sorted((plan.get("links") or {}).items()):
        if _link_is_faulty(link or {}):
            src, _, dst = key.partition("->")
            lossy_pair_nodes.update((int(src), int(dst)))
    if lossy_pair_nodes:
        windows.append(
            FaultWindow(
                "link_fault", 0.0, run_end, tuple(sorted(lossy_pair_nodes))
            )
        )
    for p in plan.get("partitions") or ():
        nodes = tuple(sorted({n for g in p["groups"] for n in g}))
        windows.append(
            FaultWindow(
                "partition", float(p["start"]), float(p["end"]), nodes or None
            )
        )
    open_crash: dict[int, float] = {}
    epoch_ts: dict[int, list[float]] = {}
    for ev in report.get("events") or ():
        kind, t = ev.get("event"), float(ev.get("t") or 0.0)
        node = ev.get("node")
        if kind == "crash" and node not in open_crash:
            open_crash[node] = t
        elif kind == "restart" and node in open_crash:
            windows.append(
                FaultWindow("crash", open_crash.pop(node), t, (node,))
            )
        elif kind == "boot":
            # A late boot's disruption is the ABSENCE before it: the
            # window runs from genesis to the boot instant.
            windows.append(FaultWindow("late_boot", 0.0, t, (node,)))
        elif kind == "epoch_switch":
            epoch_ts.setdefault(int(ev["epoch"]), []).append(t)
    for node, t in sorted(open_crash.items()):
        windows.append(FaultWindow("crash", t, None, (node,)))
    for _epoch, ts in sorted(epoch_ts.items()):
        # The switch lands per node; the fleet-wide window spans first
        # to last observation (handoff alerts attribute here).
        windows.append(FaultWindow("epoch_switch", min(ts), max(ts), None))
    return sorted(windows, key=_window_sort_key)


def _window_sort_key(w: FaultWindow):
    return (
        w.start,
        w.end is None,
        w.end if w.end is not None else 0.0,
        w.kind,
        w.nodes if w.nodes is not None else (),
    )


def alert_spans_from_report(report: dict) -> list[AlertSpan]:
    """Fold every node's telemetry alert stream (fire/clear pairs, FIFO
    per SLO) plus the watchdog trigger list into sorted AlertSpans."""
    spans: list[AlertSpan] = []
    for label, dump in sorted(
        (report.get("telemetry") or {}).items(), key=lambda kv: str(kv[0])
    ):
        node = int(label)
        open_fires: dict[str, list[float]] = {}
        for a in dump.get("alerts") or ():
            slo = str(a.get("slo"))
            if a.get("event") == "fired":
                open_fires.setdefault(slo, []).append(float(a["t"]))
            elif a.get("event") == "cleared" and open_fires.get(slo):
                fired = open_fires[slo].pop(0)
                spans.append(
                    AlertSpan("slo_burn", slo, node, fired, float(a["t"]))
                )
        for slo, fires in sorted(open_fires.items()):
            spans.extend(
                AlertSpan("slo_burn", slo, node, fired, None)
                for fired in fires
            )
    for trig in report.get("watchdog_triggers") or ():
        reason = str(trig.get("reason"))
        if reason == "slo_burn":
            # The watchdog's slo_burn trigger is the telemetry plane's
            # own fired alert relayed through note_slo_burn — counting
            # both would double every burn in the ledger.
            continue
        cls = WATCHDOG_ALERT_CLASSES.get(reason, reason)
        t = float(trig.get("t") or 0.0)
        spans.append(AlertSpan(cls, reason, None, t, t))
    return sorted(
        spans,
        key=lambda s: (
            s.fired,
            s.alert_class,
            s.name,
            -1 if s.node is None else s.node,
        ),
    )


def _pct_summary(vals: list[float]) -> dict:
    return {
        "count": len(vals),
        "p50_ms": round(metrics.percentile(vals, 0.50), 3),
        "p99_ms": round(metrics.percentile(vals, 0.99), 3),
        "max_ms": round(max(vals), 3),
    }


def _fleet_percentiles(samples: dict[str, dict[str, list[float]]]) -> dict:
    """{node_label: {fault_class: [ms samples]}} -> fleet percentiles per
    fault class via merge_lane_summaries (fault classes as lanes), so
    MTTD/MTTR roll up exactly like every other fleet latency figure —
    worst-node attribution included."""
    per_node = {
        node: {kind: _pct_summary(vals) for kind, vals in by_kind.items()}
        for node, by_kind in sorted(samples.items())
    }
    return merge_lane_summaries(per_node)


def build_ledger(
    windows: list[FaultWindow],
    alerts: list[AlertSpan],
    *,
    run_end: float,
    budget: dict[str, float] | None = None,
    grace: float = ATTRIBUTION_GRACE_S,
) -> dict:
    """Attribute every alert span to a fault window (or the unattributed
    class) and materialize the ledger: incident rows, fleet MTTD/MTTR
    percentiles per fault class, the per-SLO burn budget, and the
    `health` verdict block."""
    windows = sorted(windows, key=_window_sort_key)
    attributed: list[list[AlertSpan]] = [[] for _ in windows]
    unattributed: list[AlertSpan] = []
    for a in sorted(
        alerts,
        key=lambda s: (
            s.fired,
            s.alert_class,
            s.name,
            -1 if s.node is None else s.node,
        ),
    ):
        best: int | None = None
        for idx, w in enumerate(windows):
            end = w.end if w.end is not None else run_end
            if not (w.start <= a.fired <= end + grace):
                continue  # alert-before-fault is NEVER explained by it
            if (
                w.nodes is not None
                and a.node is not None
                and a.node not in w.nodes
            ):
                continue
            # Windows are start-sorted: keeping the last match selects
            # the latest-starting cover — the innermost of nested faults.
            best = idx
        if best is None:
            unattributed.append(a)
        else:
            attributed[best].append(a)

    rows: list[dict] = []
    mttd_samples: dict[str, dict[str, list[float]]] = {}
    mttr_samples: dict[str, dict[str, list[float]]] = {}
    for w, spans in zip(windows, attributed):
        first_fired = min((a.fired for a in spans), default=None)
        residual = any(a.cleared is None for a in spans)
        clears = [a.cleared for a in spans if a.cleared is not None]
        mttd = (
            round(first_fired - w.start, 6)
            if first_fired is not None
            else None
        )
        mttr = (
            round(max(clears) - w.start, 6)
            if spans and not residual
            else None
        )
        classes: dict[str, int] = {}
        for a in spans:
            classes[a.alert_class] = classes.get(a.alert_class, 0) + 1
        rows.append(
            {
                "kind": w.kind,
                "start": round(w.start, 6),
                "end": round(w.end, 6) if w.end is not None else None,
                "nodes": list(w.nodes) if w.nodes is not None else None,
                "alerts": len(spans),
                "alert_classes": dict(sorted(classes.items())),
                "mttd_s": mttd,
                "mttr_s": mttr,
                "residual": residual,
            }
        )
        # Per-node samples: detection = the node's FIRST attributed fire,
        # recovery = its LAST clear (skipped while it holds a residual
        # span) — merged fleet-wide below with fault classes as lanes.
        by_node: dict[str, list[AlertSpan]] = {}
        for a in spans:
            label = "watchdog" if a.node is None else str(a.node)
            by_node.setdefault(label, []).append(a)
        for label, node_spans in sorted(by_node.items()):
            d_ms = (min(s.fired for s in node_spans) - w.start) * 1000.0
            mttd_samples.setdefault(label, {}).setdefault(w.kind, []).append(
                d_ms
            )
            if all(s.cleared is not None for s in node_spans):
                r_ms = (
                    max(s.cleared for s in node_spans) - w.start
                ) * 1000.0
                mttr_samples.setdefault(label, {}).setdefault(
                    w.kind, []
                ).append(r_ms)

    burn_s: dict[str, float] = {}
    for a in sorted(alerts, key=lambda s: (s.name, s.fired)):
        if a.alert_class != "slo_burn":
            continue
        t1 = a.cleared if a.cleared is not None else run_end
        burn_s[a.name] = burn_s.get(a.name, 0.0) + max(0.0, t1 - a.fired)
    burn: dict[str, dict] = {}
    over_budget = 0
    for slo in sorted(set(burn_s) | set(budget or {})):
        declared = None if budget is None else budget.get(slo)
        burned = round(burn_s.get(slo, 0.0), 6)
        within = None if declared is None else burned <= declared
        if within is False:
            over_budget += 1
        burn[slo] = {
            "burn_s": burned,
            "budget_s": declared,
            "within_budget": within,
        }

    health = {
        "incidents": len(rows),
        "detected": sum(1 for r in rows if r["alerts"]),
        "alerts_attributed": sum(r["alerts"] for r in rows),
        "alerts_unattributed": len(unattributed),
        "residual": sum(1 for r in rows if r["residual"]),
        "mttd": _fleet_percentiles(mttd_samples),
        "mttr": _fleet_percentiles(mttr_samples),
        "burn": burn,
        "burn_budget_ok": over_budget == 0,
        "ok": not unattributed and over_budget == 0,
    }
    return {
        "v": 1,
        "grace_s": grace,
        "incidents": rows,
        "unattributed": [
            {
                "class": a.alert_class,
                "name": a.name,
                "node": a.node,
                "fired": round(a.fired, 6),
                "cleared": (
                    round(a.cleared, 6) if a.cleared is not None else None
                ),
            }
            for a in unattributed
        ],
        "health": health,
    }


def report_ledger(
    report: dict,
    extra_windows: tuple[FaultWindow, ...] = (),
    budget: dict[str, float] | None = None,
) -> dict:
    """The one-call form the orchestrator (and offline tools replaying a
    report) use: extract windows + spans from the report and build."""
    return build_ledger(
        fault_windows_from_report(report, extra_windows),
        alert_spans_from_report(report),
        run_end=float(report.get("virtual_seconds") or 0.0),
        budget=budget,
    )


def worst_mttr_ms(ledger: dict) -> float:
    """Largest incident recovery time in ms (0.0 when nothing cleared)."""
    return round(
        max(
            (
                r["mttr_s"]
                for r in ledger.get("incidents", ())
                if r.get("mttr_s") is not None
            ),
            default=0.0,
        )
        * 1000.0,
        3,
    )


def record_metrics(ledger: dict) -> None:
    """Land the ledger in the `incident.*` namespace rows (the scenario
    delta surface — run_scenario folds these into `report['metrics']`)."""
    health = ledger["health"]
    _M_OPENED.inc(health["incidents"])
    _M_ATTRIBUTED.inc(health["alerts_attributed"])
    _M_UNATTRIBUTED.inc(health["alerts_unattributed"])
    for row in ledger["incidents"]:
        if row["mttd_s"] is not None:
            _M_MTTD.record(row["mttd_s"])
        if row["mttr_s"] is not None:
            _M_MTTR.record(row["mttr_s"])
    for b in health["burn"].values():
        _M_BURN.record(b["burn_s"])


def log_ledger(ledger: dict) -> None:
    """Emit the scrapeable surface (benchmark/logs.py's `+ INCIDENTS:`
    section greps these exact shapes): one line per incident, the
    one-line ledger summary, per-row burn-budget lines for declared
    rows, and the burn verdict."""
    health = ledger["health"]
    for row in ledger["incidents"]:
        log.info(
            "Incident %s: window %.3f-%ss nodes %s, %d alert(s), "
            "MTTD %s, MTTR %s%s",
            row["kind"],
            row["start"],
            "open" if row["end"] is None else f"{row['end']:.3f}",
            "fleet" if row["nodes"] is None else row["nodes"],
            row["alerts"],
            "-" if row["mttd_s"] is None else f"{row['mttd_s'] * 1e3:.1f} ms",
            "-" if row["mttr_s"] is None else f"{row['mttr_s'] * 1e3:.1f} ms",
            " RESIDUAL" if row["residual"] else "",
        )
    log.info(
        "Incident ledger: %d incident(s), %d alert(s) attributed, "
        "%d unattributed, %d residual, worst MTTR %.1f ms",
        health["incidents"],
        health["alerts_attributed"],
        health["alerts_unattributed"],
        health["residual"],
        worst_mttr_ms(ledger),
    )
    over = 0
    for slo, b in sorted(health["burn"].items()):
        if b["budget_s"] is None:
            continue
        if b["within_budget"] is False:
            over += 1
        log.info(
            "Burn budget %s: %.3f s burned of %.3f s budget (%s)",
            slo,
            b["burn_s"],
            b["budget_s"],
            "within" if b["within_budget"] else "OVER",
        )
    log.info(
        "Burn budget verdict: %s (%d SLO row(s) over budget)",
        "ok" if health["burn_budget_ok"] else "violated",
        over,
    )
