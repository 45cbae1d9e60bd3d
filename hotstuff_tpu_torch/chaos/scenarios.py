"""Named chaos scenarios: the library `python -m
hotstuff_tpu_torch.chaos_run --scenario` selects from. Each scenario is a declarative recipe — node count, fault
plan, Byzantine policies, run bounds, heal point, and extra expectations
evaluated against the finished report — executed by `run_scenario()` on a
VirtualTimeLoop for deterministic replay.

Link delays are deliberately nonzero everywhere: on the virtual clock a
zero-latency network would let rounds complete in zero virtual time and a
bounded-duration scenario would run unbounded rounds. 10-20 ms links keep
round costs realistic AND bound the work per virtual second.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..consensus.config import Parameters
from ..crypto.scheduler import SchedulerConfig
from ..ingress.admission import IngressConfig, LaneSpec
from ..ingress.loadgen import ArrivalCurve, IngressLoad
from ..utils import metrics
from ..utils.telemetry import (
    TelemetryConfig,
    infer_fleet_regions,
    peer_latency_map,
)
from . import vtime
from .byzantine import (
    BundlePoisoner,
    Equivocator,
    SigForger,
    StaleReplayer,
    VoteWithholder,
)
from .orchestrator import (
    BoundaryCrash,
    BulkFlood,
    ChaosOrchestrator,
    ReconfigDirective,
)
from .plan import (
    CrashWindow,
    DelayedBoot,
    FaultPlan,
    LinkFaults,
    Partition,
    WanMatrix,
)

# Bounds on one scenario run. VIRTUAL_TIMEOUT_S catches a stop condition
# that never fires (virtual time races ahead forever); WALL_TIMEOUT_S is a
# real-clock watchdog for the opposite failure — a frozen virtual clock
# (livelock), which no virtual deadline can interrupt.
VIRTUAL_TIMEOUT_S = 600.0
WALL_TIMEOUT_S = 300.0

_LINK = LinkFaults(delay=0.01)  # healthy-but-realistic 10 ms links


def _params(timeout_ms: int = 1_000) -> Parameters:
    return Parameters(
        timeout_delay=timeout_ms,
        sync_retry_delay=1_000,
        timeout_backoff=2.0,
        max_timeout_delay=8_000,
    )


@dataclass
class Scenario:
    name: str
    description: str
    n: int = 4
    plan: Callable[[], FaultPlan] = FaultPlan
    # Size-parameterized plan factory (receives the EFFECTIVE committee
    # size, after any matrix `n` override): the way a grid scenario
    # expresses faults that must scale with n — e.g. the timeout_storm's
    # half|half no-quorum partition — without pinning node indices.
    # Takes precedence over `plan` when set.
    plan_n: Callable[[int], FaultPlan] | None = None
    byzantine: dict[int, object] = field(default_factory=dict)
    parameters: Callable[[], Parameters] = _params
    duration: float = 30.0  # virtual seconds (upper bound)
    min_commits: int = 4  # per-honest-node early-stop / liveness floor
    heal_t: float | None = None  # liveness must show progress past this
    expect: Callable[[dict, dict], list[str]] | None = None  # (report, metric deltas)
    slow: bool = False  # excluded from the tier-1 short sweep
    # Open-loop client traffic (ingress/loadgen.IngressLoad factory): the
    # orchestrator attaches one in-process ingress pipeline + generator
    # per target node, riding each node's real verification service.
    ingress: Callable[[], IngressLoad] | None = None
    # Open-loop bulk-verification flood (orchestrator.BulkFlood factory)
    # and per-node scheduler knobs (crypto/scheduler.SchedulerConfig
    # factory, e.g. the virtual device-occupancy pace that makes bulk
    # queueing observable under the virtual clock).
    flood: Callable[[], BulkFlood] | None = None
    scheduler: Callable[[], SchedulerConfig] | None = None
    # Live telemetry plane (utils/telemetry.TelemetryConfig factory): one
    # per-node snapshot ring + SLO burn evaluator on the virtual clock,
    # embedded in the report's `telemetry` section.
    telemetry: Callable[[], TelemetryConfig] | None = None
    # Genesis committee as node indices (None = every node): nodes outside
    # it run the full stack as JOIN candidates, admitted only by a
    # committed EpochChange (consensus/reconfig.py).
    committee: tuple[int, ...] | None = None
    # Size-parameterized genesis committee (receives the EFFECTIVE node
    # count, after any matrix `n` override) — the committee-free form a
    # grid reconfig scenario must use: membership derives from n instead
    # of pinning indices, so cells can scale it. Takes precedence over
    # `committee` when set.
    committee_n: Callable[[int], tuple[int, ...]] | None = None
    # Epoch-reconfiguration directives (orchestrator.ReconfigDirective
    # factory): a signed committee change injected mid-run, or a LIST of
    # chained directives (rolling churn — each waits for the previous
    # boundary to be committed-past before building).
    reconfig: Callable[[], "ReconfigDirective | list[ReconfigDirective]"] | None = None
    # Size-parameterized directive factory (receives the effective n) —
    # the committee-free form grid reconfig cells use; precedence over
    # `reconfig` when set.
    reconfig_n: Callable[[int], "list[ReconfigDirective]"] | None = None
    # Quorum-crash-at-the-boundary machinery (orchestrator.BoundaryCrash
    # factory list): crash nodes the instant an epoch switch lands.
    boundary_crashes: Callable[[], list[BoundaryCrash]] | None = None
    # Matrix-cell virtual-second budget override: None = the grid's
    # MATRIX_CELL_DURATION_S cap (which bounds a REGRESSED cell's wall
    # cost). Only a scenario whose CONTRACT structurally needs longer —
    # rolling_churn's three progress-gated boundaries — declares one;
    # everything else stays capped so cells remain comparable across
    # matrix revisions.
    cell_duration: float | None = None
    # Scenario REQUIRES the trusted-crypto stub at every size (not just
    # from TRUSTED_CRYPTO_MIN_N up): the aggregate-certificate cells,
    # whose exact-BLS pairing (~0.4 s per verification) is unrunnable in
    # a virtual-time fleet at ANY committee size. Read the trust model
    # in chaos/trusted_crypto.py before setting this.
    trusted_crypto: bool = False
    # Per-scenario matrix-size override (None = the grid's MATRIX_SIZES):
    # how the aggregate cells extend the grid to n=128 — the committee
    # size the constant-size-certificate claim is about — without
    # tripling every legacy scenario's cell count.
    matrix_sizes: tuple[int, ...] | None = None
    # Commit-proof serving plane (§5.5q): boot a ProofRegistry +
    # ProofService per node, feed admitted ingress tx digests into that
    # node's proposals, and attach one subscribe-until-commit proof
    # client per ACCEPTED transaction — outcomes land in the report's
    # `proofs` section (requires `ingress`).
    proofs: bool = False
    # Byzantine nonce-squatting driver: never-admitted MODE_SUBSCRIBE
    # queries/s per target node (0 = off); outcomes in `proof_squat`.
    proof_squat_rate: float = 0.0
    # Scenario-declared per-SLO burn budget (seconds-in-violation the run
    # may spend per SLO row, utils/incidents.py §5.5r): judged in the
    # report's `health` block; rows not named here are reported unjudged.
    burn_budget: Callable[[], dict[str, float]] | None = None


def _expect_counter(deltas: dict, name: str, minimum: int = 1) -> list[str]:
    if deltas.get(name, 0) < minimum:
        return [f"expected {name} >= {minimum}, saw {deltas.get(name, 0)}"]
    return []


def _expect_forgery(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "chaos.forged_votes")
    problems += _expect_counter(deltas, "verifier.rejected_sigs")
    if report.get("forged_triples_cached", 0) != 0:
        problems.append(
            f"{report['forged_triples_cached']} forged triples found in a "
            "VerifiedSigCache (rejected signatures must never be cached)"
        )
    return problems


SCENARIOS: dict[str, Scenario] = {}


def _register(s: Scenario) -> Scenario:
    SCENARIOS[s.name] = s
    return s


_register(
    Scenario(
        name="baseline",
        description="No faults: 4 honest nodes on healthy 10 ms links must "
        "commit one common chain (the chaos plane's own sanity check).",
        plan=lambda: FaultPlan(default_link=_LINK),
        # The scenario-registry lint requires every scenario to assert
        # something beyond not-crashing: the baseline pins real traffic
        # and the per-node commit floor (4 nodes x min_commits).
        expect=lambda report, deltas: _expect_counter(deltas, "chaos.frames")
        + _expect_counter(deltas, "consensus.commits", minimum=16),
    )
)

_register(
    Scenario(
        name="lossy_links",
        description="Every directed link drops 8%, duplicates 3%, reorders "
        "8%, and jitters up to 20 ms; sync retries must keep the chain "
        "growing with no safety damage.",
        plan=lambda: FaultPlan(
            default_link=LinkFaults(
                drop=0.08, duplicate=0.03, reorder=0.08, delay=0.01, jitter=0.02
            )
        ),
        duration=60.0,
        min_commits=8,
        expect=lambda report, deltas: _expect_counter(deltas, "chaos.drops")
        + _expect_counter(deltas, "chaos.duplicates")
        + _expect_counter(deltas, "chaos.reorders"),
    )
)

_register(
    Scenario(
        name="partition_heal",
        description="A 2|2 partition (no quorum on either side) from t=1 to "
        "t=4, then heal: commits must stop during the partition and resume "
        "after — the liveness checker gates on post-heal progress.",
        plan=lambda: FaultPlan(
            default_link=_LINK,
            partitions=[Partition(start=1.0, end=4.0, groups=((0, 1), (2, 3)))],
        ),
        duration=40.0,
        min_commits=2,
        heal_t=4.0,
        expect=lambda report, deltas: _expect_counter(
            deltas, "chaos.partition_drops"
        ),
    )
)

_register(
    Scenario(
        name="leader_crash",
        description="Node 1 crashes at t=1 and restarts at t=4 against its "
        "persisted store: progress continues through its leader rounds via "
        "TCs, and the restarted node may not double-vote (safety state "
        "reload).",
        plan=lambda: FaultPlan(
            default_link=_LINK,
            crashes=[CrashWindow(node=1, at=1.0, restart=4.0)],
        ),
        duration=40.0,
        min_commits=3,
        heal_t=4.0,
        expect=lambda report, deltas: _expect_counter(deltas, "chaos.crashes")
        + _expect_counter(deltas, "chaos.restarts"),
    )
)

_register(
    Scenario(
        name="equivocating_leader",
        description="Node 1 sends conflicting, correctly signed proposals to "
        "different peers whenever it leads: neither twin may gather a "
        "quorum, so its rounds fall to the pacemaker and safety holds.",
        plan=lambda: FaultPlan(default_link=_LINK),
        byzantine={1: Equivocator},
        duration=60.0,
        min_commits=3,
        expect=lambda report, deltas: _expect_counter(
            deltas, "chaos.equivocations"
        ),
    )
)

_register(
    Scenario(
        name="forged_signatures",
        description="Node 1 floods votes/timeouts carrying garbage "
        "signatures under both its own and honest authorities: the "
        "verifier must reject every one (nonzero rejections, zero false "
        "accepts in committed QCs, zero dedup-cache entries for forged "
        "triples).",
        plan=lambda: FaultPlan(default_link=_LINK),
        byzantine={1: SigForger},
        duration=60.0,
        min_commits=3,
        expect=_expect_forgery,
    )
)

def _expect_stale_replay(report: dict, deltas: dict) -> list[str]:
    """Gate the replay-counter expectation on a replay actually having
    been injected: the StaleReplayer needs to SEE at least two
    blocks/TCs before it has stale material, and at some seeds the run
    early-stops (min_commits reached) first — previously an EXPECT
    failure with nothing wrong (the stale_qc_replay@seed2 flake). A full-
    duration run with zero replays is still a failure: the adversary had
    the whole window and injected nothing, so the scenario tested
    nothing."""
    replays = deltas.get("chaos.stale_replays", 0)
    early_stop = report["virtual_seconds"] < report["duration_requested"]
    if replays == 0 and early_stop:
        return []
    return _expect_counter(deltas, "chaos.stale_replays")


_register(
    Scenario(
        name="stale_qc_replay",
        description="Node 1 re-broadcasts old proposals and TCs on every new "
        "round: honest replicas must discard stale rounds without state "
        "damage or re-commits.",
        plan=lambda: FaultPlan(default_link=_LINK),
        byzantine={1: StaleReplayer},
        duration=60.0,
        # 5 (not 3): long enough that the replayer has stale material
        # before the early-stop at almost any seed; the expectation above
        # stays gated for the residue.
        min_commits=5,
        expect=_expect_stale_replay,
    )
)

_register(
    Scenario(
        name="vote_withholding",
        description="Node 1 withholds every vote and timeout: the remaining "
        "2f+1 honest replicas keep committing, at pacemaker pace through "
        "the silent node's leader rounds.",
        plan=lambda: FaultPlan(default_link=_LINK),
        byzantine={1: VoteWithholder},
        duration=60.0,
        min_commits=3,
        expect=lambda report, deltas: _expect_counter(
            deltas, "chaos.withheld_votes"
        ),
    )
)

# Flash-crowd ingress: deliberately small lanes + a paced drain (40 tx/s
# capacity per node) so a 60 tx/s spike demonstrably overloads admission
# under the virtual clock, where Python work costs zero virtual time and
# an unpaced drain could never saturate.
_FLASH_SPIKE = (5.0, 7.0)  # virtual-second spike window (see expectations)


def _flash_ingress_config() -> IngressConfig:
    return IngressConfig(
        lanes=(
            LaneSpec("priority", min_fee=1_000, capacity=8),
            LaneSpec("standard", min_fee=1, capacity=16),
            LaneSpec("bulk", min_fee=0, capacity=16),
        ),
        verify_batch=4,
        verify_interval=0.1,
    )


def _commit_rate(report: dict, t0: float, t1: float) -> float:
    """Aggregate honest commits/sec inside [t0, t1) from commit_times."""
    n = sum(
        1
        for times in report.get("commit_times", {}).values()
        for t in times
        if t0 <= t < t1
    )
    return n / max(t1 - t0, 1e-9)


def _expect_flash_crowd(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "ingress.shed")
    problems += _expect_counter(deltas, "ingress.verified_sigs", minimum=20)
    totals = {"offered": 0, "accepted": 0, "shed": 0, "retry_hints": 0}
    for summary in report.get("ingress", {}).values():
        for k in totals:
            totals[k] += summary.get(k, 0)
    if totals["shed"] and totals["retry_hints"] != totals["shed"]:
        problems.append(
            f"{totals['shed']} sheds but only {totals['retry_hints']} carried "
            "a retry-after hint (backpressure contract: every shed names a "
            "retry window)"
        )
    if not totals["accepted"]:
        problems.append("no client transaction was accepted end-to-end")
    # Commit throughput must hold its pre-overload plateau through the
    # spike: overload lands on the ingress lanes (shed with backpressure),
    # never on consensus. 0.75 here is the any-seed structural guard;
    # tests/test_chaos.py pins the 10%-band acceptance figure at seed 11.
    t0, t1 = _FLASH_SPIKE
    pre = _commit_rate(report, 2.0, t0)
    spike = _commit_rate(report, t0, t1)
    if pre <= 0:
        problems.append("no commits in the pre-overload window")
    elif spike < 0.75 * pre:
        problems.append(
            f"committed throughput collapsed under the flash crowd: "
            f"{spike:.2f}/s in the spike vs {pre:.2f}/s before"
        )
    return problems


_register(
    Scenario(
        name="flash_crowd_ingress",
        description="An open-loop flash crowd (4 -> 60 tx/s per node) hits "
        "every node's authenticated ingress while consensus runs: admission "
        "sheds with retry-after backpressure, ingress signatures ride each "
        "node's real BatchVerificationService, and committed throughput "
        "holds its pre-overload plateau.",
        # 150 ms links: rounds stay realistic-paced, which bounds the
        # PYTHON work 11 virtual seconds cost (every commit is ~a dozen
        # pure-python signature ops — wall time, not virtual time).
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.15)),
        duration=11.0,
        min_commits=0,  # no early stop: the spike window must play out
        ingress=lambda: IngressLoad(
            curve=ArrivalCurve(
                kind="flash",
                rate=4,
                peak=60,
                t_start=_FLASH_SPIKE[0],
                t_end=_FLASH_SPIKE[1],
            ),
            duration=10.0,
            clients=3,
            tx_bytes=32,
            config=_flash_ingress_config,
        ),
        expect=_expect_flash_crowd,
    )
)

# Bulk-flood priority: the continuous-batching scheduler's acceptance
# scenario. A mempool-class verification flood OVERLOADS the
# bulk pipeline (pace: 2 ms of virtual device time per signature; 40
# groups/s/node of 16 sigs offers ~128% device utilization, so the bulk
# backlog grows without bound for the whole window) while consensus runs
# its QC/TC checks through the SAME per-node scheduler. The critical
# lane must preempt: its p99 queueing delay stays bounded at
# milliseconds while bulk's grows to virtual SECONDS (bulk waits — the
# lane contract), and commits continue through the flood window.
_FLOOD_PACE_S_PER_SIG = 0.002
_FLOOD_GROUP_SIZE = 16
_FLOOD_WINDOW = (1.0, 7.0)  # virtual-second flood span
# One initial bulk bucket occupies group_size * pace = 32 ms of virtual
# device time (coalesced backlog buckets occupy far more); preemption is
# proven if critical p99 stays well under even the smallest bucket.
_CRITICAL_P99_BOUND_MS = 10.0


def _expect_bulk_flood(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "scheduler.critical_dispatches")
    problems += _expect_counter(deltas, "scheduler.buckets")
    flood_verified = sum(
        s.get("verified", 0) for s in report.get("flood", {}).values()
    )
    if flood_verified < 100:
        problems.append(
            f"bulk flood barely ran: {flood_verified} signatures verified"
        )
    bulk_queued = False
    for label, s in sorted(report.get("scheduler", {}).items()):
        qd = s.get("queue_delay", {})
        crit, bulk = qd.get("consensus"), qd.get("mempool")
        if not crit or crit["count"] < 3:
            problems.append(
                f"node {label}: too little critical-lane traffic to judge "
                f"({0 if not crit else crit['count']} groups)"
            )
            continue
        if crit["p99_ms"] > _CRITICAL_P99_BOUND_MS:
            problems.append(
                f"node {label}: critical-lane p99 queueing "
                f"{crit['p99_ms']:.1f} ms exceeds {_CRITICAL_P99_BOUND_MS} ms "
                "(commit-critical work queued behind the bulk flood)"
            )
        if bulk and bulk["p99_ms"] > _CRITICAL_P99_BOUND_MS:
            bulk_queued = True
    if not bulk_queued:
        problems.append(
            "the flood produced no bulk-lane queueing anywhere — the "
            "scenario did not actually contend the device (pace/rate too "
            "low?), so the critical-lane bound proves nothing"
        )
    # Commits must not stall: a floor overall AND progress INSIDE the
    # overload window on every node (the flood spans almost the whole
    # run, so a stalled scheduler would show up here, not in min_commits).
    t0, t1 = _FLOOD_WINDOW
    for label, times in sorted(report.get("commit_times", {}).items()):
        if len(times) < 3:
            problems.append(f"node {label}: only {len(times)} commits")
        elif not any(t0 + 2.0 <= t < t1 for t in times):
            problems.append(
                f"node {label}: no commit inside the flood window "
                f"[{t0 + 2.0}, {t1}) — consensus stalled behind bulk"
            )
    return problems


_register(
    Scenario(
        name="bulk_flood_priority",
        description="A mempool bulk-verification flood overloads every "
        "node's device scheduler (virtual occupancy pacing, ~128% "
        "utilization) while consensus runs: the preemptive critical lane "
        "keeps QC/TC verification p99 queueing bounded at milliseconds "
        "while bulk's backlog grows to seconds, and commits continue "
        "through the whole flood window.",
        # 150 ms links: realistic round pacing bounds the pure-python
        # signature work per virtual second (flash_crowd rationale).
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.15)),
        duration=8.0,
        min_commits=0,  # no early stop: the flood window must play out
        flood=lambda: BulkFlood(
            rate=40.0,
            group_size=_FLOOD_GROUP_SIZE,
            duration=_FLOOD_WINDOW[1] - _FLOOD_WINDOW[0],
            t_start=_FLOOD_WINDOW[0],
            pool=8,
        ),
        scheduler=lambda: SchedulerConfig(
            pace_s_per_sig=_FLOOD_PACE_S_PER_SIG
        ),
        expect=_expect_bulk_flood,
    )
)

# SLO-burn telemetry: the live-telemetry plane's acceptance scenario
# A mempool bulk flood overdrives the virtual device-occupancy
# model (pace 2.2 ms/sig x 40 groups/s x 16 sigs ~= 141% utilization), so
# bulk queueing delay climbs past the mempool lane's published 500 ms SLO
# during the flood window; the per-node telemetry planes (0.5 s snapshot
# interval, 1 s short / 3 s long burn windows) must FIRE the lane.mempool
# burn alert while the fault is active and CLEAR it after the flood stops
# and the backlog drains — with the critical lane never burning (the
# scheduler lane contract, now judged by the evaluator instead of an
# advisory string).
_SLO_FLOOD_WINDOW = (1.0, 4.0)
_SLO_PACE_S_PER_SIG = 0.0022


def _slo_telemetry_config() -> TelemetryConfig:
    return TelemetryConfig(
        interval_s=0.5,
        short_window=2,
        long_window=6,
        burn_factor=2.0,
    )


def _expect_slo_burn(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "telemetry.snapshots")
    problems += _expect_counter(deltas, "telemetry.slo_burn_fired")
    problems += _expect_counter(deltas, "telemetry.slo_burn_cleared")
    t0, t1 = _SLO_FLOOD_WINDOW
    if not any(
        t["reason"] == "slo_burn" for t in report.get("watchdog_triggers", ())
    ):
        problems.append(
            "no slo_burn watchdog trigger (the alert never reached the "
            "auto-dump path)"
        )
    telem = report.get("telemetry", {})
    if not telem:
        problems.append("report carries no telemetry section")
    for label, node in sorted(telem.items()):
        fired = [
            a
            for a in node.get("alerts", ())
            if a["slo"] == "lane.mempool" and a["event"] == "fired"
        ]
        cleared = [
            a
            for a in node.get("alerts", ())
            if a["slo"] == "lane.mempool" and a["event"] == "cleared"
        ]
        if not fired:
            problems.append(
                f"node {label}: mempool-lane SLO burn never fired under a "
                "flood that exceeds the lane's 500 ms objective"
            )
            continue
        if not (t0 <= fired[0]["t"] <= t1 + 1.0):
            problems.append(
                f"node {label}: burn fired at t={fired[0]['t']}, outside "
                f"the injected fault window [{t0}, {t1}]"
            )
        if not cleared:
            problems.append(
                f"node {label}: burn alert never cleared after the flood "
                "stopped (heal not observed)"
            )
        elif cleared[0]["t"] <= t1:
            problems.append(
                f"node {label}: burn cleared at t={cleared[0]['t']}, "
                "before the fault even ended"
            )
        if node.get("active_alerts"):
            problems.append(
                f"node {label}: alerts still active at run end: "
                f"{node['active_alerts']}"
            )
        # the critical lane must never burn — preemption holds its SLO
        if any(a["slo"] == "lane.consensus" for a in node.get("alerts", ())):
            problems.append(
                f"node {label}: the consensus lane burned its SLO under a "
                "mempool flood (preemption failed)"
            )
    return problems


_register(
    Scenario(
        name="slo_burn_bulk",
        description="A mempool bulk flood (~141% virtual device "
        "utilization) drives bulk queueing past its 500 ms SLO while "
        "per-node telemetry planes snapshot on the virtual clock: the "
        "mempool-lane burn-rate alert fires during the flood, the "
        "consensus lane never burns, and the alert clears after the "
        "backlog drains — the scrapeable alert surface end to end.",
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.15)),
        duration=8.0,
        min_commits=0,  # no early stop: fire AND clear must both play out
        flood=lambda: BulkFlood(
            rate=40.0,
            group_size=16,
            duration=_SLO_FLOOD_WINDOW[1] - _SLO_FLOOD_WINDOW[0],
            t_start=_SLO_FLOOD_WINDOW[0],
            pool=8,
        ),
        scheduler=lambda: SchedulerConfig(pace_s_per_sig=_SLO_PACE_S_PER_SIG),
        telemetry=_slo_telemetry_config,
        expect=_expect_slo_burn,
    )
)

# ---------------------------------------------------------------------------
# Incident-ledger scenarios (§5.5r): the fault→alert→recovery
# attribution plane's own acceptance runs. incident_smoke is the tier-1
# regression pin (tests/test_incidents.py replays it twice and requires a
# bit-identical ledger); operations_day is the slow-tier game day:
# rolling restarts across an epoch boundary under
# sustained ingress, judged by the health verdict instead of counters.

_SMOKE_FLOOD_WINDOW = (1.0, 4.0)  # slo_burn_bulk's proven burn recipe
_SMOKE_CRASH = (6.8, 7.8)  # after the burn clears (~t=6), before run end


def _smoke_ingress_config() -> IngressConfig:
    # Default (deep) lanes + a mild drain pacer: light traffic admits
    # cleanly — the smoke's ingress is background load, not the fault.
    return IngressConfig(verify_batch=4, verify_interval=0.1)


def _expect_incident_smoke(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "chaos.crashes")
    problems += _expect_counter(deltas, "chaos.restarts")
    problems += _expect_counter(deltas, "telemetry.slo_burn_fired")
    problems += _expect_counter(deltas, "incident.opened", minimum=3)
    problems += _expect_counter(deltas, "incident.attributed")
    ledger = report.get("incidents") or {}
    health = report.get("health") or {}
    kinds = {r["kind"] for r in ledger.get("incidents", ())}
    for want in ("flood", "crash", "link_fault"):
        if want not in kinds:
            problems.append(
                f"no {want} incident in the ledger (saw {sorted(kinds)})"
            )
    if health.get("alerts_attributed", 0) < 1:
        problems.append("no alert attributed to any injected fault")
    if health.get("alerts_unattributed", 0):
        problems.append(
            f"{health['alerts_unattributed']} unattributed alert(s): "
            f"{ledger.get('unattributed')}"
        )
    if health.get("residual", 0):
        problems.append("alert span(s) still open at run end (residual)")
    if health.get("burn_budget_ok") is not True:
        problems.append(f"burn budget violated: {health.get('burn')}")
    if not health.get("ok"):
        problems.append("health verdict is not green")
    flood_rows = [
        r for r in ledger.get("incidents", ()) if r["kind"] == "flood"
    ]
    if flood_rows and (
        flood_rows[0]["mttd_s"] is None or flood_rows[0]["mttr_s"] is None
    ):
        problems.append("flood incident carries no MTTD/MTTR")
    return problems


_register(
    Scenario(
        name="incident_smoke",
        description="Leader crash + a lossy link under light ingress while "
        "a short mempool flood drives one SLO burn fire/clear cycle: the "
        "incident ledger must attribute every alert to an injected fault "
        "window (unattributed == 0), carry MTTD/MTTR for the flood, stay "
        "within the declared burn budget, and replay bit-identically at "
        "the same seed — the incident plane's tier-1 regression pin.",
        plan=lambda: FaultPlan(
            # 150 ms links bound the pure-python wall cost per virtual
            # second (flash_crowd rationale); the 2<->3 pair additionally
            # drops 5% — a node-scoped link_fault window in the ledger.
            default_link=LinkFaults(delay=0.15),
            links={
                (2, 3): LinkFaults(delay=0.15, drop=0.05),
                (3, 2): LinkFaults(delay=0.15, drop=0.05),
            },
            crashes=[
                CrashWindow(
                    node=1, at=_SMOKE_CRASH[0], restart=_SMOKE_CRASH[1]
                )
            ],
        ),
        duration=10.0,
        min_commits=0,  # no early stop: fire, clear, crash must all play
        heal_t=_SMOKE_CRASH[1],
        ingress=lambda: IngressLoad(
            curve=ArrivalCurve(kind="sustained", rate=3.0),
            duration=9.0,
            clients=1,
            tx_bytes=32,
            config=_smoke_ingress_config,
        ),
        flood=lambda: BulkFlood(
            rate=40.0,
            group_size=16,
            duration=_SMOKE_FLOOD_WINDOW[1] - _SMOKE_FLOOD_WINDOW[0],
            t_start=_SMOKE_FLOOD_WINDOW[0],
            pool=8,
        ),
        scheduler=lambda: SchedulerConfig(pace_s_per_sig=_SLO_PACE_S_PER_SIG),
        telemetry=_slo_telemetry_config,
        burn_budget=lambda: {"lane.mempool": 30.0},
        expect=_expect_incident_smoke,
    )
)

# Operations day (scoped to the virtual plane):
# every node rolling-restarts once, one at a time, across a committed
# epoch boundary, under sustained ingress plus a mid-day mempool surge —
# pass/fail is the incident plane's verdict (burn budget respected,
# unattributed == 0, MTTD/MTTR ceilings), not a pile of counters. Runs
# on the trusted-crypto stub: membership/timing is at stake, not forgery.
_OPS_CRASH_START = 3.0
_OPS_CRASH_SPACING = 2.0
_OPS_CRASH_DOWN = 1.2
_OPS_SURGE_WINDOW = (8.0, 10.5)  # the mid-day mempool surge (burn source)
_OPS_MTTD_CEILING_MS = 6_000.0
_OPS_MTTR_CEILING_MS = 15_000.0


def _ops_committee(n: int) -> tuple[int, ...]:
    """Genesis committee with two join candidates held back: n-2 members
    keeps quorum with any single member down (the rolling-restart
    invariant) and leaves candidates for the boundary rotation."""
    return tuple(range(max(3, n - 2)))


def _ops_plan(n: int) -> FaultPlan:
    return FaultPlan(
        default_link=LinkFaults(delay=0.1),
        crashes=[
            CrashWindow(
                node=i,
                at=_OPS_CRASH_START + _OPS_CRASH_SPACING * i,
                restart=_OPS_CRASH_START + _OPS_CRASH_SPACING * i
                + _OPS_CRASH_DOWN,
            )
            for i in range(n)
        ],
    )


def _ops_directives(n: int) -> list[ReconfigDirective]:
    return [ReconfigDirective(at=2.0, rotate=2, activation_margin=_CHURN_MARGIN)]


def _expect_operations_day(report: dict, deltas: dict) -> list[str]:
    n = report["nodes"]
    problems = _expect_no_handoff_violation(deltas)
    problems += _expect_counter(deltas, "reconfig.epoch_switches")
    problems += _expect_counter(deltas, "chaos.crashes", minimum=n)
    problems += _expect_counter(deltas, "chaos.restarts", minimum=n)
    # Rotated-out genesis members legitimately stop committing at the
    # boundary, so the generic heal_t progress gate can't apply fleet-wide
    # — instead every FINAL-committee member must commit after the LAST
    # rolling restart: the day ends with the whole committee working.
    last_restart = max(
        (e["t"] for e in report["events"] if e["event"] == "restart"),
        default=0.0,
    )
    disagreements, memberships = _switch_memberships(report)
    problems += disagreements
    if memberships:
        _act, final_members = memberships[max(memberships)]
        for i in sorted(final_members):
            times = report.get("commit_times", {}).get(str(i), [])
            if not any(t > last_restart for t in times):
                problems.append(
                    f"final-committee node {i} never committed after the "
                    f"last rolling restart at t={last_restart}"
                )
    else:
        problems.append("no epoch-switch memberships recorded")
    problems += _expect_counter(deltas, "telemetry.slo_burn_fired")
    problems += _expect_counter(deltas, "incident.opened", minimum=n + 1)
    totals = {"offered": 0, "accepted": 0}
    for summary in report.get("ingress", {}).values():
        for k in totals:
            totals[k] += summary.get(k, 0)
    if not totals["accepted"]:
        problems.append("sustained ingress admitted nothing all day")
    ledger = report.get("incidents") or {}
    health = report.get("health") or {}
    kinds = [r["kind"] for r in ledger.get("incidents", ())]
    if kinds.count("crash") < n:
        problems.append(
            f"expected {n} crash incidents (one rolling restart per "
            f"node), saw {kinds.count('crash')}"
        )
    if "epoch_switch" not in kinds:
        problems.append("no epoch_switch incident — the boundary never ran")
    # The game-day verdict: every alert explained, burn inside budget,
    # nothing left burning, detection/recovery inside the ceilings.
    if health.get("alerts_attributed", 0) < 3:
        problems.append(
            f"only {health.get('alerts_attributed', 0)} alert(s) "
            "attributed — the surge never exercised the alert plane"
        )
    if health.get("alerts_unattributed", 0):
        problems.append(
            f"{health['alerts_unattributed']} unattributed alert(s): "
            f"{ledger.get('unattributed')}"
        )
    if health.get("residual", 0):
        problems.append("alert span(s) still open at run end (residual)")
    if health.get("burn_budget_ok") is not True:
        problems.append(f"burn budget violated: {health.get('burn')}")
    for kind, s in sorted((health.get("mttd") or {}).items()):
        if s["p99_ms"] > _OPS_MTTD_CEILING_MS:
            problems.append(
                f"{kind} detection p99 {s['p99_ms']:.0f} ms exceeds the "
                f"{_OPS_MTTD_CEILING_MS:.0f} ms ceiling"
            )
    for kind, s in sorted((health.get("mttr") or {}).items()):
        if s["p99_ms"] > _OPS_MTTR_CEILING_MS:
            problems.append(
                f"{kind} recovery p99 {s['p99_ms']:.0f} ms exceeds the "
                f"{_OPS_MTTR_CEILING_MS:.0f} ms ceiling"
            )
    if not health.get("ok"):
        problems.append("health verdict is not green")
    return problems


_register(
    Scenario(
        name="operations_day",
        description="A production game day on the virtual clock: all "
        "seven nodes rolling-restart one at a time across a committed "
        "epoch boundary (two members rotate at the boundary) under "
        "sustained client ingress, with a mid-day mempool surge driving "
        "the SLO burn plane — pass/fail is the incident ledger's health "
        "verdict: every alert attributed to an injected fault, the "
        "declared burn budget respected, no residual alerts, and "
        "MTTD/MTTR p99 inside the ceilings.",
        n=7,
        committee_n=_ops_committee,
        plan_n=_ops_plan,
        reconfig_n=_ops_directives,
        duration=22.0,
        min_commits=0,  # no early stop: the whole day must play out
        # No heal_t: nodes rotated out at the boundary stop committing by
        # design; the expectation pins final-committee progress instead.
        slow=True,
        trusted_crypto=True,
        ingress=lambda: IngressLoad(
            curve=ArrivalCurve(kind="sustained", rate=4.0),
            duration=20.0,
            clients=2,
            tx_bytes=32,
        ),
        flood=lambda: BulkFlood(
            rate=40.0,
            group_size=16,
            duration=_OPS_SURGE_WINDOW[1] - _OPS_SURGE_WINDOW[0],
            t_start=_OPS_SURGE_WINDOW[0],
            pool=8,
        ),
        scheduler=lambda: SchedulerConfig(pace_s_per_sig=_SLO_PACE_S_PER_SIG),
        telemetry=_slo_telemetry_config,
        burn_budget=lambda: {
            "lane.mempool": 60.0,
            "lane.consensus": 2.0,
        },
        expect=_expect_operations_day,
    )
)


def _expect_flood_cell(report: dict, deltas: dict) -> list[str]:
    """flash_crowd's contract, size-parameterized for the matrix grid:
    shed>0 with a retry hint on every shed, the commit plateau held
    through the spike, no node starved outright, and the ledger carries
    the spike window with zero unattributed alerts."""
    problems = _expect_flash_crowd(report, deltas)
    starved = [
        int(i)
        for i, rounds in sorted(
            report.get("commits", {}).items(), key=lambda kv: int(kv[0])
        )
        if not rounds
    ]
    if starved:
        problems.append(f"nodes with zero commits under the flood: {starved}")
    ledger = report.get("incidents") or {}
    health = report.get("health") or {}
    if "ingress_spike" not in {
        r["kind"] for r in ledger.get("incidents", ())
    }:
        problems.append("no ingress_spike incident in the ledger")
    if health.get("alerts_unattributed", 0):
        problems.append(
            f"{health['alerts_unattributed']} unattributed alert(s) in a "
            f"flood cell: {ledger.get('unattributed')}"
        )
    return problems


_register(
    Scenario(
        name="flood",
        description="flash_crowd_ingress, grid-shaped (ROADMAP item 3's "
        "flood-cell residue): the identical open-loop 4 -> 60 tx/s flash "
        "crowd per node, with the expectations size-parameterized — shed "
        "with retry hints, plateau held, no starved node at any committee "
        "size — and the spike window pinned in the incident ledger. Slow "
        "tier standalone (the tier-1 copy of this machinery is "
        "flash_crowd_ingress); its home is the matrix grid.",
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.15)),
        duration=11.0,
        # The spike machinery ends at t=10; running a cell to the 30 s
        # grid cap would soak 19 empty virtual seconds per cell.
        cell_duration=11.0,
        min_commits=0,  # no early stop: the spike window must play out
        slow=True,
        ingress=lambda: IngressLoad(
            curve=ArrivalCurve(
                kind="flash",
                rate=4,
                peak=60,
                t_start=_FLASH_SPIKE[0],
                t_end=_FLASH_SPIKE[1],
            ),
            duration=10.0,
            clients=3,
            tx_bytes=32,
            config=_flash_ingress_config,
        ),
        expect=_expect_flood_cell,
    )
)

_register(
    Scenario(
        name="saturation_lossy",
        description="Long lossy-link soak (15% drop, heavy jitter, 7 nodes, "
        "f=2 margin) — the extended-tier variant of lossy_links.",
        n=7,
        plan=lambda: FaultPlan(
            default_link=LinkFaults(
                drop=0.15, duplicate=0.05, reorder=0.10, delay=0.01, jitter=0.04
            )
        ),
        duration=240.0,
        min_commits=5,
        slow=True,
        expect=lambda report, deltas: _expect_counter(deltas, "chaos.drops")
        + _expect_counter(deltas, "consensus.sync_requests"),
    )
)

# ---------------------------------------------------------------------------
# Reconfiguration + catch-up scenarios . All three
# use 150 ms links: realistic round pacing bounds the pure-python signature
# work per virtual second (flash_crowd rationale), and a catch-up node's
# chain replay is the dominant wall cost.

_CATCHUP_LINK = LinkFaults(delay=0.15)

# The acceptance bound: a catch-up node must end within this many committed
# rounds of the live tip (commits lag the tip uniformly across nodes, so
# committed-round lag measures tip lag without racing in-flight messages).
MAX_TIP_LAG_ROUNDS = 4


def _max_commit_round(report: dict, node: int) -> int:
    return max(
        (r for r, _d in report["commits"].get(str(node), [])), default=0
    )


def _tip_round(report: dict) -> int:
    return max(
        (
            r
            for commits in report["commits"].values()
            for r, _d in commits
        ),
        default=0,
    )


def _expect_catchup(report: dict, deltas: dict, node: int) -> list[str]:
    """Shared catch-up assertions: the node range-synced (not one digest
    at a time) and ended within MAX_TIP_LAG_ROUNDS of the live tip."""
    problems = _expect_counter(deltas, "sync.range_requests")
    problems += _expect_counter(deltas, "sync.range_replies")
    # Rounds outnumber blocks: the absent node's leader rounds fall to
    # TCs, so a "9 rounds behind" gap may be only ~4 blocks of ancestry.
    problems += _expect_counter(deltas, "sync.range_blocks", minimum=3)
    if not report["commits"].get(str(node)):
        problems.append(f"catch-up node {node} never committed")
        return problems
    tip = _tip_round(report)
    mine = _max_commit_round(report, node)
    if tip - mine > MAX_TIP_LAG_ROUNDS:
        problems.append(
            f"catch-up node {node} ended {tip - mine} rounds behind the "
            f"tip (round {mine} vs {tip}; bound {MAX_TIP_LAG_ROUNDS})"
        )
    return problems


def _expect_epoch_reconfig(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "reconfig.epoch_switches", minimum=4)
    problems += _expect_counter(deltas, "reconfig.proposed")
    switches = report.get("epoch_switches", {})
    if not switches:
        return problems + ["no node recorded an epoch switch"]
    acts = {e["activation_round"] for evs in switches.values() for e in evs}
    epochs_seen = {e["epoch"] for evs in switches.values() for e in evs}
    if len(acts) != 1:
        problems.append(f"nodes disagree on the activation round: {sorted(acts)}")
        return problems
    if epochs_seen != {2}:
        problems.append(f"expected exactly epoch 2, saw {sorted(epochs_seen)}")
    act = next(iter(acts))
    # The original quorum members (0-2) must have switched...
    for i in (0, 1, 2):
        if str(i) not in switches:
            problems.append(f"node {i} never applied the epoch switch")
    # ...and committed on BOTH sides of the boundary: the safety checker
    # verified those QCs against epoch 1 and epoch 2 committees
    # respectively (run_scenario already folds its violations into ok).
    for i in (0, 1, 2):
        rounds = [r for r, _d in report["commits"].get(str(i), [])]
        if not any(r < act for r in rounds):
            problems.append(f"node {i} has no pre-boundary commit")
        if not any(r > act for r in rounds):
            problems.append(f"node {i} has no post-boundary commit")
    # The JOINED validator caught up from genesis (range sync) and
    # commits past the boundary...
    problems += _expect_catchup(report, deltas, node=4)
    if _max_commit_round(report, 4) <= act:
        problems.append(
            "joined node 4 never committed past the activation boundary"
        )
    # ...while the DEPARTED one stops at it (the new committee neither
    # serves it blocks nor counts its votes; +2 covers in-flight frames).
    left_max = _max_commit_round(report, 3)
    if left_max > act + 2:
        problems.append(
            f"departed node 3 kept committing past the boundary "
            f"(round {left_max} > activation {act})"
        )
    problems += _expect_counter(deltas, "chaos.invariant_checks")
    return problems


def _expect_genesis_catchup(report: dict, deltas: dict) -> list[str]:
    problems = _expect_catchup(report, deltas, node=3)
    boots = [e for e in report["events"] if e["event"] == "boot"]
    if [e["node"] for e in boots] != [3]:
        problems.append(f"expected one late boot of node 3, saw {boots}")
    return problems


def _expect_long_offline(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "chaos.crashes")
    problems += _expect_counter(deltas, "chaos.restarts")
    problems += _expect_catchup(report, deltas, node=2)
    return problems


_register(
    Scenario(
        name="epoch_reconfig",
        description="Validator join+leave at a committed epoch boundary "
        "under load: a signed EpochChange rides the chain (epoch-commit "
        "rule), nodes 0-3 hand the committee to {0,1,2,4} at the "
        "activation round, the joining node 4 range-syncs from genesis "
        "and commits past the boundary, the departing node 3 stops at "
        "it, and every committed QC re-verifies against the committee of "
        "its own epoch on both sides.",
        n=5,
        committee=(0, 1, 2, 3),
        plan=lambda: FaultPlan(default_link=_CATCHUP_LINK),
        reconfig=lambda: ReconfigDirective(
            at=2.0, add=(4,), remove=(3,), activation_margin=10
        ),
        duration=12.0,
        min_commits=0,  # no early stop: the boundary must play out
        expect=_expect_epoch_reconfig,
    )
)

_register(
    Scenario(
        name="genesis_catchup",
        description="A committee validator boots for the first time at "
        "t=6 with an EMPTY store while the chain runs: batched range "
        "sync fetches and fully re-verifies the ancestor chain from "
        "genesis, and the node ends within 4 committed rounds of the "
        "live tip.",
        plan=lambda: FaultPlan(
            default_link=_CATCHUP_LINK,
            boots=[DelayedBoot(node=3, at=6.0)],
        ),
        duration=11.0,
        min_commits=0,  # no early stop: the catch-up window must play out
        expect=_expect_genesis_catchup,
    )
)

_register(
    Scenario(
        name="long_offline_catchup",
        description="Node 2 crashes at t=1 and stays down for most of the "
        "run; on restart against its persisted store it is dozens of "
        "rounds behind and must range-sync to the tip (per-digest sync "
        "would crawl at one block per retry), ending within 4 committed "
        "rounds of the live tip with the double-vote guard intact.",
        plan=lambda: FaultPlan(
            default_link=_CATCHUP_LINK,
            crashes=[CrashWindow(node=2, at=1.0, restart=9.0)],
        ),
        duration=12.0,
        min_commits=0,  # no early stop: the offline window must play out
        heal_t=9.0,
        expect=_expect_long_offline,
    )
)

# ---------------------------------------------------------------------------
# Aggregation-overlay scenarios : the region-aware
# vote/timeout aggregation tree (consensus/overlay.py), its failure modes, and
# the timeout_storm matrix cells that pin the O(n²) -> O(n·fanout) win.

# The storm window: a half|half partition leaves NO quorum on either side,
# so every round inside it stalls to the pacemaker on every node — the
# deterministic, committee-size-invariant timeout storm (the organic
# version was the 64-node lossy@seed2 multi-round stall, CHAOS_MATRIX_r01).
_STORM_WINDOW = (1.0, 5.0)

# Overlay bound on timeout-plane frames per LOCAL TIMEOUT event: one
# upward bundle + at most `agg_fanout` gossip-fallback frames + the
# bounded merged re-forwards, amortized over the fleet's timeout events.
# O(fanout), committee-size-free — the legacy all-to-all plane pays
# exactly n-1 per event (frames-per-stalled-round = n times these).
AGG_STORM_FRAMES_PER_TIMEOUT = 10.0


def _agg_params(timeout_ms: int = 1_000) -> Parameters:
    return Parameters(
        timeout_delay=timeout_ms,
        sync_retry_delay=1_000,
        timeout_backoff=2.0,
        max_timeout_delay=8_000,
        aggregation_overlay=True,
        agg_fanout=4,
        agg_hold_ms=40,
        # Below the 1 s pacemaker: a genuinely stalled round (dead
        # aggregator, partition) always reaches the gossip fallback
        # before the next local timeout re-arms it.
        agg_fallback_ms=400,
    )


def _storm_plan(n: int) -> FaultPlan:
    half = max(1, n // 2)
    return FaultPlan(
        default_link=LinkFaults(drop=0.03, delay=0.02, jitter=0.01),
        partitions=[
            Partition(
                start=_STORM_WINDOW[0],
                end=_STORM_WINDOW[1],
                groups=(tuple(range(half)), tuple(range(half, n))),
            )
        ],
        # Regions always present: the tree's region-aware placement (and
        # the wan.cross_region_frames accounting) is part of what the
        # storm cells pin.
        wan=WanMatrix(),
    )


def _storm_metrics(deltas: dict) -> tuple[int, int]:
    return (
        deltas.get("consensus.timeouts", 0),
        deltas.get("agg.timeout_frames", 0),
    )


def _expect_timeout_storm(report: dict, deltas: dict) -> list[str]:
    n = report["nodes"]
    problems = _expect_counter(deltas, "chaos.partition_drops")
    timeouts, frames = _storm_metrics(deltas)
    if timeouts < n:
        problems.append(
            f"storm never fired: {timeouts} local timeouts across {n} nodes"
        )
        return problems
    fpt = frames / timeouts
    if fpt > AGG_STORM_FRAMES_PER_TIMEOUT:
        problems.append(
            f"timeout-plane frames per local timeout {fpt:.1f} exceeds the "
            f"overlay bound {AGG_STORM_FRAMES_PER_TIMEOUT} — the O(n) "
            "per-event storm is back"
        )
    problems += _expect_counter(deltas, "agg.bundles_sent")
    # No quorum exists inside the window, so every armed fallback fires:
    # the crashed-aggregator degradation path is structurally exercised.
    problems += _expect_counter(deltas, "agg.fallbacks")
    return problems


def _expect_timeout_storm_legacy(report: dict, deltas: dict) -> list[str]:
    n = report["nodes"]
    problems = _expect_counter(deltas, "chaos.partition_drops")
    timeouts, frames = _storm_metrics(deltas)
    if timeouts < n:
        problems.append(
            f"storm never fired: {timeouts} local timeouts across {n} nodes"
        )
        return problems
    fpt = frames / timeouts
    if fpt < 0.8 * (n - 1):
        problems.append(
            f"legacy baseline frames per timeout {fpt:.1f} is below "
            f"0.8*(n-1)={0.8 * (n - 1):.1f} — the committed baseline is "
            "not measuring the all-to-all storm"
        )
    if deltas.get("agg.bundles_sent", 0):
        problems.append("overlay bundles observed in the legacy cell")
    return problems


_register(
    Scenario(
        name="timeout_storm",
        description="Half|half no-quorum partition stalls every round in "
        "[1,5) on every node — the deterministic O(n²) timeout storm — "
        "with the aggregation overlay ON: timeouts merge up the "
        "region-aware tree as partial bundles (one frame per node per "
        "event plus bounded gossip fallback), frames-per-timeout stays "
        "O(fanout) regardless of committee size, and the fleet heals "
        "cleanly after the window.",
        plan_n=_storm_plan,
        parameters=_agg_params,
        duration=30.0,
        min_commits=4,
        heal_t=_STORM_WINDOW[1],
        expect=_expect_timeout_storm,
    )
)

_register(
    Scenario(
        name="timeout_storm_legacy",
        description="The SAME storm with the overlay OFF — the committed "
        "pre-overlay baseline cell: every node broadcasts every Timeout "
        "(n-1 frames per local timeout, O(n²) per stalled round), the "
        "number the timeout_storm cells are diffed against in "
        "CHAOS_MATRIX_rN.json.",
        plan_n=_storm_plan,
        duration=30.0,
        min_commits=4,
        heal_t=_STORM_WINDOW[1],
        expect=_expect_timeout_storm_legacy,
        # Matrix-only: the baseline number is pinned by the committed
        # artifact (and the slow-tier test), not the tier-1 sweep.
        slow=True,
    )
)


def _agg_cert_params(timeout_ms: int = 1_000) -> Parameters:
    p = _agg_params(timeout_ms)
    p.aggregate_certs = True
    return p


# Upper bound on committed certificate bytes per commit EVENT in an
# aggregate cell: one AggQC (172 B under the 64-byte trusted-agg stub
# signature) plus headroom for a stall round's AggTC, both n-independent
# EXCEPT the committee bitmap (ceil(n/8) bytes per certificate — the only
# size-dependent term an aggregate certificate carries, and exactly the
# term `_agg_cert_bytes_bound` prices). Legacy cells at n=64 run ~4.3 KB
# per QC — the O(1)-modulo-bitmap claim is asserted per cell up to n=256.
AGG_CERT_BYTES_PER_COMMIT = 400


def _agg_cert_bytes_bound(n: int) -> int:
    """Size-parameterized form of the per-commit certificate budget: the
    flat two-certificate core plus two bitmaps' worth of growth."""
    return AGG_CERT_BYTES_PER_COMMIT + 2 * ((n + 7) // 8)


def _expect_agg_certs(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "agg.qcs_formed", minimum=4)
    problems += _expect_counter(deltas, "agg.cert_bytes_committed")
    problems += _expect_counter(deltas, "chaos.stub_agg_verifies")
    if deltas.get("agg.partial_rejects", 0):
        problems.append(
            f"fault-free aggregate fleet rejected "
            f"{deltas['agg.partial_rejects']} partials"
        )
    commits = deltas.get("consensus.commits", 0)
    if commits:
        bound = _agg_cert_bytes_bound(report["nodes"])
        per = deltas.get("agg.cert_bytes_committed", 0) / commits
        if per > bound:
            problems.append(
                f"certificate bytes per committed round {per:.0f} exceeds "
                f"the bitmap-parameterized bound {bound} at "
                f"n={report['nodes']} — the constant-size claim regressed"
            )
    return problems


_register(
    Scenario(
        name="agg_certs",
        description="Constant-size certificates (§5.5o): every vote and "
        "timeout rides as a singleton aggregate partial, interior overlay "
        "nodes merge bitmap-disjoint partials Handel-style, and committed "
        "blocks carry AggQC/AggTC — one aggregate signature plus a "
        "committee bitmap — so certificate bytes per committed round stay "
        "flat (modulo the ceil(n/8)-byte bitmap) from n=4 to n=256, the "
        "matrix column the O(1) claim is pinned by. Runs the trusted-agg "
        "stub at every size: the exact BLS pairing is for unit tests and "
        "the A/B bench, not fleets.",
        plan=lambda: FaultPlan(default_link=_LINK, wan=WanMatrix()),
        parameters=_agg_cert_params,
        trusted_crypto=True,
        matrix_sizes=(4, 64, 128, 256),
        min_commits=4,
        expect=_expect_agg_certs,
    )
)


# Commit-proof serving (§5.5q): worst-case CommitProof wire size for a
# single-payload block — version byte, 32 B author, u64 round, one-digest
# payload seq, 32 B parent hash + u64 parent round, epoch flag, and the
# aggregate certificate (flat core + the ceil(n/8)-byte committee
# bitmap). Size-parameterized like the certificate bound: the O(1)
# claim is "flat modulo the bitmap", not "flat including it".
PROOF_BYTES_CORE = 310


def _proof_bytes_bound(n: int) -> int:
    return PROOF_BYTES_CORE + ((n + 7) // 8)


def _proof_totals(report: dict) -> dict:
    totals = {
        "tracked": 0, "served": 0, "verified_ok": 0, "verify_failed": 0,
        "unproved_committed": 0, "proof_bytes_max": 0,
    }
    for summary in report.get("proofs", {}).values():
        for k in totals:
            if k == "proof_bytes_max":
                totals[k] = max(totals[k], summary.get(k, 0))
            else:
                totals[k] += summary.get(k, 0)
    return totals


def _expect_ingress_proofs(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "proofs.indexed")
    problems += _expect_counter(deltas, "proofs.resolved")
    problems += _expect_counter(deltas, "proofs.served", minimum=4)
    if deltas.get("proofs.cert_mismatch", 0):
        problems.append(
            f"{deltas['proofs.cert_mismatch']} commit notes carried a "
            "certificate that did not certify the committed block"
        )
    totals = _proof_totals(report)
    if not totals["tracked"]:
        problems.append("no admitted transaction entered the proof loop")
    if totals["served"] < 4:
        problems.append(
            f"only {totals['served']} proofs reached a client in hand "
            "(floor 4) — the submit→commit→proof loop barely closed"
        )
    # EVERY served proof must verify statelessly at the client; a
    # committed-and-indexed tx whose key never resolved would be an
    # admitted-and-committed tx its client cannot prove.
    if totals["verify_failed"]:
        problems.append(
            f"{totals['verify_failed']} served proofs FAILED stateless "
            "client verification"
        )
    if totals["verified_ok"] != totals["served"]:
        problems.append(
            f"{totals['verified_ok']} verified of {totals['served']} served"
        )
    if totals["unproved_committed"]:
        problems.append(
            f"{totals['unproved_committed']} committed transactions are "
            "not provable by their client (registry resolution hole)"
        )
    bound = _proof_bytes_bound(report["nodes"])
    if totals["proof_bytes_max"] > bound:
        problems.append(
            f"worst served proof {totals['proof_bytes_max']} B exceeds the "
            f"O(1) bound {bound} B at n={report['nodes']}"
        )
    return problems


def _proofs_ingress_config() -> IngressConfig:
    # Generous default lanes + a fast verify tick: this scenario pins the
    # proof loop, not admission overload (flash_crowd_ingress owns that).
    return IngressConfig(verify_batch=4, verify_interval=0.05)


def _proofs_ingress_load() -> IngressLoad:
    return IngressLoad(
        curve=ArrivalCurve(kind="sustained", rate=2),
        duration=10.0,
        clients=2,
        tx_bytes=32,
        config=_proofs_ingress_config,
    )


_register(
    Scenario(
        name="ingress_proofs",
        description="Commit-proof serving plane (§5.5q): open-loop clients "
        "submit through every node's authenticated ingress, each ACCEPTED "
        "digest rides that node's next proposal, and a proof client "
        "subscribes until commit — every served CommitProof must verify "
        "STATELESSLY against the committee keys alone, stay within the "
        "bitmap-parameterized O(1) byte bound, and no admitted-and-"
        "committed transaction may end the run unprovable.",
        plan=lambda: FaultPlan(default_link=_LINK),
        parameters=_agg_cert_params,
        trusted_crypto=True,
        duration=14.0,
        cell_duration=14.0,  # the loop plays out in 14 s at every size
        min_commits=0,  # no early stop: the 4 s post-load tail must play out
        ingress=_proofs_ingress_load,
        proofs=True,
        expect=_expect_ingress_proofs,
    )
)


def _expect_proof_squatter(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "proofs.subs_shed", minimum=200)
    sent = shed = 0
    for s in report.get("proof_squat", {}).values():
        sent += s.get("sent", 0)
        shed += s.get("shed", 0)
    if sent < 200:
        problems.append(f"squat driver barely ran: {sent} subscriptions")
    if shed != sent:
        problems.append(
            f"only {shed} of {sent} never-admitted subscriptions were shed "
            "(a squatter must never park a waiter or earn a proof)"
        )
    # The registry stays bounded under the flood: squat traffic allocates
    # NOTHING, so total indexed state tracks honest traffic + the ring
    # capacity, orders of magnitude under the squat volume.
    for label, s in sorted(report.get("proofs", {}).items()):
        if s.get("registry_size", 0) > 3_000:
            problems.append(
                f"node {label}: registry size {s['registry_size']} — "
                "squat subscriptions appear to allocate state"
            )
    # Honest clients still get verified proofs THROUGH the squat flood.
    totals = _proof_totals(report)
    if totals["served"] < 4:
        problems.append(
            f"only {totals['served']} honest proofs served under squatting"
        )
    if totals["verify_failed"]:
        problems.append(
            f"{totals['verify_failed']} served proofs failed verification"
        )
    return problems


_register(
    Scenario(
        name="proof_squatter",
        description="Byzantine nonce-squatting clients flood every node's "
        "proof port with subscribe-until-commit queries for (client, nonce) "
        "pairs that were never admitted: each one must be SHED with a retry "
        "hint and allocate NOTHING (proofs.subs_shed pins the count, the "
        "registry size stays bounded by honest traffic), while honest "
        "clients keep receiving verified proofs through the flood.",
        plan=lambda: FaultPlan(default_link=_LINK),
        parameters=_agg_cert_params,
        trusted_crypto=True,
        duration=12.0,
        min_commits=0,
        ingress=_proofs_ingress_load,
        proofs=True,
        proof_squat_rate=25.0,
        expect=_expect_proof_squatter,
    )
)


def _expect_agg_crash(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "chaos.crashes")
    problems += _expect_counter(deltas, "chaos.restarts")
    problems += _expect_counter(deltas, "agg.bundles_sent")
    problems += _expect_counter(deltas, "agg.entries_merged")
    problems += _expect_counter(deltas, "consensus.timeouts")
    # The crashed node's leader/aggregator rounds stall past
    # agg_fallback_ms, so the bounded gossip fallback must engage —
    # degradation, not silence.
    problems += _expect_counter(deltas, "agg.fallbacks")
    return problems


_register(
    Scenario(
        name="agg_collector_crash",
        description="An overlay aggregator crashes mid-run (node 1 down "
        "t=1..6 of a 7-node committee): rounds where it was the leader, "
        "a subtree parent, or the timeout collector stall to the "
        "pacemaker, the gossip fallback engages (bounded fan-out instead "
        "of silence), and liveness is clean after the restart.",
        n=7,
        plan=lambda: FaultPlan(
            default_link=_LINK,
            wan=WanMatrix(),
            crashes=[CrashWindow(node=1, at=1.0, restart=6.0)],
        ),
        parameters=_agg_params,
        duration=40.0,
        min_commits=4,
        heal_t=6.0,
        expect=_expect_agg_crash,
    )
)


def _expect_agg_byzantine(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "chaos.forged_votes")
    # chaos.forged_timeouts is deliberately NOT required here: an
    # early-stopping seed can reach its commit floor before any timeout
    # round, and even in a stalled round node 1 may be that round's
    # collector (it then relays no timeout bundle to poison). The
    # timeout-plane poisoning coverage is pinned at the deterministic
    # tier-1 seed in tests/test_overlay.py.
    problems += _expect_counter(deltas, "chaos.withheld_votes")
    problems += _expect_counter(deltas, "agg.invalid_entries")
    problems += _expect_counter(deltas, "verifier.rejected_sigs")
    problems += _expect_counter(deltas, "agg.entries_merged")
    problems += _expect_counter(deltas, "consensus.commits", minimum=8)
    if report.get("forged_triples_cached", 0) != 0:
        problems.append(
            f"{report['forged_triples_cached']} forged bundle entries found "
            "in a VerifiedSigCache (rejected signatures must never be cached)"
        )
    return problems


_register(
    Scenario(
        name="agg_byzantine_bundles",
        description="Byzantine aggregator on the overlay plane: node 1 "
        "poisons every partial bundle it relays — a garbage-signature "
        "entry under an honest authority, plus its own timeout entry "
        "re-signed over an ABSURD high_qc_round the carried QC cannot "
        "back (the TC-poisoning shape) — and withholds every third "
        "bundle outright. A crash window forces timeout rounds so the "
        "timeout plane is exercised: every poisoned entry must reject "
        "ALONE (the honest entries beside it still merge, real RFC 8032 "
        "verification at n=4), nothing forged is ever cached, no TC "
        "becomes unjustifiable, and commits continue.",
        plan=lambda: FaultPlan(
            default_link=_LINK,
            wan=WanMatrix(),
            crashes=[CrashWindow(node=2, at=1.0, restart=4.0)],
        ),
        byzantine={1: BundlePoisoner},
        parameters=_agg_params,
        duration=60.0,
        min_commits=3,
        heal_t=4.0,
        expect=_expect_agg_byzantine,
    )
)


def _expect_agg_epoch(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "reconfig.epoch_switches", minimum=3)
    problems += _expect_counter(deltas, "reconfig.proposed")
    problems += _expect_counter(deltas, "agg.bundles_sent")
    problems += _expect_counter(deltas, "agg.entries_merged")
    switches = report.get("epoch_switches", {})
    if not switches:
        return problems + ["no node recorded an epoch switch"]
    acts = {e["activation_round"] for evs in switches.values() for e in evs}
    if len(acts) != 1:
        problems.append(f"nodes disagree on the activation round: {sorted(acts)}")
        return problems
    act = next(iter(acts))
    # The original quorum committed on BOTH sides of the boundary: the
    # pre-boundary commits rode epoch 1's tree, the post-boundary ones
    # epoch 2's (node 3 out, node 4 in) — the per-round committee
    # resolution is what rotates the tree at the seam.
    for i in (0, 1, 2):
        rounds = [r for r, _d in report["commits"].get(str(i), [])]
        if not any(r < act for r in rounds):
            problems.append(f"node {i} has no pre-boundary commit")
        if not any(r > act for r in rounds):
            problems.append(f"node {i} has no post-boundary commit")
    return problems


_register(
    Scenario(
        name="agg_epoch_boundary",
        description="An epoch boundary crosses the aggregation tree: the "
        "committee hands {0,1,2,3} -> {0,1,2,4} at a committed activation "
        "round with the overlay ON — vote/timeout bundles route on epoch "
        "1's tree before the boundary and epoch 2's after (the departed "
        "node drops out of the tree, the joiner enters it), with commits "
        "on both sides and one unanimous activation round.",
        n=5,
        committee=(0, 1, 2, 3),
        plan=lambda: FaultPlan(default_link=_CATCHUP_LINK, wan=WanMatrix()),
        parameters=_agg_params,
        reconfig=lambda: ReconfigDirective(
            at=2.0, add=(4,), remove=(3,), activation_margin=10
        ),
        duration=12.0,
        min_commits=0,  # no early stop: the boundary must play out
        expect=_expect_agg_epoch,
    )
)


def _observatory_params() -> Parameters:
    """The probe opt-in (Parameters.probe_interval_ms): probe frames
    share the transport's per-link fault streams with protocol traffic,
    so only the observatory scenarios — whose pins were minted WITH
    probes on — enable them. 250 ms gives every directed link several
    closed probe loops even on an early-stopping seed."""
    return Parameters(
        timeout_delay=1_000,
        sync_retry_delay=1_000,
        timeout_backoff=2.0,
        max_timeout_delay=8_000,
        probe_interval_ms=250,
    )


def _partition_of(regions: dict) -> set[frozenset]:
    """Label-free form of a node->region map: the set of region member
    sets, so synthetic `rtt-k` labels compare against seeded geography."""
    groups: dict[str, set] = {}
    for node, region in regions.items():
        groups.setdefault(region, set()).add(str(node))
    return {frozenset(g) for g in groups.values()}


def _expect_wan_observatory(report: dict, deltas: dict) -> list[str]:
    problems = _expect_counter(deltas, "net.peer.probes_sent")
    problems += _expect_counter(deltas, "net.peer.pongs_received")
    n = report["nodes"]
    latency = peer_latency_map(report.get("peers") or {})
    missing = [
        (a, b)
        for a in (str(i) for i in range(n))
        for b in (str(j) for j in range(n))
        if a != b and (latency.get(a) or {}).get(b) is None
    ]
    if missing:
        problems.append(
            f"{len(missing)} directed link(s) never closed a probe loop "
            f"(first: {missing[:3]})"
        )
        return problems
    inferred = infer_fleet_regions(latency)
    truth = report.get("wan_regions") or {}
    if not truth:
        return problems + ["no seeded WAN regions in the report"]
    if _partition_of(inferred) != _partition_of(truth):
        problems.append(
            "measured RTT classes do not recover the seeded WAN geometry: "
            f"inferred {sorted(inferred.items())} vs seeded "
            f"{sorted(truth.items())}"
        )
    return problems


_register(
    Scenario(
        name="wan_observatory",
        description="Network observatory under the seeded 4-region WAN "
        "matrix: RTT probes on (Parameters.probe_interval_ms), clean "
        "links — every directed link must close probe loops, and the "
        "measured per-peer RTT EWMAs must recover the seeded region "
        "geometry exactly (fleet union-find under the 30 ms threshold "
        "matches the plan's region partition). Same seed, same ledger, "
        "bit for bit — the measurement substrate for region-aware "
        "leader election (ROADMAP item 5).",
        plan=lambda: FaultPlan(wan=WanMatrix()),
        parameters=_observatory_params,
        duration=30.0,
        min_commits=8,
        expect=_expect_wan_observatory,
    )
)


def _election_params(region_aware: bool) -> Parameters:
    """Overlay on (the co-location story needs the vote tree), probes
    OFF — the cells elect from the seeded WanMatrix region map, the
    same map the overlay trees by, so the region-aware and region-blind
    twins differ in exactly one bit: Parameters.region_aware_election.
    Leader-collector rooting is on in BOTH arms: with votes flowing to
    the NEXT leader, the vote trip pipelines into the next broadcast
    and no placement can shorten it — the certificate must form at the
    CURRENT leader and hand off explicitly for the pivot to be a real
    frame election placement controls."""
    p = _agg_params()
    p.region_aware_election = region_aware
    p.leader_collector = True
    return p


# The election cells' fleet is SKEWED (40/30/20/10 across the default
# four regions): under balanced occupancy a 2f+1 quorum must span three
# of four regions, and a quorum-spanning vote path actually pipelines
# better through a MOVING leader (leader->voter->collector is a one-way
# tour) — co-location cannot win there, and plurality is a tie-break
# artifact anyway. With a genuine plurality, the plurality + runner-up
# regions alone reach quorum, so a co-located plurality leader commits
# in one near-region RTT. That is the geometry region-aware election is
# FOR, and the one the cells pin.
ELECTION_WEIGHTS = (0.4, 0.3, 0.2, 0.1)


def _election_plan() -> FaultPlan:
    return FaultPlan(
        default_link=_LINK, wan=WanMatrix(weights=ELECTION_WEIGHTS)
    )


# Floor on the pivot-hop reduction the region-aware schedule must hold at
# fleet scale (n >= TRUSTED_CRYPTO_MIN_N): at least this many times fewer
# cross-region propose->certify pivots per committed round than the
# round-robin twin. The schedule arithmetic predicts ~#regions/n vs
# ~(1 - 1/#regions) — about 12x at n=64 over 4 balanced regions — so 2x
# is a conservative, size-robust pin (a "~2x fewer" floor).
ELECTION_HOP_RATIO = 2.0


def _overall_commit_rate(report: dict) -> float:
    """Fleet commit events per virtual second over the WHOLE run (the
    windowed `_commit_rate` above serves the overload plateaus) — with
    both twins early-stopping at the same min_commits floor, the
    inverse of virtual time-to-floor, i.e. the commit-latency yardstick
    on the virtual clock."""
    commits = sum(len(v) for v in (report.get("commits") or {}).values())
    span = float(report.get("virtual_seconds") or 0.0)
    return commits / span if span else 0.0


def _expect_wan_election_blind(report: dict, deltas: dict) -> list[str]:
    """The region-blind twin's own gate: the election attribution must
    accrue (the counters are elector-mode-independent — that is what
    makes the A/B comparable) and matches + hops must partition the
    committed rounds."""
    problems = _expect_counter(deltas, "elect.rounds", minimum=4)
    rounds = deltas.get("elect.rounds", 0)
    matches = deltas.get("elect.leader_region_matches", 0)
    hops = deltas.get("elect.cross_region_hops", 0)
    if rounds and matches + hops != rounds:
        problems.append(
            f"election attribution does not partition: {matches} co-located "
            f"+ {hops} cross-region pivots != {rounds} committed rounds"
        )
    return problems


def _expect_wan_election(report: dict, deltas: dict) -> list[str]:
    """The region-aware cell is a one-cell A/B: after its own run, it
    REPLAYS the identical (seed, n, virtual window, WanMatrix) with the
    region-blind twin — run_scenario re-enters cleanly here because
    expectations evaluate after the virtual loop has fully drained —
    and pins both deltas: cross-region pivot hops per committed round
    drop by ELECTION_HOP_RATIO at fleet scale (never rise at any size),
    and the fleet commits strictly faster on the virtual clock. The
    in-run round-robin counterfactual (elect.cross_region_hops_blind)
    must agree with the twin's direction, so the artifact carries the
    reduction twice: priced inside one run and measured across two."""
    problems = _expect_wan_election_blind(report, deltas)
    rounds = deltas.get("elect.rounds", 0)
    if not rounds:
        return problems
    n = report["nodes"]
    aware = deltas.get("elect.cross_region_hops", 0) / rounds
    counterfactual = deltas.get("elect.cross_region_hops_blind", 0) / rounds
    if aware > counterfactual:
        problems.append(
            f"in-run counterfactual inverted: region-aware pivots cross "
            f"{aware:.3f}/commit vs {counterfactual:.3f} under round-robin "
            "placement of the same rounds"
        )
    blind = run_scenario(
        "wan_election_blind",
        report["seed"],
        duration=report["duration_requested"],
        n=n,
        trusted_crypto=report.get("crypto_mode") != "exact",
    )
    if not blind["ok"]:
        problems.append(
            "region-blind twin failed its own run: "
            + "; ".join(
                blind.get("safety_violations", [])[:2]
                + blind.get("liveness_violations", [])[:2]
                + blind.get("expectation_failures", [])[:2]
            )
        )
        return problems
    b_rounds = blind["metrics"].get("elect.rounds", 0)
    if not b_rounds:
        return problems + ["region-blind twin accrued no election rounds"]
    b_hops = blind["metrics"].get("elect.cross_region_hops", 0) / b_rounds
    if n >= TRUSTED_CRYPTO_MIN_N:
        if aware * ELECTION_HOP_RATIO > b_hops:
            problems.append(
                f"cross-region pivot hops per commit: region-aware "
                f"{aware:.3f} vs region-blind {b_hops:.3f} — less than the "
                f"pinned {ELECTION_HOP_RATIO:.0f}x reduction at n={n}"
            )
        aware_rate = _overall_commit_rate(report)
        blind_rate = _overall_commit_rate(blind)
        if aware_rate <= blind_rate:
            problems.append(
                f"virtual-clock commit latency did not improve: "
                f"{aware_rate:.3f} commits/s region-aware vs "
                f"{blind_rate:.3f} region-blind at n={n}"
            )
    elif aware > b_hops:
        problems.append(
            f"cross-region pivot hops per commit rose under the "
            f"region-aware schedule at n={n}: {aware:.3f} vs {b_hops:.3f}"
        )
    return problems


_register(
    Scenario(
        name="wan_election",
        description="Region-aware leader election under the seeded "
        "4-region WAN matrix with 40/30/20/10 skewed occupancy (§5.5p): "
        "the plurality + runner-up regions alone reach quorum, and "
        "region-block rotation keeps the "
        "propose->certify pivot — leader of round r handing to the vote "
        "collector, who IS round r+1's leader — inside one region except "
        "at the #regions block seams, so cross-region pivot hops per "
        "committed round drop and commits land faster on the virtual "
        "clock. The expectation replays the identical seed/size/window "
        "with the region-blind twin in the same cell: the artifact pins "
        "the A/B, not just the treated arm. The commit floor is one full "
        "rotation cycle at n=64 (and a whole multiple at n=4), so both "
        "arms average over EVERY region's geometry — a shorter window "
        "would sample only the plurality block's links.",
        plan=_election_plan,
        parameters=lambda: _election_params(True),
        duration=30.0,
        min_commits=64,
        matrix_sizes=(4, 64),
        expect=_expect_wan_election,
    )
)


_register(
    Scenario(
        name="wan_election_blind",
        description="The region-blind control arm of the wan_election "
        "A/B: identical overlay, WanMatrix, and parameters except "
        "region_aware_election=False (legacy round-robin). Never swept "
        "standalone in the matrix — wan_election's expectation replays "
        "it in-cell at the treated arm's exact seed/size/window.",
        plan=_election_plan,
        parameters=lambda: _election_params(False),
        duration=30.0,
        min_commits=64,
        expect=_expect_wan_election_blind,
        slow=True,
    )
)


# ---------------------------------------------------------------------------
# Production-grade succession : rolling committee
# churn under the epoch-final handoff, quorum crashing at the activation
# boundary, and a joiner range-syncing across several boundaries mid-batch.
# All three are membership/topology/timing scenarios, so their tier-1 tests
# run under the trusted-crypto stub (the trusted-crypto trust model: forgery is not
# at stake here and exact pysigner dominates wall time); the matrix carries
# an exact-crypto rolling_churn cell at n=4.

_CHURN_EPOCHS = 3  # boundaries the committee rotates through
_CHURN_MARGIN = 8  # activation margin per directive (rounds)


def _churn_committee(n: int) -> tuple[int, ...]:
    """Genesis committee for a size-n fleet: the first max(3, n//2)
    indices — the rest are join candidates the rotation admits."""
    return tuple(range(max(3, n // 2)))


def _churn_rotate(n: int) -> int:
    """Members replaced per boundary: a third of the committee (rounded
    up), so _CHURN_EPOCHS boundaries replace every genesis member."""
    c = len(_churn_committee(n))
    return max(1, (c + 2) // 3)


def _churn_directives(n: int) -> list[ReconfigDirective]:
    k = _churn_rotate(n)
    # `at` times are lower bounds only: each directive additionally waits
    # for the previous boundary to be committed-past (the orchestrator's
    # progress gate), so churn paces itself off real chain progress.
    return [
        ReconfigDirective(at=t, rotate=k, activation_margin=_CHURN_MARGIN)
        for t in (1.5, 2.5, 3.5)
    ]


def _switch_memberships(report: dict) -> tuple[list[str], dict]:
    """Fold per-node epoch-switch events into epoch -> (activation,
    members), flagging any disagreement (the unanimity contract)."""
    problems: list[str] = []
    by_epoch: dict[int, set] = {}
    for evs in report.get("epoch_switches", {}).values():
        for e in evs:
            by_epoch.setdefault(e["epoch"], set()).add(
                (e["activation_round"], tuple(e.get("members", ())))
            )
    folded = {}
    for epoch in sorted(by_epoch):
        if len(by_epoch[epoch]) != 1:
            problems.append(
                f"nodes disagree on epoch {epoch}'s boundary/membership: "
                f"{sorted(by_epoch[epoch])}"
            )
        else:
            act, members = next(iter(by_epoch[epoch]))
            folded[epoch] = (act, members)
    return problems, folded


def _expect_no_handoff_violation(deltas: dict) -> list[str]:
    """The hard invariant the epoch-final handoff establishes: a commit
    may never land past its declared activation round."""
    late = deltas.get("reconfig.late_applies", 0)
    if late:
        return [
            f"epoch handoff violated: reconfig.late_applies = {late} "
            "(a commit landed at/past its declared activation round)"
        ]
    return []


def _expect_rolling_churn(report: dict, deltas: dict) -> list[str]:
    n = report["nodes"]
    genesis = set(_churn_committee(n))
    problems = _expect_no_handoff_violation(deltas)
    problems += _expect_counter(
        deltas, "reconfig.proposed", minimum=_CHURN_EPOCHS
    )
    problems += _expect_counter(
        deltas, "reconfig.epoch_switches", minimum=_CHURN_EPOCHS
    )
    disagreements, memberships = _switch_memberships(report)
    problems += disagreements
    expected = set(range(2, 2 + _CHURN_EPOCHS))
    if not expected <= set(memberships):
        problems.append(
            f"committee did not rotate through epochs {sorted(expected)}: "
            f"saw {sorted(memberships)}"
        )
        return problems
    if disagreements:
        return problems
    # FULL rotation: every genesis member rotated out at some boundary.
    for g in sorted(genesis):
        if all(g in members for _act, members in memberships.values()):
            problems.append(f"genesis member {g} never rotated out")
    # Per-node commit floors, scaled by the committee geometry: every
    # FINAL-committee member holds a participation floor, and members
    # past the last boundary must carry QUORUM weight of the final
    # committee — the committee demonstrably works as a committee. (Not
    # every-member: at fleet sizes a few joiners can still be mid
    # catch-up at cutoff without any liveness defect; at the default
    # n=6 the final committee is 3-of-3, so quorum = everyone and the
    # tier-1 pin stays maximal.)
    final_act, final_members = memberships[max(expected)]
    past_boundary = 0
    for i in sorted(final_members):
        rounds = [r for r, _d in report["commits"].get(str(i), [])]
        if len(rounds) < 3:
            problems.append(
                f"final-committee node {i} committed {len(rounds)} blocks (< 3)"
            )
        elif max(rounds) > final_act:
            past_boundary += 1
    quorum = 2 * len(final_members) // 3 + 1
    if past_boundary < quorum:
        problems.append(
            f"only {past_boundary} of {len(final_members)} final-committee "
            f"members committed past the last boundary {final_act} "
            f"(quorum {quorum})"
        )
    # Joiners demonstrably used batched range sync, and the safety
    # checker audited the run (its own epoch-final schedule included).
    problems += _expect_counter(deltas, "sync.range_requests")
    problems += _expect_counter(deltas, "sync.range_blocks", minimum=3)
    problems += _expect_counter(deltas, "chaos.invariant_checks")
    return problems


_register(
    Scenario(
        name="rolling_churn",
        description="The committee FULLY rotates over three committed "
        "epoch boundaries while traffic runs: chained committee-free "
        "rotation directives (a third of the committee per boundary, "
        "paced off real chain progress), every genesis member departs, "
        "every joiner range-syncs across the prior boundaries and "
        "commits past the last one, all under the epoch-final handoff — "
        "reconfig.late_applies must stay ZERO and the SafetyChecker's "
        "independently derived epoch schedule must agree at every step.",
        n=6,
        committee_n=_churn_committee,
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.1)),
        reconfig_n=_churn_directives,
        # Three progress-gated boundaries + a joiner catch-up stall per
        # boundary (small committees need every member, so each admission
        # costs a few pacemaker rounds) + post-final-boundary traffic.
        duration=45.0,
        cell_duration=45.0,  # the matrix cell needs the full contract too
        min_commits=0,  # no early stop: all three boundaries must play out
        expect=_expect_rolling_churn,
    )
)


def _expect_boundary_quorum_crash(report: dict, deltas: dict) -> list[str]:
    problems = _expect_no_handoff_violation(deltas)
    problems += _expect_counter(deltas, "chaos.crashes", minimum=3)
    problems += _expect_counter(deltas, "chaos.restarts", minimum=3)
    problems += _expect_counter(deltas, "reconfig.epoch_switches")
    disagreements, memberships = _switch_memberships(report)
    problems += disagreements
    if 2 not in memberships:
        return problems + ["the epoch-2 boundary never landed"]
    act, _members = memberships[2]
    # The crashed quorum must come back on epoch 2 (persisted epoch-final
    # state reloaded — or the pending handoff replayed to completion) and
    # commit PAST the boundary it crashed at.
    finals = report.get("final_epochs", {})
    for i in ("0", "1", "2"):
        if finals.get(i) != 2:
            problems.append(
                f"restarted node {i} ended on epoch {finals.get(i)}, not 2 "
                "(persisted epoch-final state not recovered)"
            )
        rounds = [r for r, _d in report["commits"].get(i, [])]
        if not any(r > act for r in rounds):
            problems.append(
                f"restarted node {i} never committed past the boundary {act}"
            )
    # Progress resumed AFTER the restarts (the boundary crash healed).
    restarts = [
        e["t"] for e in report["events"] if e["event"] == "restart"
    ]
    if restarts:
        heal = max(restarts)
        resumed = any(
            t > heal
            for times in report.get("commit_times", {}).values()
            for t in times
        )
        if not resumed:
            problems.append(
                f"no commit after the last restart at t={heal} — the "
                "boundary crash never healed"
            )
    return problems


_register(
    Scenario(
        name="boundary_quorum_crash",
        description="A quorum of the old committee (nodes 0-2 of "
        "{0,1,2,3}) crashes the INSTANT the first epoch-2 switch lands — "
        "the worst place to die: some victims have applied and persisted "
        "the boundary, some still hold only the pending handoff. On "
        "restart every victim must reload its epoch-final state (schedule "
        "+ pending wall), never re-judge rounds its crashed incarnation "
        "certified, and the fleet must commit past the boundary with "
        "reconfig.late_applies still zero.",
        n=5,
        committee=(0, 1, 2, 3),
        plan=lambda: FaultPlan(default_link=_CATCHUP_LINK),
        reconfig=lambda: ReconfigDirective(
            at=2.0, add=(4,), remove=(3,), activation_margin=10
        ),
        boundary_crashes=lambda: [
            BoundaryCrash(epoch=2, nodes=(0, 1, 2), down_s=3.0)
        ],
        duration=25.0,
        min_commits=0,  # no early stop: crash + recovery must play out
        expect=_expect_boundary_quorum_crash,
    )
)


def _expect_multi_epoch_catchup(report: dict, deltas: dict) -> list[str]:
    problems = _expect_no_handoff_violation(deltas)
    problems += _expect_counter(deltas, "reconfig.epoch_switches")
    disagreements, memberships = _switch_memberships(report)
    problems += disagreements
    if not {2, 3} <= set(memberships):
        return problems + [
            f"both boundaries must land: saw epochs {sorted(memberships)}"
        ]
    boots = [e for e in report["events"] if e["event"] == "boot"]
    if [e["node"] for e in boots] != [5]:
        problems.append(f"expected one late boot of node 5, saw {boots}")
    # The late joiner crossed BOTH boundaries inside its range-synced
    # batches (its store was empty at boot) and ended on the live epoch,
    # near the live tip.
    if report.get("final_epochs", {}).get("5") != 3:
        problems.append(
            f"late joiner ended on epoch "
            f"{report.get('final_epochs', {}).get('5')}, not 3"
        )
    problems += _expect_catchup(report, deltas, node=5)
    return problems


_register(
    Scenario(
        name="multi_epoch_catchup",
        description="Two chained epoch boundaries land ({0,1,2,3} -> "
        "{1,2,3,4} -> {2,3,4,5}) and THEN node 5 — admitted by the second "
        "change — boots for the first time with an EMPTY store: one "
        "genesis range sync must replay the chain THROUGH both committed "
        "boundaries (epoch switches committed mid-batch govern the blocks "
        "after them), leaving the joiner on the live epoch within the "
        "tip-lag bound.",
        n=6,
        committee=(0, 1, 2, 3),
        plan=lambda: FaultPlan(
            default_link=_CATCHUP_LINK,
            boots=[DelayedBoot(node=5, at=10.0)],
        ),
        reconfig=lambda: [
            ReconfigDirective(at=1.5, add=(4,), remove=(0,), activation_margin=10),
            ReconfigDirective(at=2.5, add=(5,), remove=(1,), activation_margin=10),
        ],
        duration=18.0,
        min_commits=0,  # no early stop: both boundaries + the boot play out
        expect=_expect_multi_epoch_catchup,
    )
)


# The short sweep tier-1 runs (and the CLI's --scenario all default).
SHORT_SCENARIOS = [name for name, s in SCENARIOS.items() if not s.slow]

# Scenario-matrix grid (`python -m hotstuff_tpu_torch.chaos_run --matrix`):
# the default sweep of scenarios x seeds x committee sizes whose consolidated
# report (CHAOS_MATRIX_rN.json) is the regression harness for every scale claim
# the ROADMAP makes. Grid scenarios must be COMMITTEE-SIZE-INVARIANT:
# faults expressed as per-link defaults or single-node crash windows, no
# hardcoded committee subsets (the reference's graftlint `matrix` pass
# enforces both on its grid, which this one equals).
# timeout_storm / timeout_storm_legacy are the storm cells: the
# same size-parameterized half|half stall with the overlay on vs off, so
# the artifact carries BOTH frames-per-stalled-round numbers (the
# `timeout_plane` block per cell) and the O(n²) -> O(n·fanout) win is a
# committed, regression-tracked delta.
# rolling_churn is the grid's reconfig cell: committee-free
# by construction (committee_n + rotation directives derive membership
# from n), exact crypto at n=4, trusted-stub at n=64, with per-node
# commit floors scaled by the committee geometry in its expectation.
# wan_observatory is the measurement cell: probes on, clean
# links — asserts the MEASURED per-peer RTT classes recover the seeded
# WanMatrix geometry at every grid size (committee-free by construction;
# the probe plane is size-agnostic).
MATRIX_SCENARIOS = (
    "baseline",
    "lossy_links",
    "leader_crash",
    "timeout_storm",
    "timeout_storm_legacy",
    "rolling_churn",
    "wan_observatory",
    # The constant-size-certificate cells: aggregate QC/TC under
    # the trusted-agg stub, extended to n=256 via its matrix_sizes
    # override (the committee sizes the O(1) bytes-per-committed-round
    # claim is about).
    "agg_certs",
    # The election cells: region-aware vs region-blind
    # A/B inside one cell — the expectation replays the blind twin at
    # the identical seed/size/window and pins the cross-region pivot-hop
    # reduction plus the virtual-clock commit-latency win.
    "wan_election",
    # The commit-proof serving cells: the full
    # submit→commit→proof loop at n=4 and n=64 — every served proof
    # client-verified, none of the committed admissions unprovable.
    "ingress_proofs",
    # The flood cells (the flash-crowd residue):
    # flash_crowd_ingress grid-shaped — shed with retry hints, plateau
    # held, no starved node, the spike window pinned in the incident
    # ledger — at n=4 and (trusted-stub) n=64.
    "flood",
)
MATRIX_SEEDS = (1, 2)
MATRIX_SIZES = (4, 64)
# Cells at/above this committee size run the trusted-crypto stub
# (chaos/trusted_crypto.py): exact-int pysigner at 64 nodes costs ~minutes
# of wall time PER ROUND, which is exactly what the stub exists to remove.
# wan_election's expectation keys its fleet-scale floor on it too.
TRUSTED_CRYPTO_MIN_N = 16
# Virtual-seconds cap per matrix cell: grid scenarios early-stop on their
# commit floors well before this; the cap bounds a regressed cell's wall
# cost instead of letting it soak its full scenario duration. 30 (not
# 15): lossy links at 64 nodes can cost a multi-round pacemaker stall
# with backed-off 8 s timeouts before healing (observed at seed 2 —
# rounds 8-12, ~10 virtual seconds), and the cap must leave room for the
# slowest node to reach the scenario's commit floor AFTER such a stall.
MATRIX_CELL_DURATION_S = 30.0


def matrix_telemetry_config() -> TelemetryConfig:
    """Per-node telemetry for matrix cells: snapshots fast enough that a
    short early-stopping cell still fills a few windows (the fleet rollup
    merges these rings), rings small enough that a 100-node cell's report
    stays tractable."""
    return TelemetryConfig(interval_s=0.5, ring=64, dump_snapshots=4)


def cell_name(scenario: str, seed: int, n: int) -> str:
    """The stable cell key regression diffs join on."""
    return f"{scenario}@s{seed}/n{n}"


def run_matrix_cell(
    scenario: str,
    seed: int,
    n: int,
    trusted: str = "auto",
    wan: bool = True,
    duration: float | None = None,
) -> dict:
    """Execute one matrix cell and distill it to the committed record:
    verdict + fleet telemetry rollup (utils/telemetry.fleet_rollup), with
    the heavy per-scenario sections (fault trace, flight recorders, raw
    telemetry rings) dropped — a 12-cell matrix with 64-node cells must
    stay a reviewable artifact. `trusted` is auto|on|off; auto stubs
    crypto from TRUSTED_CRYPTO_MIN_N nodes up (the committee size where
    exact-int pysigner stops being runnable on one box)."""
    import time as _time

    from ..utils.telemetry import fleet_rollup
    from .plan import WanMatrix

    if trusted not in ("auto", "on", "off"):
        raise ValueError(f"trusted must be auto|on|off, got {trusted!r}")
    trusted_crypto = (
        trusted == "on"
        or (trusted == "auto" and n >= TRUSTED_CRYPTO_MIN_N)
        or SCENARIOS[scenario].trusted_crypto
    )
    if duration is None:
        # The cell cap bounds a REGRESSED cell's wall cost; only a
        # scenario that declares a cell_duration (rolling_churn's three
        # progress-gated boundaries) gets a longer budget — truncating
        # it would fail the cell for want of virtual time, not health,
        # while un-capping every long scenario would make legacy cells
        # non-comparable across matrix revisions.
        duration = SCENARIOS[scenario].cell_duration or MATRIX_CELL_DURATION_S
    t0 = _time.perf_counter()
    report = run_scenario(
        scenario,
        seed,
        duration=duration,
        n=n,
        trusted_crypto=trusted_crypto,
        wan=WanMatrix() if wan else None,
        telemetry=matrix_telemetry_config(),
    )
    wall = _time.perf_counter() - t0
    # Timeout-plane storm accounting: whenever the cell saw
    # local timeouts, commit the frames-per-timeout ratio (and its
    # per-stalled-round form, n× that) so the overlay-vs-legacy delta is
    # diffable straight from the artifact.
    cell_metrics = report.get("metrics", {})
    timeouts = cell_metrics.get("consensus.timeouts", 0)
    frames = cell_metrics.get("agg.timeout_frames", 0)
    timeout_plane = None
    if timeouts:
        timeout_plane = {
            "local_timeouts": timeouts,
            "frames": frames,
            "frames_per_timeout": round(frames / timeouts, 2),
            "frames_per_stalled_round": round(n * frames / timeouts, 1),
        }
    return {
        "cell": cell_name(scenario, seed, n),
        "timeout_plane": timeout_plane,
        "scenario": scenario,
        "seed": seed,
        "n": n,
        "crypto_mode": report["crypto_mode"],
        "wan": wan,
        "green": bool(report["ok"]),
        "wall_seconds": round(wall, 3),
        "virtual_seconds": report["virtual_seconds"],
        "violations": {
            "safety": report["safety_violations"][:5],
            "liveness": report["liveness_violations"][:5],
            "expectations": report.get("expectation_failures", [])[:5],
        },
        "rollup": fleet_rollup(report),
    }

_DELTA_PREFIXES = (
    "chaos.", "verifier.", "consensus.", "net.", "ingress.", "scheduler.",
    "telemetry.", "sync.", "reconfig.", "wan.", "agg.", "elect.", "proofs.",
    "incident.",
)


def _counter_snapshot() -> dict:
    return {
        k: v
        for k, v in metrics.dump(include_buckets=False)["counters"].items()
        if k.startswith(_DELTA_PREFIXES)
    }


def run_scenario(
    name: str,
    seed: int,
    duration: float | None = None,
    n: int | None = None,
    trusted_crypto: bool = False,
    wan: "object | None" = None,
    telemetry: TelemetryConfig | None = None,
) -> dict:
    """Execute one named scenario on a fresh VirtualTimeLoop; returns the
    report dict (see ChaosOrchestrator._report) extended with the scenario
    name, metric deltas, and expectation failures folded into `ok`.

    The fleet overrides (all default-off, so committed determinism pins
    replay unchanged): `n` scales the committee — only valid for
    scenarios without a pinned committee subset; `trusted_crypto` swaps
    signatures for the keyed-hash stub (chaos/trusted_crypto.py — read
    its trust model first); `wan` attaches a plan.WanMatrix of per-region
    RTT classes; `telemetry` forces a per-node TelemetryPlane config (the
    matrix runner's rollup source) over the scenario's own."""
    scenario = SCENARIOS[name]
    if n is not None and scenario.committee is not None:
        raise ValueError(
            f"scenario {name!r} pins committee indices "
            f"{scenario.committee}; its node count cannot be overridden"
        )
    effective_n = n if n is not None else scenario.n
    committee_indices = (
        list(scenario.committee_n(effective_n))
        if scenario.committee_n is not None
        else (list(scenario.committee) if scenario.committee is not None else None)
    )
    reconfig = (
        scenario.reconfig_n(effective_n)
        if scenario.reconfig_n is not None
        else (scenario.reconfig() if scenario.reconfig else None)
    )
    plan = (
        scenario.plan_n(effective_n)
        if scenario.plan_n is not None
        else scenario.plan()
    )
    if wan is not None and plan.wan is None:
        # A scenario whose plan PINS its own matrix (the wan_election
        # cells' weighted-occupancy geometry) keeps it; the override
        # only attaches a matrix to plans that have none. Every grid
        # scenario that pins one pins the default WanMatrix(), so this
        # is not a behavior change for any committed cell.
        plan.wan = wan
    telemetry_config = (
        telemetry
        if telemetry is not None
        else (scenario.telemetry() if scenario.telemetry else None)
    )
    before = _counter_snapshot()

    async def body() -> dict:
        orch = ChaosOrchestrator(
            seed=seed,
            n=effective_n,
            plan=plan,
            byzantine=dict(scenario.byzantine),
            parameters=scenario.parameters(),
            ingress=scenario.ingress() if scenario.ingress else None,
            flood=scenario.flood() if scenario.flood else None,
            scheduler_config=scenario.scheduler() if scenario.scheduler else None,
            telemetry_config=telemetry_config,
            committee_indices=committee_indices,
            reconfig=reconfig,
            boundary_crashes=(
                scenario.boundary_crashes() if scenario.boundary_crashes else None
            ),
            trusted_crypto=trusted_crypto or scenario.trusted_crypto,
            proofs=scenario.proofs,
            proof_squat_rate=scenario.proof_squat_rate,
            burn_budget=scenario.burn_budget() if scenario.burn_budget else None,
        )
        report = await orch.run(
            duration if duration is not None else scenario.duration,
            min_commits=scenario.min_commits,
            heal_t=scenario.heal_t,
        )
        if scenario.heal_t is not None:
            orch.liveness.require_progress(scenario.heal_t, orch.honest)
            report["liveness_violations"] = orch.liveness.violations
            report["ok"] = report["ok"] and orch.liveness.ok()
        if scenario.byzantine:
            report["forged_triples_cached"] = orch.forged_triples_cached()
        return report

    report = vtime.run(
        body(), timeout=VIRTUAL_TIMEOUT_S, wall_timeout=WALL_TIMEOUT_S
    )
    after = _counter_snapshot()
    deltas = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    report["scenario"] = name
    report["description"] = scenario.description
    # What the run was ASKED to last: expectations that gate on an early
    # stop (min_commits reached) compare virtual_seconds against this.
    report["duration_requested"] = (
        duration if duration is not None else scenario.duration
    )
    report["metrics"] = {k: v for k, v in sorted(deltas.items()) if v}
    if scenario.expect is not None:
        failures = scenario.expect(report, deltas)
        report["expectation_failures"] = failures
        report["ok"] = report["ok"] and not failures
    return report
