"""Leader election (reference consensus/src/leader.rs:16-20).

The port's copy of `hotstuff_tpu/consensus/leader.py`, its imports
rewritten to this package. Two electors share one seam
(`get_leader(round) -> PublicKey`), selected by
`Parameters.region_aware_election` (the wiring in consensus.py):

  * `LeaderElector` — round-robin over the sorted authority keys — of
    the committee governing the round, so rotation crosses epoch
    boundaries with the committee (consensus/reconfig.py): a joined
    validator enters the rotation at its epoch's activation round and a
    departed one leaves it.

  * `RegionAwareElector` — region-block rotation: the rotation order
    groups members by WAN region — the plurality region first (most
    members; ties break on the smaller label, the rule the aggregation
    overlay uses to place its timeout-plane collector) — and members
    lead CONSECUTIVELY within their region. Every member still leads
    exactly once per committee cycle (round-robin's fairness bound) and
    every region's slot share equals its member share, but round r's
    certificate reaches round r+1's proposer across regions only at the
    region-block seams: #regions pivots per cycle instead of
    ~(1 - sum(share^2)) of all rounds under interleaved round-robin.

The region-aware schedule is a PURE function of (round, the committee of
that round, the frozen region map) — `elect_region_aware` — so every
honest node, a restarted node, and an auditor compute bit-identical
schedules, port and reference alike. Nothing here reads clocks, live
RTTs or any other mutable runtime state: measured inputs are frozen ONCE
at construction (see RegionAwareElector's fallback order). A node process
passes no region map, so its schedule is round-robin, as the reference's.
"""

from __future__ import annotations

from ..crypto import PublicKey
from .config import Committee
from .reconfig import Round, as_manager


class LeaderElector:
    def __init__(self, committee: Committee) -> None:
        # Committee or reconfig.EpochManager (per-epoch sorted keys are
        # cached inside the schedule — this resolves every round).
        self._epochs = as_manager(committee)

    def get_leader(self, round_: Round) -> PublicKey:
        keys = self._epochs.schedule.sorted_keys_for_round(round_)
        return keys[round_ % len(keys)]


def plurality_region(
    keys: list[PublicKey], region_of: dict[PublicKey, str]
) -> str:
    """The region label hosting the most of `keys` (unknown -> "");
    ties break on the smaller label — the overlay's collector-placement
    rule, so leader and timeout collector agree on "home" by
    construction."""
    counts: dict[str, int] = {}
    for pk in keys:
        label = region_of.get(pk, "")
        counts[label] = counts.get(label, 0) + 1
    return min(counts.items(), key=lambda kv: (-kv[1], kv[0]))[0]


def elect_region_aware(
    round_: Round, keys: list[PublicKey], region_of: dict[PublicKey, str]
) -> PublicKey:
    """The pure region-aware schedule rule. `keys` is the sorted
    committee of `round_`; `region_of` the frozen region map. The
    rotation order re-sorts the committee by (region size desc, region
    label, key) — plurality region first, members contiguous per region
    — and round r is led by position r mod |committee|. Degrades to
    plain round-robin when the map is empty or the committee spans a
    single region (a region-less fleet is bit-identical to the legacy
    elector)."""
    if not region_of:
        return keys[round_ % len(keys)]
    counts: dict[str, int] = {}
    for pk in keys:
        label = region_of.get(pk, "")
        counts[label] = counts.get(label, 0) + 1
    if len(counts) <= 1:
        return keys[round_ % len(keys)]
    ordered = sorted(
        keys,
        key=lambda pk: (
            -counts[region_of.get(pk, "")],
            region_of.get(pk, ""),
            pk,
        ),
    )
    return ordered[round_ % len(ordered)]


class RegionAwareElector(LeaderElector):
    """Latency-aware elector behind the same seam. Region-source
    fallback order, resolved ONCE at construction and frozen:

      1. `measured_rtts` — per-peer RTT EWMAs keyed by authority key
         (assembled by the caller from the network observatory's
         PeerViews, utils/telemetry.peer_views). Used only with FULL
         committee coverage (every genesis authority has at least one
         measured link), partitioned by utils/telemetry's RTT-class
         union-find — partial coverage would hand different nodes
         different maps and split the schedule.
      2. `region_of` — the seeded/overlay region map (the same map the
         aggregation overlay trees by, so every node shares it).
      3. Neither -> plain round-robin (LeaderElector semantics).
    """

    def __init__(
        self,
        committee: Committee,
        region_of: dict[PublicKey, str] | None = None,
        measured_rtts: dict[PublicKey, dict[PublicKey, float]] | None = None,
    ) -> None:
        super().__init__(committee)
        self._regions: dict[PublicKey, str] = dict(region_of or {})
        if measured_rtts:
            measured = self._regions_from_measurements(measured_rtts)
            if measured is not None:
                self._regions = measured

    def _regions_from_measurements(
        self, rtts: dict[PublicKey, dict[PublicKey, float]]
    ) -> dict[PublicKey, str] | None:
        # Lazy import: the telemetry module never becomes a consensus
        # import requirement.
        from ..utils.telemetry import infer_fleet_regions

        genesis = self._epochs.schedule.sorted_keys_for_round(0)
        by_hex = {pk.data.hex(): pk for pk in genesis}
        latency: dict[str, dict[str, float]] = {}
        for a, row in sorted(rtts.items(), key=lambda kv: kv[0].data):
            cleaned = {
                b.data.hex(): float(v)
                for b, v in sorted(row.items(), key=lambda kv: kv[0].data)
                if v is not None
            }
            if cleaned:
                latency[a.data.hex()] = cleaned
        covered = set(latency) | {b for row in latency.values() for b in row}
        if not latency or not all(h in covered for h in by_hex):
            return None
        inferred = infer_fleet_regions(latency)
        return {
            by_hex[h]: label
            for h, label in sorted(inferred.items())
            if h in by_hex
        }

    @property
    def regions(self) -> dict[PublicKey, str]:
        """The frozen region map actually in effect (diagnostics)."""
        return dict(self._regions)

    def get_leader(self, round_: Round) -> PublicKey:
        keys = self._epochs.schedule.sorted_keys_for_round(round_)
        return elect_region_aware(round_, keys, self._regions)
