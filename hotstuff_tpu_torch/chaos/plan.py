"""Fault plans: the declarative schedule a chaos run executes.

A FaultPlan is pure data — per-directed-link fault probabilities, timed
partitions, and crash/restart windows — interpreted by the FaultyTransport
(link faults, partitions) and the orchestrator's lifecycle task (crashes).
All randomness is drawn from SeededRng streams derived from ONE master
seed, and every per-link decision depends only on (seed, src, dst,
frame-sequence-number), so a replay with the same seed reproduces the
identical fault trace.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field


class SeededRng:
    """Master seed -> named independent RNG streams.

    Each stream's state depends only on (master seed, stream name) — never
    on draw order across streams — so adding a consumer cannot perturb the
    decisions of existing ones (the property that keeps fault traces
    stable under scenario evolution)."""

    def __init__(self, seed: int) -> None:
        self.seed = int(seed)

    def stream(self, name: str) -> random.Random:
        digest = hashlib.sha256(f"{self.seed}:{name}".encode()).digest()
        return random.Random(int.from_bytes(digest[:8], "big"))


@dataclass(frozen=True)
class LinkFaults:
    """Per-directed-link fault probabilities/parameters. All probabilities
    in [0, 1]; delays in (virtual) seconds."""

    drop: float = 0.0  # P(frame silently dropped)
    duplicate: float = 0.0  # P(frame delivered twice)
    reorder: float = 0.0  # P(frame held back past later traffic)
    delay: float = 0.0  # base one-way latency added to every frame
    jitter: float = 0.0  # uniform extra latency in [0, jitter]
    reorder_delay: float = 0.05  # hold-back applied to reordered frames

    def is_noop(self) -> bool:
        return not (
            self.drop or self.duplicate or self.reorder or self.delay or self.jitter
        )


# Default inter-region ROUND-TRIP times (ms), loosely the public-cloud
# numbers Handel-style evaluations assume (PAPERS.md, arXiv:1906.05132
# runs city-to-city WAN topologies): two US regions, one EU, one AP.
# One-way link latency = rtt/2; same-region traffic pays `intra_rtt_ms`.
_DEFAULT_REGIONS = ("us-east", "us-west", "eu-west", "ap-north")
_DEFAULT_RTT_MS = (
    ("us-east", "us-west", 62.0),
    ("us-east", "eu-west", 82.0),
    ("us-east", "ap-north", 158.0),
    ("us-west", "eu-west", 136.0),
    ("us-west", "ap-north", 102.0),
    ("eu-west", "ap-north", 224.0),
)


@dataclass(frozen=True)
class WanMatrix:
    """Per-region RTT classes for a fleet: each node is assigned a region
    deterministically from the run's seed, and every directed link pays
    the matrix's one-way latency for its (src-region, dst-region) pair in
    ADDITION to the LinkFaults delay/jitter (faults model the link's
    quality; the matrix models where the endpoints sit). A flat
    `LinkFaults.delay` gives every pair the same cost — this is the
    topology future aggregation overlays have to win
    on: an aggregation tree that respects regions beats one that does
    not only if cross-region links actually cost more."""

    regions: tuple[str, ...] = _DEFAULT_REGIONS
    rtt_ms: tuple[tuple[str, str, float], ...] = _DEFAULT_RTT_MS
    intra_rtt_ms: float = 4.0
    # Optional occupancy weights, one per region in `regions` order.
    # None (the default, and every pre-§5.5p committed cell) keeps the
    # balanced round-robin assignment below BIT-IDENTICAL. A weighted
    # matrix models a skewed fleet — the geometry where a plurality
    # region actually exists and plurality-first election has something
    # to win (wan_election cells run 40/30/20/10): seats go by largest
    # remainder, so at small n the lightest regions may sit empty.
    weights: tuple[float, ...] | None = None

    def __post_init__(self) -> None:
        table = {}
        for a, b, rtt in self.rtt_ms:
            table[(a, b)] = table[(b, a)] = rtt / 2e3  # one-way seconds
        for r in self.regions:
            table[(r, r)] = self.intra_rtt_ms / 2e3
        missing = [
            (a, b)
            for a in self.regions
            for b in self.regions
            if (a, b) not in table
        ]
        if missing:
            raise ValueError(f"WanMatrix missing RTT for region pairs {missing}")
        if self.weights is not None and (
            len(self.weights) != len(self.regions)
            or any(w <= 0 for w in self.weights)
        ):
            raise ValueError(
                "WanMatrix weights must be positive, one per region"
            )
        object.__setattr__(self, "_one_way", table)

    def one_way_s(self, src_region: str, dst_region: str) -> float:
        return self._one_way[(src_region, dst_region)]

    def assign(self, rng, n: int) -> list[str]:
        """Region per node index, a pure function of the given seeded
        stream. Balanced mode (weights=None): the region LIST is
        shuffled once, then nodes take regions round-robin — balanced
        occupancy (every region within 1 of n/R) with a seed-dependent
        mapping, so two seeds exercise different leader-region
        geometries without ever emptying a region. Weighted mode: seats
        per region by largest remainder over the weights, then the seat
        list is shuffled once — same determinism contract, skewed
        occupancy."""
        if self.weights is None:
            order = list(self.regions)
            rng.shuffle(order)
            return [order[i % len(order)] for i in range(n)]
        total = sum(self.weights)
        quotas = [n * w / total for w in self.weights]
        seats = [int(q) for q in quotas]
        remainders = sorted(
            range(len(self.regions)),
            key=lambda i: (-(quotas[i] - seats[i]), i),
        )
        for i in remainders[: n - sum(seats)]:
            seats[i] += 1
        assignment = [
            region
            for region, count in zip(self.regions, seats)
            for _ in range(count)
        ]
        rng.shuffle(assignment)
        return assignment

    def to_json(self) -> dict:
        out = {
            "regions": list(self.regions),
            "rtt_ms": [list(row) for row in self.rtt_ms],
            "intra_rtt_ms": self.intra_rtt_ms,
        }
        if self.weights is not None:
            out["weights"] = list(self.weights)
        return out


@dataclass(frozen=True)
class Partition:
    """Between virtual times [start, end), nodes in different groups cannot
    exchange frames. Nodes absent from every group communicate freely."""

    start: float
    end: float
    groups: tuple[tuple[int, ...], ...]

    def __post_init__(self) -> None:
        # Membership map precomputed once: blocks() runs per frame on the
        # transport hot path for the whole partition window.
        object.__setattr__(
            self,
            "_side",
            {n: i for i, g in enumerate(self.groups) for n in g},
        )

    def blocks(self, src: int, dst: int, now: float) -> bool:
        if not (self.start <= now < self.end):
            return False
        a, b = self._side.get(src), self._side.get(dst)
        return a is not None and b is not None and a != b


@dataclass(frozen=True)
class CrashWindow:
    """Node `node` is crashed (tasks cancelled, store closed) at virtual
    time `at`; restarted against its persisted store at `restart`
    (None = never restarted)."""

    node: int
    at: float
    restart: float | None = None


@dataclass(frozen=True)
class DelayedBoot:
    """Node `node` does not boot with the run: it starts for the FIRST
    time at virtual time `at`, with an empty store — the genesis-catch-up
    shape (a fresh validator joining a chain already in flight), as
    opposed to CrashWindow's restart against persisted state."""

    node: int
    at: float


@dataclass
class FaultPlan:
    """The full schedule. `links` overrides `default_link` per directed
    (src, dst) pair of node indices."""

    default_link: LinkFaults = field(default_factory=LinkFaults)
    links: dict[tuple[int, int], LinkFaults] = field(default_factory=dict)
    partitions: list[Partition] = field(default_factory=list)
    crashes: list[CrashWindow] = field(default_factory=list)
    boots: list[DelayedBoot] = field(default_factory=list)
    # Per-region WAN latency classes layered ON TOP of link faults (None =
    # every link pays only its LinkFaults delay, the historical behaviour
    # — committed scenario determinism pins rely on that default).
    wan: WanMatrix | None = None

    def link(self, src: int, dst: int) -> LinkFaults:
        return self.links.get((src, dst), self.default_link)

    def partitioned(self, src: int, dst: int, now: float) -> bool:
        return any(p.blocks(src, dst, now) for p in self.partitions)

    def to_json(self) -> dict:
        return {
            "default_link": vars(self.default_link).copy(),
            "links": {
                f"{s}->{d}": vars(lf).copy() for (s, d), lf in self.links.items()
            },
            "partitions": [
                {"start": p.start, "end": p.end, "groups": [list(g) for g in p.groups]}
                for p in self.partitions
            ],
            "crashes": [
                {"node": c.node, "at": c.at, "restart": c.restart}
                for c in self.crashes
            ],
            "boots": [{"node": b.node, "at": b.at} for b in self.boots],
            "wan": self.wan.to_json() if self.wan is not None else None,
        }
