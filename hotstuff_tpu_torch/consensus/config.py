"""Consensus committee and parameters (reference consensus/src/config.rs).

Quorum math: with total stake N, quorum_threshold = 2N/3 + 1, so any two
quorums intersect in at least one honest authority when N = 3f+1
(consensus/src/config.rs:68-73).

The port's copy of `hotstuff_tpu/consensus/config.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import PublicKey
from ..network.net import Address


@dataclass(slots=True)
class Authority:
    stake: int
    address: Address


@dataclass(slots=True)
class Committee:
    """Voting authorities for one epoch (consensus/src/config.rs:31-88)."""

    authorities: dict[PublicKey, Authority]
    epoch: int = 1

    @staticmethod
    def new(info: list[tuple[PublicKey, int, Address]], epoch: int = 1) -> "Committee":
        return Committee(
            {name: Authority(stake, addr) for name, stake, addr in info}, epoch
        )

    def size(self) -> int:
        return len(self.authorities)

    def stake(self, name: PublicKey) -> int:
        auth = self.authorities.get(name)
        return auth.stake if auth else 0

    def total_votes(self) -> int:
        return sum(a.stake for a in self.authorities.values())

    def quorum_threshold(self) -> int:
        # 2N/3 + 1 (ensures any two quorums intersect in an honest node).
        return 2 * self.total_votes() // 3 + 1

    def address(self, name: PublicKey) -> Address | None:
        auth = self.authorities.get(name)
        return auth.address if auth else None

    def broadcast_addresses(self, myself: PublicKey) -> list[Address]:
        return [
            a.address for n, a in self.authorities.items() if n != myself
        ]

    def sorted_keys(self) -> list[PublicKey]:
        return sorted(self.authorities.keys())

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "authorities": {
                name.encode_base64(): {
                    "stake": a.stake,
                    "address": f"{a.address[0]}:{a.address[1]}",
                }
                for name, a in self.authorities.items()
            },
        }

    @staticmethod
    def from_json(obj: dict) -> "Committee":
        auths = {}
        for name_b64, a in obj["authorities"].items():
            host, port = a["address"].rsplit(":", 1)
            auths[PublicKey.decode_base64(name_b64)] = Authority(
                a["stake"], (host, int(port))
            )
        return Committee(auths, obj.get("epoch", 1))


@dataclass(slots=True)
class Parameters:
    """Protocol tuning knobs with the reference defaults
    (consensus/src/config.rs:18-27)."""

    timeout_delay: int = 5_000  # ms before the pacemaker fires
    sync_retry_delay: int = 10_000  # ms between sync request retries
    max_payload_size: int = 500  # max bytes of payload digests per block
    min_block_delay: int = 100  # ms minimum spacing between blocks
    # Pacemaker exponential backoff (a liveness improvement over the
    # reference's fixed delay, consensus/src/timer.rs): each consecutive
    # local timeout multiplies the delay by `timeout_backoff` up to
    # `max_timeout_delay`; any QC that advances the round restores
    # `timeout_delay`. Under sustained overload a fixed pacemaker fires
    # storms of Timeout/TC work that compound the overload; backoff lets the backlog drain.
    # 1.0 disables backoff (reference behavior).
    timeout_backoff: float = 2.0
    max_timeout_delay: int = 30_000  # ms cap for the backed-off delay
    # Region-aware aggregation overlay for the vote/timeout plane
    # (consensus/overlay.py). Default OFF: the all-to-all plane is the
    # committed-determinism baseline every pre-overlay scenario pins;
    # fleet-scale deployments (and the overlay chaos scenarios) opt in.
    aggregation_overlay: bool = False
    agg_fanout: int = 4  # tree arity AND the gossip-fallback peer count
    agg_hold_ms: int = 50  # interior merge window before forwarding up
    agg_fallback_ms: int = 500  # stalled-round bound before gossip fallback
    agg_max_forwards: int = 3  # upward re-forwards per (round, kind) key
    # Constant-size certificates (§5.5o): votes/timeouts carry aggregate
    # partials (one combined signature + committee bitmap) instead of
    # per-entry signature lists, and QC/TC wire forms become AggQC/AggTC.
    # Requires an installed aggsig scheme + key registry and an aggregate
    # signer (`Consensus.run(agg_signer=)`; the chaos orchestrator wires all
    # three in trusted_crypto fleets). A node process supplies no signer,
    # so its nodes take the flag and form no AggQC.
    aggregate_certs: bool = False
    agg_window: int = 8  # Handel score window: best-N partials kept per key
    # Network-observatory RTT probing (network/net.py peer ledger,
    # consensus/core.py probe ticker). 0 disables it — the default,
    # because probe frames share the chaos transport's per-link fault
    # streams with protocol traffic: enabling them shifts every
    # committed same-seed determinism pin. Scenarios that measure the
    # network (wan_observatory) opt in explicitly.
    probe_interval_ms: int = 0
    # Region-aware leader election (§5.5p, consensus/leader.py):
    # region-block rotation — the plurality WAN region's members lead
    # consecutively first, then the next region's, so the commit-critical
    # propose->certify pivot crosses regions only at region seams.
    # Default OFF: round-robin is the committed-determinism baseline;
    # the wan_election chaos cells and WAN deployments opt in. The
    # schedule stays a pure function of (round, committee, region map),
    # so flipping this on changes WHICH deterministic schedule runs,
    # never introduces nondeterminism.
    region_aware_election: bool = False
    # Leader-rooted vote collection (§5.5p): votes for round r flow to
    # round r's OWN leader (collector == leader's region head by
    # construction — under region-aware election the whole quorum path
    # stays inside the proposing region), and the finished certificate
    # rides ONE explicit handoff frame to round r+1's proposer. Default
    # OFF: the committed baseline roots the vote plane at the NEXT
    # leader, whose moving target pipelines the vote trip into the next
    # proposal broadcast — the wiring region placement cannot shorten.
    # The wan_election cells enable this in BOTH A/B arms so the only
    # varied bit is the election schedule itself.
    leader_collector: bool = False

    def log(self, log) -> None:
        # NOTE: these log entries are parsed by the benchmark LogParser.
        log.info("Timeout delay set to %s ms", self.timeout_delay)
        log.info("Sync retry delay set to %s ms", self.sync_retry_delay)
        log.info("Max payload size set to %s B", self.max_payload_size)
        log.info("Min block delay set to %s ms", self.min_block_delay)
        log.info("Timeout backoff set to %s", self.timeout_backoff)
        if self.probe_interval_ms:
            log.info("Probe interval set to %s ms", self.probe_interval_ms)
        if self.region_aware_election:
            log.info("Region-aware election enabled")
        if self.leader_collector:
            log.info("Leader-rooted vote collection enabled")

    def to_json(self) -> dict:
        return {
            "timeout_delay": self.timeout_delay,
            "sync_retry_delay": self.sync_retry_delay,
            "max_payload_size": self.max_payload_size,
            "min_block_delay": self.min_block_delay,
            "timeout_backoff": self.timeout_backoff,
            "max_timeout_delay": self.max_timeout_delay,
            "aggregation_overlay": self.aggregation_overlay,
            "agg_fanout": self.agg_fanout,
            "agg_hold_ms": self.agg_hold_ms,
            "agg_fallback_ms": self.agg_fallback_ms,
            "agg_max_forwards": self.agg_max_forwards,
            "aggregate_certs": self.aggregate_certs,
            "agg_window": self.agg_window,
            "probe_interval_ms": self.probe_interval_ms,
            "region_aware_election": self.region_aware_election,
            "leader_collector": self.leader_collector,
        }

    @staticmethod
    def from_json(obj: dict) -> "Parameters":
        p = Parameters()
        for k in vars(p) if not hasattr(Parameters, "__slots__") else Parameters.__slots__:
            if k in obj:
                setattr(p, k, obj[k])
        return p
