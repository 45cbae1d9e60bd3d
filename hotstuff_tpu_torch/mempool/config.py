"""Mempool committee and parameters (reference mempool/src/config.rs:8-84).

Each authority exposes two mempool-plane addresses: `front_address` (client
transactions) and `mempool_address` (mempool-to-mempool payload traffic).

The port's copy of `hotstuff_tpu/mempool/config.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto import PublicKey
from ..network.net import Address


@dataclass(slots=True)
class MempoolAuthority:
    name: PublicKey
    front_address: Address
    mempool_address: Address


@dataclass(slots=True)
class MempoolCommittee:
    authorities: dict[PublicKey, MempoolAuthority]
    epoch: int = 1

    @staticmethod
    def new(
        info: list[tuple[PublicKey, Address, Address]], epoch: int = 1
    ) -> "MempoolCommittee":
        return MempoolCommittee(
            {name: MempoolAuthority(name, front, mem) for name, front, mem in info},
            epoch,
        )

    def exists(self, name: PublicKey) -> bool:
        return name in self.authorities

    def front_address(self, name: PublicKey) -> Address | None:
        a = self.authorities.get(name)
        return a.front_address if a else None

    def mempool_address(self, name: PublicKey) -> Address | None:
        a = self.authorities.get(name)
        return a.mempool_address if a else None

    def broadcast_addresses(self, myself: PublicKey) -> list[Address]:
        return [
            a.mempool_address
            for n, a in self.authorities.items()
            if n != myself
        ]

    def to_json(self) -> dict:
        return {
            "epoch": self.epoch,
            "authorities": {
                n.encode_base64(): {
                    "front_address": f"{a.front_address[0]}:{a.front_address[1]}",
                    "mempool_address": f"{a.mempool_address[0]}:{a.mempool_address[1]}",
                }
                for n, a in self.authorities.items()
            },
        }

    @staticmethod
    def from_json(obj: dict) -> "MempoolCommittee":
        def parse(s: str) -> Address:
            host, port = s.rsplit(":", 1)
            return (host, int(port))

        auths = {}
        for name_b64, a in obj["authorities"].items():
            pk = PublicKey.decode_base64(name_b64)
            auths[pk] = MempoolAuthority(
                pk, parse(a["front_address"]), parse(a["mempool_address"])
            )
        return MempoolCommittee(auths, obj.get("epoch", 1))


class MempoolEpochView:
    """Epoch-aware mempool committee: the payload plane's half of the
    epoch-final handoff (consensus/reconfig.py, §5.5j).

    The genesis MempoolCommittee is static config; this view resolves
    membership through the node's shared EpochManager instead, so
    payload gossip fan-out, sync serving/requesting and address lookup
    cross an epoch boundary at the SAME position as consensus (the
    declared activation round — the manager's round hint is advanced by
    the consensus core, and both planes read one schedule):

      * `broadcast_addresses` — gossip fans out to the CURRENT epoch's
        committee only: a joiner starts receiving payload gossip at the
        switch, a leaver stops at it.
      * `exists` — payload acceptance spans every KNOWN epoch: blocks
        near the boundary still reference payloads authored by the
        adjacent epoch's members, and availability (not authorship
        admission) is the payload plane's contract — ordering authority
        stays with consensus.
      * `mempool_address` — resolves through the manager's payload-plane
        registry (genesis seeds it, applied EpochChanges extend it), so
        a JOINER's payloads become fetchable exactly at the switch and a
        departed member's stored payloads stay servable for old blocks.
      * `front_address` — genesis only: the client-facing port is the
        node's own config, never dialed by peers.

    Duck-type compatible with MempoolCommittee everywhere the mempool
    core/synchronizer consult a committee."""

    __slots__ = ("genesis", "epochs", "_known", "_known_epoch")

    def __init__(self, genesis: MempoolCommittee, epochs) -> None:
        self.genesis = genesis
        self.epochs = epochs
        epochs.seed_mempool_addresses(
            {
                pk: a.mempool_address
                for pk, a in genesis.authorities.items()
            }
        )
        # Cached union of every known epoch's member keys: `exists` runs
        # on the per-payload gossip-ingress hot path, and rescanning the
        # schedule per call would grow linearly with deployment age.
        # Rebuilt lazily when the applied epoch advances.
        self._known: frozenset = frozenset(genesis.authorities)
        self._known_epoch = epochs.applied_epoch

    @property
    def epoch(self) -> int:
        return self.epochs.applied_epoch

    def exists(self, name: PublicKey) -> bool:
        if name in self.genesis.authorities:
            return True
        if self.epochs.applied_epoch != self._known_epoch:
            known = set(self.genesis.authorities)
            for _activation, committee in self.epochs.schedule.entries():
                known.update(committee.authorities)
            self._known = frozenset(known)
            self._known_epoch = self.epochs.applied_epoch
        return name in self._known

    def front_address(self, name: PublicKey) -> Address | None:
        return self.genesis.front_address(name)

    def mempool_address(self, name: PublicKey) -> Address | None:
        addr = self.epochs.mempool_address(name)
        if addr is not None:
            return addr
        return self.genesis.mempool_address(name)

    def members_for_round(self, round_) -> tuple[PublicKey, ...]:
        """The payload-plane membership governing `round_` — by
        construction the consensus committee of the same round, which is
        the 'both planes switch at the same position' pin."""
        return tuple(self.epochs.committee_for_round(round_).sorted_keys())

    def broadcast_addresses(self, myself: PublicKey) -> list[Address]:
        out = []
        for pk in self.epochs.current().sorted_keys():
            if pk == myself:
                continue
            addr = self.mempool_address(pk)
            if addr is not None:
                out.append(addr)
        return out


@dataclass(slots=True)
class MempoolParameters:
    """Reference defaults (mempool/src/config.rs:15-24), plus the benchmark
    workload knobs the fork hard-codes (mempool/src/core.rs:68-101)."""

    queue_capacity: int = 10_000
    sync_retry_delay: int = 10_000
    max_payload_size: int = 100_000
    min_block_delay: int = 100
    # Fork's synthetic batched-signature-verification workload: every
    # own/others payload triggers a batch verification of len(transactions)
    # synthetic (message, key, signature) triples. The reference pre-generates
    # 200_000 triples at startup (mempool/src/core.rs:71-84); the pool size is
    # configurable here (the per-payload verification WORK is identical --
    # triples are drawn cyclically from the pool).
    benchmark_mode: bool = False
    synthetic_pool_size: int = 10_000
    # Bound on the Front's client-tx intake queue (drop-oldest past it,
    # counted in mempool.front_dropped) — the raw benchmark port's share
    # of the admission-control story (hotstuff_tpu/ingress has the
    # authenticated one).
    front_queue_capacity: int = 10_000
    # Authenticated client ingress (hotstuff_tpu/ingress): when enabled,
    # Mempool.run boots an IngressServer on front_port +
    # ingress_port_offset, feeding verified client transactions into the
    # PayloadMaker's DEDICATED ingress intake lane (the Front keeps its
    # own lane, so its drop-oldest overflow can never evict an accepted
    # ingress body — the two planes coexist; scheduler source classes).
    ingress_enabled: bool = False
    ingress_port_offset: int = 1_000
    # Bound on the ingress intake lane into the PayloadMaker. Unlike the
    # Front's drop-oldest queue, a full ingress lane BLOCKS its producer
    # (the IngressPipeline drain), which is the backpressure chain that
    # ends in admission shedding with retry-after.
    ingress_queue_capacity: int = 2_048
    # Commit-proof serving plane (hotstuff_tpu/proofs): with ingress
    # enabled and a ProofRegistry wired by the composition root,
    # Mempool.run boots a ProofServer on front_port + proofs_port_offset
    # — the finality-read counterpart of the ingress write port.
    proofs_port_offset: int = 2_000
    # Byzantine bound on PayloadRequest serving: at most this many payloads
    # are served per request frame (the prefix; the requester's retry loop
    # fetches the rest). Honest requests cover one block's digests —
    # consensus max_payload_size/32, 15 at the default config — so the
    # default leaves ample headroom while capping the reply amplification
    # a hostile requester can extract from one small frame.
    max_request_digests: int = 1_024

    def log(self, log) -> None:
        # NOTE: these log entries are parsed by the benchmark harness.
        log.info("Queue capacity set to %s", self.queue_capacity)
        log.info("Sync retry delay set to %s ms", self.sync_retry_delay)
        log.info("Max payload size set to %s B", self.max_payload_size)
        log.info("Min block delay set to %s ms", self.min_block_delay)

    def to_json(self) -> dict:
        return {
            "queue_capacity": self.queue_capacity,
            "sync_retry_delay": self.sync_retry_delay,
            "max_payload_size": self.max_payload_size,
            "min_block_delay": self.min_block_delay,
            "benchmark_mode": self.benchmark_mode,
            "synthetic_pool_size": self.synthetic_pool_size,
            "max_request_digests": self.max_request_digests,
            "front_queue_capacity": self.front_queue_capacity,
            "ingress_enabled": self.ingress_enabled,
            "ingress_port_offset": self.ingress_port_offset,
            "ingress_queue_capacity": self.ingress_queue_capacity,
            "proofs_port_offset": self.proofs_port_offset,
        }

    @staticmethod
    def from_json(obj: dict) -> "MempoolParameters":
        p = MempoolParameters()
        for k in (
            "queue_capacity",
            "sync_retry_delay",
            "max_payload_size",
            "min_block_delay",
            "benchmark_mode",
            "synthetic_pool_size",
            "max_request_digests",
            "front_queue_capacity",
            "ingress_enabled",
            "ingress_port_offset",
            "ingress_queue_capacity",
            "proofs_port_offset",
        ):
            if k in obj:
                setattr(p, k, obj[k])
        return p
