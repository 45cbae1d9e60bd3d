"""Mempool subsystem launcher (reference mempool/src/mempool.rs:21-115):
wires the Front, net sender/receiver, payload maker, synchronizer, and core.

The port's copy of `hotstuff_tpu/mempool/mempool.py`, its imports rewritten
to this package, without the ingress server and the commit-proof server
(`ingress_enabled` is refused).
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import PublicKey, SignatureService
from ..network import NetReceiver, NetSender
from ..store import Store
from ..utils.actors import channel, spawn
from .config import MempoolCommittee, MempoolEpochView, MempoolParameters
from .core import Core
from .front import Front
from .messages import decode_mempool_message
from .payload_maker import PayloadMaker
from .synchronizer import Synchronizer

log = logging.getLogger("hotstuff.mempool")


class Mempool:
    @staticmethod
    def run(
        name: PublicKey,
        committee: MempoolCommittee,
        parameters: MempoolParameters,
        store: Store,
        signature_service: SignatureService,
        consensus_mempool_channel: asyncio.Queue,
        consensus_channel: asyncio.Queue,
        verification_service=None,
        epoch_manager=None,
        listen_addresses: tuple = None,
        proof_registry=None,
    ) -> Core:
        """Boot the mempool plane. `consensus_mempool_channel` carries
        Get/Verify/Cleanup requests FROM consensus; `consensus_channel` lets
        the payload synchronizer LoopBack blocks INTO the consensus core.

        `epoch_manager` (consensus/reconfig.py) is the node's SHARED
        epoch view: when given, the committee the core/synchronizer
        consult becomes a MempoolEpochView, so payload gossip fan-out,
        sync serving/requesting and address resolution cross a committed
        epoch boundary at the same activation round as consensus — the
        payload-plane half of the epoch-final handoff (§5.5j).
        `listen_addresses` = (front, mempool) covers a JOIN candidate
        not present in the genesis mempool committee: it still needs
        bound ports to serve and fetch payloads once admitted.

        The authenticated client ingress (`ingress_enabled`) is not
        ported: parameters that enable it are refused."""
        if parameters.ingress_enabled:
            raise ValueError("ingress_enabled is not ported (the ingress server and commit proofs)")
        parameters.log(log)

        core_channel = channel()
        network_tx = channel()
        # Explicitly bounded client-tx intake: the Front's drop-oldest
        # admission and the ingress pipeline's backpressure both key off
        # this queue filling up.
        tx_client = channel(parameters.front_queue_capacity)

        front_addr = committee.front_address(name)
        mempool_addr = committee.mempool_address(name)
        if listen_addresses:
            # Fill only what the genesis committee does not provide — a
            # committee member with an explicit listen override is more
            # likely a misconfiguration than an intent to rebind.
            # (Programmatic seam for join candidates, mirroring
            # Consensus.run's listen_address; node/main.py CLI wiring
            # for live joins is named ROADMAP residue.)
            if front_addr is None:
                front_addr = listen_addresses[0]
            if mempool_addr is None:
                mempool_addr = listen_addresses[1]
        assert front_addr is not None and mempool_addr is not None, (
            "node must be in the mempool committee or supply listen_addresses"
        )
        if epoch_manager is not None:
            committee = MempoolEpochView(committee, epoch_manager)

        Front(("0.0.0.0", front_addr[1]), tx_client)
        NetReceiver(
            ("0.0.0.0", mempool_addr[1]),
            core_channel,
            decode=decode_mempool_message,
            name="mempool-receiver",
        )
        sender = NetSender(network_tx, name="mempool-sender")

        # Dedicated ingress intake lane (per-plane PayloadMaker intake):
        # bounded, BLOCKING producer — the opposite admission
        # contract from the Front's drop-oldest queue above, and what
        # makes ingress backpressure end-to-end when both planes carry
        # traffic at once.
        tx_ingress = (
            channel(parameters.ingress_queue_capacity)
            if parameters.ingress_enabled
            else None
        )

        payload_maker = PayloadMaker(
            name,
            signature_service,
            parameters.max_payload_size,
            parameters.min_block_delay,
            tx_client,
            core_channel,
            ingress_in=tx_ingress,
            proof_registry=proof_registry,
        )
        synchronizer = Synchronizer(
            name,
            committee,
            store,
            network_tx,
            consensus_channel,
            parameters.sync_retry_delay,
        )
        core = Core(
            name,
            committee,
            parameters,
            store,
            payload_maker,
            synchronizer,
            core_channel,
            consensus_mempool_channel,
            network_tx,
            verification_service=verification_service,
        )
        # Close the shedding loop: the payload maker stops flushing (and
        # starts dropping txs) while the core's payload queue is full —
        # every flush past that point would fail _queue_insert anyway — OR
        # while gossip egress is backlogged to a majority of peers: a
        # payload produced then would drop on the wire, leaving a digest
        # the committee can't fetch without sync round-trips (admission
        # shedding at the Front is where overload is supposed to land).
        payload_maker.backlog_fn = lambda: (
            len(core.queue) >= parameters.queue_capacity
            or sender.egress_backlogged()
        )
        spawn(core.run(), name="mempool-core")
        log.info("Mempool of node %s successfully booted on %s", name.short(), mempool_addr)
        return core
