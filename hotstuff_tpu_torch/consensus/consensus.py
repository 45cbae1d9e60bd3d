"""Consensus subsystem launcher (reference consensus/src/consensus.rs:20-105):
wires the net receiver/sender, leader elector, mempool driver, synchronizer,
and spawns the core state-machine actor.

The port's copy of `hotstuff_tpu/consensus/consensus.py`, its imports
rewritten to this package; round-robin or region-aware election
(`Parameters.region_aware_election`, consensus/leader.py).
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import PublicKey, SignatureService
from ..network import NetReceiver, NetSender
from ..network.net import Address
from ..store import Store
from ..utils.actors import channel, spawn
from .config import Committee, Parameters
from .core import Core
from .leader import LeaderElector, RegionAwareElector
from .mempool_driver import MempoolDriver
from .messages import decode_consensus_message
from .reconfig import EpochManager, as_manager
from .synchronizer import Synchronizer

log = logging.getLogger("hotstuff.consensus")


class Consensus:
    @staticmethod
    def run(
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        store: Store,
        signature_service: SignatureService,
        mempool_channel: asyncio.Queue,
        commit_channel: asyncio.Queue,
        core_channel: asyncio.Queue | None = None,
        verification_service=None,
        epoch_manager: EpochManager | None = None,
        listen_address: Address | None = None,
        overlay_regions: dict[PublicKey, str] | None = None,
        agg_signer=None,
        proof_registry=None,
    ) -> Core:
        """Boot the consensus plane; returns the Core (its actor task is
        spawned). The committee addresses are this plane's listen ports.
        `core_channel` may be supplied by the composition root so other
        subsystems (the mempool payload synchronizer) can LoopBack blocks
        into the core (node/src/node.rs:34-89 channel wiring).

        `epoch_manager` (reconfig.py) is shared by the core, leader
        elector, aggregator and synchronizer, so a committed epoch change
        moves them to the successor committee atomically; one is built
        from the genesis committee when not supplied. `listen_address`
        covers a node that is NOT in the genesis committee — a validator
        expecting to JOIN at a later epoch boundary still needs a bound
        port to catch up and participate from. `overlay_regions` maps
        authority keys to WAN region labels for the aggregation overlay's
        region-aware tree (consensus/overlay.py); only consulted when
        Parameters.aggregation_overlay is on. `agg_signer` is this
        node's aggregate-scheme signing handle (crypto/aggsig.AggSigner);
        required — together with Parameters.aggregate_certs — for the
        node to EMIT aggregate votes/timeouts (§5.5o); inbound aggregate
        certificates are understood regardless. `proof_registry`
        (proofs/registry.py) receives every committed block with its
        certifying certificate, feeding the commit-proof serving plane
        (§5.5q).

        `Parameters.region_aware_election` selects `RegionAwareElector`
        over `overlay_regions` (consensus/leader.py); with no map, as in a
        node process, its schedule is round-robin."""
        # NOTE: boot-time config echo; parsed by the benchmark harness.
        parameters.log(log)

        if core_channel is None:
            core_channel = channel()
        network_tx = channel()

        epochs = epoch_manager if epoch_manager is not None else as_manager(committee)
        address = committee.address(name) or listen_address
        assert address is not None, (
            "node must be in the committee or supply listen_address"
        )
        NetReceiver(
            ("0.0.0.0", address[1]),
            core_channel,
            decode=decode_consensus_message,
            name="consensus-receiver",
        )
        NetSender(network_tx, name="consensus-sender")

        # Elector seam: region-aware placement reads the SAME region map
        # the aggregation overlay trees by, so the vote-plane collector
        # (rooted at get_leader(round+1)) and the leader co-locate.
        leader_elector = (
            RegionAwareElector(epochs, region_of=overlay_regions)
            if parameters.region_aware_election
            else LeaderElector(epochs)
        )
        mempool_driver = MempoolDriver(mempool_channel)
        synchronizer = Synchronizer(
            name,
            epochs,
            store,
            network_tx,
            core_channel,
            parameters.sync_retry_delay,
        )
        core = Core(
            name,
            epochs,
            parameters,
            signature_service,
            store,
            leader_elector,
            mempool_driver,
            synchronizer,
            core_channel,
            network_tx,
            commit_channel,
            verification_service=verification_service,
            overlay_regions=overlay_regions,
            agg_signer=agg_signer,
            proof_registry=proof_registry,
        )
        spawn(core.run(), name="consensus-core")
        log.info(
            "Consensus node %s successfully booted on %s", name.short(), address
        )
        return core
