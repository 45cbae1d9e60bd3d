"""Node composition root (reference node/src/node.rs:34-99): reads configs,
builds the store and signing actor, wires the cross-subsystem channels, and
boots Mempool then Consensus. `analyze_block` drains the commit channel (the
application layer stub the reference also has, node/src/node.rs:95-99).

The port's copy of `hotstuff_tpu/node/node.py`, its imports rewritten to
this package. The client ingress (`ingress_enabled`) and its commit-proof
registry and aggregate certificates (`aggregate_certs`) are not ported: a
parameters file that enables one of them is refused. Region-aware
election (`region_aware_election`) is accepted; a node passes no region
map, so its schedule is round-robin, as the reference's.
"""

from __future__ import annotations

import logging

from ..consensus import Consensus
from ..crypto import SignatureService
from ..mempool import Mempool
from ..store import Store
from ..utils.actors import channel
from .config import Committee, ConfigError, NodeParameters, Secret

log = logging.getLogger("hotstuff.node")


class Node:
    def __init__(
        self,
        committee_path: str,
        key_path: str,
        store_path: str,
        parameters_path: str | None = None,
    ) -> None:
        self.committee = Committee.read(committee_path)
        self.secret = Secret.read(key_path)
        self.parameters = (
            NodeParameters.read(parameters_path)
            if parameters_path
            else NodeParameters.default()
        )
        if self.parameters.mempool.ingress_enabled:
            raise ConfigError("ingress_enabled is not ported (the ingress server and commit proofs)")
        if self.parameters.consensus.aggregate_certs:
            raise ConfigError("aggregate_certs is not ported")
        self.store_path = store_path
        self.commit_channel = channel()
        # Set by boot(): the node's shared BatchVerificationService.
        self.verification_service = None
        # The node's epoch view (consensus/reconfig.py): committed
        # committee changes apply here, re-registering the device-resident
        # committee tables at every switch (register_backend=True).
        from ..consensus.reconfig import EpochManager

        self.epoch_manager = EpochManager(self.committee.consensus)

    def boot(self) -> None:
        """Must run inside an event loop (actors spawn on construction)."""
        name = self.secret.name
        self.register_committee()
        store = Store(self.store_path)
        signature_service = SignatureService(self.secret.secret)
        # One verification service per node: consensus QC/TC/vote checks and
        # mempool payload/synthetic batches coalesce into shared backend
        # dispatches (the async seam of crypto/src/lib.rs:226-252 generalised
        # to verification).
        from ..crypto.batch_service import BatchVerificationService

        verification_service = BatchVerificationService()
        self.verification_service = verification_service
        consensus_mempool_channel = channel()
        consensus_core_channel = channel()

        Mempool.run(
            name,
            self.committee.mempool,
            self.parameters.mempool,
            store,
            signature_service,
            consensus_mempool_channel,
            consensus_core_channel,
            verification_service=verification_service,
            # The SAME epoch view consensus applies committed changes to:
            # payload gossip fan-out, sync and address resolution cross
            # an epoch boundary at the same activation round (§5.5j).
            epoch_manager=self.epoch_manager,
        )
        Consensus.run(
            name,
            self.committee.consensus,
            self.parameters.consensus,
            store,
            signature_service,
            consensus_mempool_channel,
            self.commit_channel,
            core_channel=consensus_core_channel,
            verification_service=verification_service,
            epoch_manager=self.epoch_manager,
        )
        log.info("Node %s successfully booted", name.short())

    def register_committee(self, warmup: bool = False) -> None:
        """Install the consensus committee's validator keys as device-
        resident verification precompute on the active crypto backend
        (TorchBackend.register_committee). Idempotent; call again after an
        epoch reconfiguration — a changed key set rebuilds the table.
        With `warmup`, the committee kernel is compiled at every dispatch
        bucket width before returning (do this before joining consensus)."""
        from ..crypto import get_backend

        backend = get_backend()
        if hasattr(backend, "register_committee"):
            backend.register_committee(
                self.committee.consensus.sorted_keys(), warmup=warmup
            )

    async def analyze_block(self) -> None:
        """Application layer: drain committed blocks (node/src/node.rs:95-99)."""
        while True:
            _block = await self.commit_channel.get()
            # Here the application would execute the ordered transactions.
