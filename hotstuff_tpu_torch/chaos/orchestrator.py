"""Chaos orchestrator: boots REAL in-process consensus nodes under the
FaultyTransport, executes a FaultPlan's crash/restart windows against
their persisted stores, and streams every commit through the invariant
checkers.

Determinism contract: run on a VirtualTimeLoop (chaos/vtime.py) with the
PurePythonBackend and inline verification — then a scenario is a pure
function of (scenario definition, seed): identical fault trace, identical
honest commit sequences, replayable bit-for-bit from a failing seed.

Each node's construction happens inside a SpawnScope with the chaos
NODE_LABEL set, so (a) the transport can attribute outbound frames to the
node and (b) a crash is one scope.cancel() of the node's transitive task
tree — per-peer senders, sync waiters, verification flush loops and all —
followed by closing its store. A restart reboots the same subsystems
against the store file the crashed incarnation persisted, which is
exactly the double-vote-after-crash surface the persisted safety state
exists to protect.

The port's copy of `hotstuff_tpu/chaos/orchestrator.py`. Like the
reference's, it stays on the host: `run` installs
`pysigner.PurePythonBackend` (`hotstuff_tpu/chaos/orchestrator.py:1082`)
and every node's service verifies inline, so no scenario reaches the card.
"""

from __future__ import annotations

import asyncio
import logging
import os
import tempfile
import time

from collections import deque
from dataclasses import dataclass

from ..consensus import Consensus
from ..consensus.config import Committee, Parameters
from ..consensus.mempool_driver import (
    MempoolCleanup,
    MempoolGet,
    MempoolVerify,
    PayloadStatus,
)
from ..consensus.reconfig import EpochChange, EpochManager
from ..crypto import aggsig, pysigner
from ..crypto.backend import set_backend
from ..crypto.batch_service import BatchVerificationService
from ..crypto.primitives import Digest, PublicKey, Signature
from ..crypto.scheduler import SchedulerConfig
from ..network import net
from ..store import Store
from ..utils import incidents, metrics, telemetry, tracing
from ..utils.actors import SpawnScope, channel, spawn
from .invariants import LivenessChecker, SafetyChecker
from .plan import FaultPlan, SeededRng
from .transport import NODE_LABEL, FaultyTransport

log = logging.getLogger("hotstuff.chaos")

_M_CRASHES = metrics.counter("chaos.crashes")
_M_RESTARTS = metrics.counter("chaos.restarts")
_M_LATE_BOOTS = metrics.counter("chaos.late_boots")

BASE_PORT = 25_000  # virtual — the transport keys on port, nothing binds
# Synthetic payload-plane ports for EpochChange members (the chaos plane
# orders digests from a deterministic mock, so nothing binds these
# either — they exercise the wire format and the address registry).
MEMPOOL_BASE_PORT = 35_000


@dataclass(slots=True)
class ReconfigDirective:
    """Declarative epoch-reconfiguration for chaos scenarios: the
    orchestrator builds a signed EpochChange — successor committee =
    CURRENT committee minus `remove` plus `add` (node indices), or, in
    the committee-free form, the current committee with its `rotate`
    longest-serving members replaced by the next non-member indices
    (cyclic, a pure function of the current membership and n — the form
    matrix cells use, since it pins no node indices) — activating
    `activation_margin` rounds past the currently committed tip, and
    queues it on every running current-committee node's core; whichever
    leads next carries it through the chain (the epoch-commit rule +
    epoch-final handoff do the rest).

    Directives may be chained (a list): each waits for its `at` time AND
    for the previous boundary to be committed-past before building, so
    rolling churn paces itself off real chain progress instead of wall
    guesses. `proposer` indexes the signing authority; None picks the
    lowest-index CURRENT member (required for chained directives, where
    a fixed index may have rotated out)."""

    at: float
    add: tuple[int, ...] = ()
    remove: tuple[int, ...] = ()
    rotate: int = 0
    activation_margin: int = 10
    proposer: int | None = None


@dataclass(slots=True)
class BoundaryCrash:
    """Crash `nodes` the instant the FIRST epoch-switch event for
    `epoch` is observed (i.e. at the handoff — right as the committed
    change re-schedules the committee), restart them `down_s` virtual
    seconds later. Deterministic under the virtual clock: the first
    switch instant is a pure function of the seed. The restarted nodes
    must reload their persisted epoch-final state (schedule + pending
    handoffs) and never re-judge rounds their crashed incarnation
    certified — the quorum-crash-at-activation-boundary scenario."""

    epoch: int
    nodes: tuple[int, ...]
    down_s: float = 3.0


@dataclass(slots=True)
class BulkFlood:
    """Declarative bulk-verification flood for chaos scenarios: the
    orchestrator drives `rate` groups/s of `group_size` signatures per
    target node straight into that node's BatchVerificationService on the
    scheduler's given `source` lane, while consensus runs its critical
    groups through the same scheduler.

    Groups draw cyclically from a small per-node pool of pre-signed
    pysigner triples with dedup=True: after the first pass the
    VerifiedSigCache absorbs the backend cost (bounded WALL time — the
    pure verifier costs ~20 ms/sig), while the scheduler's
    `pace_s_per_sig` occupancy model still charges full VIRTUAL device
    time per dispatched signature — which is what makes bulk queueing,
    and therefore critical-lane preemption, observable under the virtual
    clock."""

    rate: float  # groups per virtual second per target node
    group_size: int = 16
    duration: float = 8.0
    t_start: float = 0.0
    pool: int = 8  # distinct pre-signed triples per node
    source: str = "mempool"
    targets: tuple[int, ...] | None = None  # node indices; None = all honest


class DeterministicMempool:
    """MockMempool with a per-node seeded stream: answers Get with one
    deterministic payload digest, Verify with ACCEPT (the consensus plane
    under test orders digests; payload dissemination has its own tests).

    With a `pending` deque wired (the proof-plane scenarios), admitted
    ingress transaction digests are served AS the payload digest instead
    of a random one — the chaos analogue of the real PayloadMaker path,
    where the digest a client can later prove commitment of actually
    rides a block. One digest per Get, mirroring the baseline shape (and
    keeping CommitProofs at the single-payload ~300 B pin)."""

    def __init__(self, rng, pending: deque | None = None) -> None:
        self.channel = channel()
        self._rng = rng
        self._pending = pending

    def start(self) -> None:
        spawn(self._run(), name="chaos-mempool")

    async def _run(self) -> None:
        while True:
            msg = await self.channel.get()
            if isinstance(msg, MempoolGet):
                if self._pending:
                    msg.reply.set_result([self._pending.popleft()])
                else:
                    msg.reply.set_result([Digest(self._rng.randbytes(32))])
            elif isinstance(msg, MempoolVerify):
                msg.reply.set_result(PayloadStatus.ACCEPT)
            elif isinstance(msg, MempoolCleanup):
                pass


class _NodeHandle:
    __slots__ = (
        "index", "pk", "seed", "store_path", "scope", "store", "service",
        "policy", "running", "core", "epochs", "proof_registry",
        "proof_service",
    )

    def __init__(self, index: int, pk: PublicKey, seed: bytes, store_path: str | None):
        self.index = index
        self.pk = pk
        self.seed = seed
        self.store_path = store_path
        self.scope: SpawnScope | None = None
        self.store: Store | None = None
        self.service: BatchVerificationService | None = None
        self.policy = None
        self.running = False
        self.core = None  # consensus Core (reconfig directives target it)
        self.epochs: EpochManager | None = None  # this incarnation's view
        self.proof_registry = None  # proofs.ProofRegistry (proofs runs)
        self.proof_service = None  # proofs.ProofService over the registry


class ChaosOrchestrator:
    def __init__(
        self,
        seed: int,
        n: int = 4,
        plan: FaultPlan | None = None,
        byzantine: dict[int, object] | None = None,
        parameters: Parameters | None = None,
        store_dir: str | None = None,
        ingress=None,  # ingress.loadgen.IngressLoad | None
        flood: BulkFlood | None = None,
        scheduler_config: SchedulerConfig | None = None,
        telemetry_config: "telemetry.TelemetryConfig | None" = None,
        committee_indices: list[int] | None = None,
        reconfig: "ReconfigDirective | list[ReconfigDirective] | None" = None,
        boundary_crashes: "list[BoundaryCrash] | None" = None,
        trusted_crypto: bool = False,
        proofs: bool = False,
        proof_squat_rate: float = 0.0,
        burn_budget: dict[str, float] | None = None,
    ) -> None:
        self.rng = SeededRng(seed)
        self.seed = seed
        self.n = n
        self.plan = plan or FaultPlan()
        self.byzantine = byzantine or {}  # index -> policy factory
        self.parameters = parameters or Parameters(
            timeout_delay=1_000, sync_retry_delay=1_000
        )
        # Trusted-crypto mode (chaos/trusted_crypto.py): keyed-hash stub
        # signatures behind the pysigner scheme seam, installed for the
        # run's duration in run(). Keys must come from the SAME scheme the
        # run will verify under, so derive them through the instance here.
        self.crypto_scheme = None
        if trusted_crypto:
            from .trusted_crypto import TrustedCryptoScheme

            self.crypto_scheme = TrustedCryptoScheme()
        _keypair = (
            self.crypto_scheme.keypair_from_seed
            if self.crypto_scheme is not None
            else pysigner.keypair_from_seed
        )

        key_stream = self.rng.stream("keys")
        pairs = [_keypair(key_stream.randbytes(32)) for _ in range(n)]
        # Node index = sorted-key order, matching LeaderElector rotation.
        pairs.sort(key=lambda kp: kp[0])
        self.keys = [(PublicKey(pk), seed_) for pk, seed_ in pairs]
        # The GENESIS committee may cover only a subset of the booted
        # nodes (committee_indices): a node outside it is a candidate
        # validator, running the full stack but receiving nothing until a
        # committed EpochChange admits it (the join scenario).
        self.committee_indices = (
            list(committee_indices) if committee_indices is not None else list(range(n))
        )
        self.committee = Committee.new(
            [
                (self.keys[i][0], 1, ("127.0.0.1", BASE_PORT + i))
                for i in self.committee_indices
            ]
        )
        # Aggregate-certificate plane (§5.5o): when the run's Parameters
        # opt into aggregate_certs, every node gets an aggregate signing
        # identity derived from its own key seed — the trusted-agg stub
        # in trusted_crypto fleets, exact BLS otherwise — and the
        # identity -> aggregate-pk registry (the proof-of-possession
        # boundary certificates resolve bitmap members through) covers
        # the whole fleet. Installed for the run's duration in run().
        self.agg_scheme = None
        self.agg_registry: dict[bytes, bytes] | None = None
        if self.parameters.aggregate_certs:
            if trusted_crypto:
                from .trusted_crypto import TrustedAggScheme

                self.agg_scheme = TrustedAggScheme()
            else:
                self.agg_scheme = aggsig.exact_scheme()
            self.agg_registry = {
                pk.data: self.agg_scheme.keypair_from_seed(seed_)[0]
                for pk, seed_ in self.keys
            }
        if reconfig is None:
            self.reconfigs: list[ReconfigDirective] = []
        elif isinstance(reconfig, ReconfigDirective):
            self.reconfigs = [reconfig]
        else:
            self.reconfigs = list(reconfig)
        # Rolling-churn bookkeeping: the membership (and epoch) the NEXT
        # directive builds its successor from — advanced as each change
        # is injected, so chained directives compose.
        self._committee_now: list[int] = list(self.committee_indices)
        self._epoch_now = 1
        self._index_of = {pk: i for i, (pk, _s) in enumerate(self.keys)}
        self.boundary_crashes = list(boundary_crashes or [])
        self._bc_fired: set[int] = set()
        self._bc_queue: asyncio.Queue = channel()
        # Persistent stores whenever ANY restart can happen — plan crash
        # windows or epoch-boundary crashes (a boundary-crashed node
        # restarting against an empty in-memory store would re-commit
        # from genesis, exactly the corruption persistence prevents).
        self._own_store_dir = store_dir is None and (
            bool(self.plan.crashes) or bool(boundary_crashes)
        )
        if self._own_store_dir:
            store_dir = tempfile.mkdtemp(prefix="chaos-store-")
        self.store_dir = store_dir

        # Port routing covers EVERY booted node, committee member or not
        # (a map derived from the genesis committee would leave a joining
        # node's port unrouted and its catch-up traffic undeliverable).
        self.transport = FaultyTransport(
            self.plan, self.rng, {BASE_PORT + i: i for i in range(n)}
        )
        # WAN region labels for the aggregation overlay's region-aware
        # tree (consensus/overlay.py) AND the region-aware elector
        # (consensus/leader.py §5.5p): the SAME seed-derived map the
        # transport charges latency by, so the tree's intra-region edges
        # really are the cheap ones. Built once — it is invariant for
        # the run (every boot/restart shares it).
        self.overlay_regions = (
            {
                self.keys[j][0]: region
                for j, region in enumerate(self.transport.regions)
            }
            if self.transport.regions
            else None
        )
        # The checker gets the frozen region map + elector mode so its
        # election audit derives the schedule INDEPENDENTLY per round.
        self.safety = SafetyChecker(
            self.committee,
            region_of=self.overlay_regions,
            region_aware=self.parameters.region_aware_election,
        )
        self.liveness = LivenessChecker()
        self.honest = [i for i in range(n) if i not in self.byzantine]
        self.ingress = ingress
        self.ingress_drivers: list[tuple[int, object]] = []  # (node, loadgen)
        self.flood = flood
        self.flood_stats: dict[int, dict] = {}  # node -> driver counters
        # Commit-proof serving plane (§5.5q): with proofs=True every node
        # boots a ProofRegistry wired into its Core, admitted ingress tx
        # digests feed the target's DeterministicMempool (so accepted
        # transactions really ride blocks), and one proof-tracking client
        # per admitted tx subscribes-until-commit and STATELESSLY verifies
        # the served CommitProof against the genesis committee. The
        # pending-digest deques outlive node incarnations (external load
        # keeps queuing at a crashed node, like the ingress drivers).
        self.proofs_enabled = bool(proofs)
        self.proof_squat_rate = float(proof_squat_rate)
        self._proof_pending: dict[int, deque] = {
            i: deque(maxlen=8_192) for i in range(n)
        }
        self.proof_stats: dict[int, dict] = {}
        self.squat_stats: dict[int, dict] = {}
        # (client, nonce, tx digest) per tracked admission — the source of
        # truth the end-of-run provability audit replays against the
        # registry (unproved_committed must come out zero).
        self._proof_tracked: dict[int, list] = {}
        # Certificate-verification dedup: proofs from one committed block
        # share one cert; crypto-verify it once, re-check only the cheap
        # digest binding per proof (bounds exact-BLS wall cost).
        self._verified_certs: set[tuple[bytes, int]] = set()
        # Per-node scheduler knobs (e.g. the virtual device-occupancy pace
        # the bulk_flood_priority scenario needs); None = defaults.
        self.scheduler_config = scheduler_config
        # Live telemetry plane (utils/telemetry.py): one per node when a
        # config is given — delta snapshots on the virtual clock + SLO
        # burn-rate alerts, embedded per node in the report.
        self.telemetry_config = telemetry_config
        self.telemetry_planes: dict[int, telemetry.TelemetryPlane] = {}
        # Scenario-declared per-SLO burn budget (seconds-in-violation the
        # run may spend per SLO row) — judged by the incident ledger's
        # health block in _report (utils/incidents.py).
        self.burn_budget = dict(burn_budget) if burn_budget else None
        self.events: list[dict] = []
        # Per-node epoch switches (EpochManager on_switch hook) — the
        # report section the reconfig expectations judge.
        self.epoch_events: dict[int, list[dict]] = {}
        self._deferred_boots = {b.node for b in self.plan.boots}
        self.nodes = [
            _NodeHandle(
                i,
                pk,
                seed_,
                os.path.join(store_dir, f"node-{i}.log") if store_dir else None,
            )
            for i, (pk, seed_) in enumerate(self.keys)
        ]

    # -- node lifecycle ------------------------------------------------------

    def _on_epoch_switch(self, i: int):
        def hook(committee: Committee, activation_round: int) -> None:
            t = round(asyncio.get_running_loop().time(), 6)
            entry = {
                "t": t,
                "epoch": committee.epoch,
                "activation_round": activation_round,
                "committee_size": committee.size(),
                # Node indices of the epoch's membership: what the churn
                # expectations judge full rotation by.
                "members": sorted(
                    self._index_of[pk] for pk in committee.sorted_keys()
                ),
            }
            self.epoch_events.setdefault(i, []).append(entry)
            self.events.append(
                {"t": t, "event": "epoch_switch", "node": i, **{
                    k: entry[k] for k in ("epoch", "activation_round")
                }}
            )
            # Boundary crashes arm off the FIRST switch event for their
            # epoch. Executed by the run-scope watcher, never inline:
            # this hook runs inside the switching node's own task tree,
            # and crashing from there would cancel the crasher itself.
            # Fired-set keys on the DIRECTIVE, not the epoch: a scenario
            # may stagger several crash groups at one boundary.
            for j, bc in enumerate(self.boundary_crashes):
                if bc.epoch == committee.epoch and j not in self._bc_fired:
                    self._bc_fired.add(j)
                    self._bc_queue.put_nowait(bc)

        return hook

    async def _boundary_crash_watcher(self) -> None:
        while True:
            bc = await self._bc_queue.get()
            log.info(
                "chaos: boundary crash at epoch %s — taking down nodes %s "
                "for %.1fs",
                bc.epoch,
                list(bc.nodes),
                bc.down_s,
            )
            for j in bc.nodes:
                await self.crash(j)
            await asyncio.sleep(bc.down_s)
            for j in bc.nodes:
                await self.restart(j)

    def _boot(self, i: int) -> None:
        node = self.nodes[i]
        token = NODE_LABEL.set(i)
        # The flight recorder attributes events per node the same way the
        # transport attributes frames: a contextvar inherited by every
        # task the node's construction spawns.
        trace_token = tracing.NODE_LABEL.set(i)
        scope = SpawnScope(f"chaos-node-{i}")
        try:
            with scope:
                node.store = Store(node.store_path)
                sig_service = pysigner.PySignatureService(node.seed)
                mempool = DeterministicMempool(
                    self.rng.stream(f"mempool:{i}"),
                    pending=(
                        self._proof_pending[i] if self.proofs_enabled else None
                    ),
                )
                mempool.start()
                if self.proofs_enabled:
                    # Fresh registry per incarnation against the node's
                    # persisted store: a restart reloads the newest proof
                    # window exactly like a real node boot. The service
                    # wrapper is re-resolved through the handle by the
                    # run-scope proof clients, so they survive restarts.
                    from ..proofs import ProofRegistry, ProofService

                    node.proof_registry = ProofRegistry(store=node.store)
                    node.proof_service = ProofService(node.proof_registry)
                    spawn(
                        node.proof_registry.load(),
                        name=f"chaos-proof-load-{i}",
                    )
                node.service = BatchVerificationService(
                    inline=True, scheduler_config=self.scheduler_config
                )
                # Per-incarnation epoch view: a restart rebuilds committed
                # boundaries from the persisted store (Core.run loads it).
                # register_backend stays on — the PurePythonBackend has no
                # committee tables, so the hook is a no-op here while the
                # switch events still record per node.
                node.epochs = EpochManager(
                    self.committee, on_switch=self._on_epoch_switch(i)
                )
                commit_channel = channel()
                node.core = Consensus.run(
                    node.pk,
                    self.committee,
                    self.parameters,
                    node.store,
                    sig_service,
                    mempool.channel,
                    commit_channel,
                    verification_service=node.service,
                    epoch_manager=node.epochs,
                    listen_address=("127.0.0.1", BASE_PORT + i),
                    overlay_regions=self.overlay_regions,
                    agg_signer=(
                        aggsig.AggSigner(node.seed, self.agg_scheme)
                        if self.agg_scheme is not None
                        else None
                    ),
                    proof_registry=node.proof_registry,
                )
                spawn(self._drain(i, commit_channel), name=f"chaos-drain-{i}")
        finally:
            NODE_LABEL.reset(token)
            tracing.NODE_LABEL.reset(trace_token)
        node.scope = scope
        node.running = True
        policy_factory = self.byzantine.get(i)
        if policy_factory is not None:
            policy = policy_factory(
                i, node.seed, self.committee, self.rng.stream(f"byzantine:{i}")
            )
            self.transport.set_policy(i, policy)
            node.policy = policy

    def _boot_ingress(self) -> None:
        """One in-process IngressPipeline + open-loop generator per target
        node, wired to that node's BatchVerificationService — ingress
        signatures ride the REAL verify path while consensus runs. The
        generators draw from per-node seeded streams, so the traffic (and
        therefore the whole run) replays bit-for-bit. Drivers live in the
        run scope, not the node scopes: this models external clients, who
        keep firing at a crashed node (submissions fail, not the run)."""
        from ..ingress.loadgen import OpenLoopLoadGen
        from ..ingress.pipeline import IngressPipeline

        targets = (
            list(self.ingress.targets)
            if self.ingress.targets is not None
            else list(self.honest)
        )
        for i in targets:
            node = self.nodes[i]
            trace_token = tracing.NODE_LABEL.set(i)
            try:
                # Sink stands in for the mempool tx queue (the chaos plane
                # orders DeterministicMempool digests, so verified client
                # bodies terminate here); bounded like the real one.
                sink: asyncio.Queue = channel(10_000)
                spawn(self._drain_ingress(sink), name=f"chaos-ingress-sink-{i}")
                pipeline = IngressPipeline(
                    node.service, sink, config=self.ingress.config()
                )
                submit = pipeline.submit
                if self.proofs_enabled:
                    # Close the submit → commit → proof loop: every
                    # ACCEPTED response also feeds the tx digest to this
                    # node's DeterministicMempool and spawns a proof-
                    # tracking client (run scope — external observers).
                    self.proof_stats[i] = {
                        "tracked": 0,
                        "served": 0,
                        "verified_ok": 0,
                        "verify_failed": 0,
                        "retries": 0,
                        "proof_bytes_max": 0,
                        "latencies_s": [],
                    }
                    self._proof_tracked[i] = []
                    submit = self._wrap_proof_submit(i, pipeline.submit)
                gen = OpenLoopLoadGen(
                    submit,
                    curve=self.ingress.curve,
                    duration=self.ingress.duration,
                    clients=self.ingress.clients,
                    tx_bytes=self.ingress.tx_bytes,
                    rng=self.rng.stream(f"ingress:{i}"),
                    label=f"ingress-{i}",
                )
                spawn(gen.run(), name=f"chaos-ingress-{i}")
            finally:
                tracing.NODE_LABEL.reset(trace_token)
            self.ingress_drivers.append((i, gen))

    async def _drain_ingress(self, sink: asyncio.Queue) -> None:
        while True:
            await sink.get()

    # -- commit-proof serving plane (§5.5q) ----------------------------------

    def _wrap_proof_submit(self, i: int, submit):
        """Decorate a pipeline's submit: ACCEPTED admissions enter the
        proof loop — registry note, payload-digest feed, tracking client."""
        from ..ingress import messages as ingress_messages

        async def wrapped(tx):
            resp = await submit(tx)
            if resp.status == ingress_messages.ACCEPTED:
                self._on_proof_admit(i, tx)
            return resp

        return wrapped

    def _on_proof_admit(self, i: int, tx) -> None:
        node = self.nodes[i]
        digest = tx.digest()
        if node.proof_registry is not None:
            node.proof_registry.note_tx(tx.client, tx.nonce, digest)
        # The digest rides the node's next proposal (DeterministicMempool
        # serves the pending deque before its random stream) — the chaos
        # analogue of PayloadMaker flushing admitted bodies into a batch.
        self._proof_pending[i].append(digest)
        stats = self.proof_stats[i]
        stats["tracked"] += 1
        self._proof_tracked[i].append((tx.client, tx.nonce, digest))
        spawn(
            self._track_proof(
                i, tx.client, tx.nonce, digest,
                asyncio.get_running_loop().time(),
            ),
            name=f"chaos-proof-track-{i}-{stats['tracked']}",
        )

    async def _track_proof(self, i, client, nonce, digest, t0) -> None:
        """One proof-tracking client per admitted tx: subscribe-until-
        commit against the serving node, honor shed/pending retry hints,
        then verify the served CommitProof STATELESSLY — wire round-trip
        included — against the genesis committee's public keys."""
        from ..proofs import (
            MODE_SUBSCRIBE,
            PROOF_OK,
            ProofQuery,
            decode_proof_message,
            encode_proof_message,
        )

        stats = self.proof_stats[i]
        loop = asyncio.get_running_loop()
        while True:
            node = self.nodes[i]
            service = node.proof_service
            if not node.running or service is None:
                await asyncio.sleep(0.25)
                continue
            # Re-assert the admission with the CURRENT incarnation's
            # registry: a restart rebuilt it from the persisted proof
            # window, and the (client, nonce) -> digest row is client-
            # session state, not chain state.
            node.proof_registry.note_tx(client, nonce, digest)
            query = ProofQuery(client, nonce, MODE_SUBSCRIBE)
            try:
                reply = await asyncio.wait_for(
                    service.handle(query, loop.time()), timeout=3.0
                )
            except asyncio.TimeoutError:
                # Parked past the patience window (e.g. the node crashed
                # under us): wait_for cancelled the subscription — which
                # released its waiter slot — so just resubscribe.
                stats["retries"] += 1
                continue
            if reply.status == PROOF_OK:
                break
            stats["retries"] += 1
            await asyncio.sleep(max(reply.retry_after_ms, 50) / 1000.0)
        # The client's view of the wire: encode the reply envelope, decode
        # it back, and verify the DECODED proof — the in-process chaos run
        # exercises the exact byte path a TCP client would see.
        reply = decode_proof_message(encode_proof_message(reply))
        proof = reply.proof
        stats["served"] += 1
        stats["latencies_s"].append(loop.time() - t0)
        stats["proof_bytes_max"] = max(
            stats["proof_bytes_max"], proof.encoded_size()
        )
        if self._verify_proof(proof, digest):
            stats["verified_ok"] += 1
        else:
            stats["verify_failed"] += 1

    def _verify_proof(self, proof, payload_digest) -> bool:
        """Stateless client verification with per-block cert dedup: all
        proofs from one committed block share one certificate, so the
        quorum crypto is checked once per block and every proof after
        that re-runs only the digest-binding + membership checks (bounds
        exact-BLS wall cost without weakening any individual proof)."""
        from ..proofs import ProofVerificationError

        key = (proof.cert.hash.data, proof.cert.round)
        try:
            if key in self._verified_certs:
                if proof.cert.hash != proof.block_digest():
                    return False
                if proof.cert.round != proof.round:
                    return False
                return payload_digest in proof.payload
            proof.verify(self.committee, payload_digest=payload_digest)
        except (ProofVerificationError, ValueError, KeyError):
            return False
        if len(self._verified_certs) >= 65_536:
            self._verified_certs.clear()
        self._verified_certs.add(key)
        return True

    def _boot_proof_squatters(self) -> None:
        """Byzantine nonce-squatting clients: subscribe for (client,
        nonce) pairs that were NEVER admitted, at `proof_squat_rate`
        queries/s per target. The server must shed every one with a retry
        hint and allocate NOTHING — the bounded-registry pin."""
        targets = (
            list(self.ingress.targets)
            if self.ingress is not None and self.ingress.targets is not None
            else list(self.honest)
        )
        for i in targets:
            stats = {"sent": 0, "shed": 0, "other": 0}
            self.squat_stats[i] = stats
            spawn(
                self._squat_node(i, self.rng.stream(f"proof-squat:{i}"), stats),
                name=f"chaos-proof-squat-{i}",
            )

    async def _squat_node(self, i: int, rng, stats: dict) -> None:
        from ..proofs import MODE_SUBSCRIBE, PROOF_SHED, ProofQuery

        loop = asyncio.get_running_loop()
        interval = 1.0 / self.proof_squat_rate
        while True:
            node = self.nodes[i]
            service = node.proof_service
            if node.running and service is not None:
                client = PublicKey(rng.randbytes(32))
                nonce = int.from_bytes(rng.randbytes(5), "little")
                stats["sent"] += 1
                try:
                    reply = await asyncio.wait_for(
                        service.handle(
                            ProofQuery(client, nonce, MODE_SUBSCRIBE),
                            loop.time(),
                        ),
                        timeout=3.0,
                    )
                    if reply.status == PROOF_SHED:
                        stats["shed"] += 1
                    else:
                        stats["other"] += 1
                except asyncio.TimeoutError:
                    stats["other"] += 1
            await asyncio.sleep(interval)

    def _proof_summary(self, i: int) -> dict:
        stats = self.proof_stats[i]
        node = self.nodes[i]
        registry = node.proof_registry
        # End-of-run provability audit: a tracked tx whose digest the
        # registry COMMITTED (proof_for_payload hit) but whose (client,
        # nonce) key never resolved would be an admitted-and-committed tx
        # a client cannot prove — the invariant the scenario pins to zero.
        unproved = 0
        if registry is not None:
            for client, nonce, digest in self._proof_tracked.get(i, ()):
                proof, _known = registry.proof_for_client(client, nonce)
                if proof is None and registry.proof_for_payload(digest):
                    unproved += 1
        lat_ms = [s * 1000.0 for s in stats["latencies_s"]]
        pct = metrics.percentile
        return {
            "tracked": stats["tracked"],
            "served": stats["served"],
            "verified_ok": stats["verified_ok"],
            "verify_failed": stats["verify_failed"],
            "retries": stats["retries"],
            "pending": stats["tracked"] - stats["served"],
            "unproved_committed": unproved,
            "proof_bytes_max": stats["proof_bytes_max"],
            "registry_size": registry.size() if registry is not None else 0,
            "latency_ms": {
                "count": len(lat_ms),
                "p50": round(pct(lat_ms, 0.50), 3),
                "p99": round(pct(lat_ms, 0.99), 3),
                "max": round(max(lat_ms), 3) if lat_ms else 0.0,
            },
        }

    def _boot_telemetry(self, loop) -> None:
        """One TelemetryPlane per node on the VIRTUAL clock. Planes live
        in the run scope (an external observer keeps scraping a crashed
        node) and re-resolve the node's LaneStats through the handle, so
        a restart's fresh BatchVerificationService is picked up. Per-node
        LaneStats keep the lane SLO evaluation per node even though the
        metrics registry is process-global here."""
        for i in range(self.n):
            node = self.nodes[i]
            plane = telemetry.TelemetryPlane(
                label=i,
                config=self.telemetry_config,
                lane_stats=lambda node=node: (
                    node.service.lane_stats if node.service else None
                ),
                peers_fn=lambda i=i: self._peer_view(i),
                clock=loop.time,
            )
            plane.attach_watchdog()
            self.telemetry_planes[i] = plane
            spawn(plane.run(), name=f"chaos-telemetry-{i}")

    def _boot_flood(self) -> None:
        """One open-loop bulk-verification driver per target node (see
        BulkFlood). Drivers live in the run scope like the ingress
        generators — external load keeps firing at a crashed node
        (submissions are skipped, not the run)."""
        targets = (
            list(self.flood.targets)
            if self.flood.targets is not None
            else list(self.honest)
        )
        for i in targets:
            stats = {"submitted": 0, "completed": 0, "verified": 0, "errors": 0}
            self.flood_stats[i] = stats
            spawn(
                self._flood_node(i, self.rng.stream(f"flood:{i}"), stats),
                name=f"chaos-flood-{i}",
            )

    async def _flood_node(self, i: int, rng, stats: dict) -> None:
        flood = self.flood
        # Pre-signed pool (wall-time bound: pool * ~20 ms pysigner signs);
        # groups cycle it with dedup=True so only the first pass pays the
        # backend while every dispatch pays virtual device occupancy.
        pool = []
        for _ in range(flood.pool):
            pk, seed = pysigner.keypair_from_seed(rng.randbytes(32))
            msg = rng.randbytes(32)
            pool.append((msg, PublicKey(pk), Signature(pysigner.sign(seed, msg))))
        loop = asyncio.get_running_loop()
        start = loop.time() + flood.t_start
        if flood.t_start > 0:
            await asyncio.sleep(flood.t_start)
        end = start + flood.duration
        interval = 1.0 / flood.rate
        cursor = 0
        while loop.time() < end:
            node = self.nodes[i]
            if node.running and node.service is not None:
                msgs, pairs = [], []
                for _ in range(flood.group_size):
                    m, pk, sig = pool[cursor % len(pool)]
                    cursor += 1
                    msgs.append(m)
                    pairs.append((pk, sig))
                stats["submitted"] += 1
                spawn(
                    self._flood_submit(node.service, msgs, pairs, stats),
                    name=f"chaos-flood-submit-{i}",
                )
            await asyncio.sleep(interval)

    async def _flood_submit(self, service, msgs, pairs, stats: dict) -> None:
        try:
            mask = await service.verify_group(
                msgs, pairs, source=self.flood.source, dedup=True
            )
        except Exception:
            stats["errors"] += 1
        else:
            stats["completed"] += 1
            stats["verified"] += sum(bool(ok) for ok in mask)

    def _peer_view(self, i: int) -> dict:
        """Node i's per-peer observatory snapshot (network/net.py ledger)
        re-keyed from transport addresses to node indices — the chaos
        port map is BASE_PORT + index, so reports and telemetry dumps
        speak node labels like every other section."""
        out = {}
        for key, snap in net.peer_snapshot(i).items():
            _, _, port = key.rpartition(":")
            out[str(int(port) - BASE_PORT)] = snap
        return out

    async def _drain(self, i: int, commit_channel: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        while True:
            block = await commit_channel.get()
            self.safety.on_commit(i, block)
            self.liveness.on_commit(i, block, loop.time())

    async def crash(self, i: int) -> None:
        node = self.nodes[i]
        if not node.running:
            return
        _M_CRASHES.inc()
        self.events.append(
            {"t": round(asyncio.get_running_loop().time(), 6), "event": "crash", "node": i}
        )
        tracing.RECORDER.record("chaos.crash", None, None, None, label=i)
        log.info("chaos: crashing node %d", i)
        tasks = node.scope.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if node.store is not None:
            node.store.close()
        node.running = False

    async def restart(self, i: int) -> None:
        node = self.nodes[i]
        if node.running:
            return
        _M_RESTARTS.inc()
        self.events.append(
            {"t": round(asyncio.get_running_loop().time(), 6), "event": "restart", "node": i}
        )
        tracing.RECORDER.record("chaos.restart", None, None, None, label=i)
        log.info("chaos: restarting node %d against %s", i, node.store_path)
        self._boot(i)

    async def boot_late(self, i: int) -> None:
        """First-time boot of a plan.boots node: empty store, live chain —
        the genesis catch-up shape."""
        node = self.nodes[i]
        if node.running:
            return
        _M_LATE_BOOTS.inc()
        self.events.append(
            {"t": round(asyncio.get_running_loop().time(), 6), "event": "boot", "node": i}
        )
        tracing.RECORDER.record("chaos.restart", None, None, None, label=i)
        log.info("chaos: late-booting node %d with an empty store", i)
        self._boot(i)

    async def _lifecycle(self) -> None:
        """Execute the plan's crash/restart/boot windows on the virtual
        clock."""
        loop = asyncio.get_running_loop()
        start = loop.time()
        steps: list[tuple[float, str, int]] = []
        for w in self.plan.crashes:
            steps.append((w.at, "crash", w.node))
            if w.restart is not None:
                steps.append((w.restart, "restart", w.node))
        for b in self.plan.boots:
            steps.append((b.at, "boot", b.node))
        for at, action, who in sorted(steps):
            delay = start + at - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            if action == "crash":
                await self.crash(who)
            elif action == "boot":
                await self.boot_late(who)
            else:
                await self.restart(who)

    def _committed_tip(self) -> int:
        return max(
            (
                r
                for commits in self.safety.commits.values()
                for r, _digest in commits
            ),
            default=0,
        )

    def _successor_indices(self, d: ReconfigDirective) -> list[int]:
        """The next committee as node indices. `rotate` is committee-free:
        drop the k longest-serving members (list-order head) and admit
        the next k non-member indices cyclically after the current
        maximum — a pure function of (current membership, n), so matrix
        cells can run it at any committee size."""
        current = list(self._committee_now)
        if d.rotate:
            # Clamp to the candidate pool: rotating more members than
            # there are non-members to admit would spin the join picker.
            k = min(d.rotate, len(current), self.n - len(current))
            if k <= 0:
                return current
            survivors = current[k:]
            joins: list[int] = []
            cursor = (max(current) + 1) % self.n
            while len(joins) < k:
                if cursor not in current and cursor not in joins:
                    joins.append(cursor)
                cursor = (cursor + 1) % self.n
            return survivors + joins
        return [i for i in current if i not in d.remove] + [
            i for i in d.add if i not in current
        ]

    async def _drive_reconfig(self) -> None:
        """Execute the directive chain: each directive waits for its `at`
        time AND for the previous epoch's boundary to be committed-past
        (several EpochChanges in flight would otherwise race the
        sequencing check — a carrier for epoch e+2 cannot ride a round
        the schedule still maps to epoch e), then builds the signed
        EpochChange from the CURRENT committee ± the directive's node
        sets, activating `activation_margin` rounds past the committed
        tip, and queues it on every running current-committee node
        (whoever leads next proposes it). Deterministic under the
        virtual clock: the committed tip at a virtual instant is a pure
        function of the seed."""
        loop = asyncio.get_running_loop()
        start = loop.time()
        prev_activation: int | None = None
        for d in sorted(self.reconfigs, key=lambda d: d.at):
            delay = start + d.at - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            while (
                prev_activation is not None
                and self._committed_tip() < prev_activation
            ):
                await asyncio.sleep(0.25)
            members_idx = self._successor_indices(d)
            members = [
                (
                    self.keys[i][0],
                    1,
                    ("127.0.0.1", BASE_PORT + i),
                    ("127.0.0.1", MEMPOOL_BASE_PORT + i),
                )
                for i in sorted(members_idx)
            ]
            proposer = (
                d.proposer if d.proposer is not None else min(self._committee_now)
            )
            author, seed = self.keys[proposer]
            change = EpochChange.new_from_seed(
                self._epoch_now + 1,
                self._committed_tip() + d.activation_margin,
                members,
                author,
                seed,
            )
            self.events.append(
                {
                    "t": round(loop.time(), 6),
                    "event": "reconfig_directive",
                    "epoch": change.new_epoch,
                    "activation_round": change.activation_round,
                    "members": sorted(members_idx),
                }
            )
            log.info("chaos: injecting %s", change)
            current_keys = {self.keys[i][0] for i in self._committee_now}
            for node in self.nodes:
                if (
                    node.running
                    and node.core is not None
                    and node.pk in current_keys
                ):
                    node.core.schedule_reconfig(change)
            prev_activation = change.activation_round
            # SENIORITY order, not sorted: _successor_indices drops the
            # list head as "longest-serving", so survivors must keep
            # their order and joins append at the tail — sorting here
            # would make a wrapped rotation (n=4) evict the member that
            # JUST joined and never rotate the real veterans out.
            self._committee_now = list(members_idx)
            self._epoch_now += 1

    # -- run -----------------------------------------------------------------

    def _target_met(self, min_commits: int, heal_t: float | None, start: float) -> bool:
        """Early-stop predicate: every honest node reached the commit
        floor, AND (for heal scenarios) the heal point has passed with
        every honest node's height advanced beyond its at-heal height —
        i.e. the liveness invariant is already satisfied."""
        if not min_commits:
            return False
        if not all(
            len(self.safety.commits.get(i, ())) >= min_commits
            for i in self.honest
        ):
            return False
        if heal_t is not None:
            now = asyncio.get_running_loop().time()
            if now < start + heal_t:
                return False
            for i in self.honest:
                if self.liveness.max_round(i) <= self.liveness.max_round(
                    i, up_to=start + heal_t
                ):
                    return False
        return True

    async def run(
        self,
        duration: float,
        min_commits: int = 0,
        heal_t: float | None = None,
    ) -> dict:
        """Boot every node, run the plan for `duration` VIRTUAL seconds
        (stopping early once `_target_met`), tear down, and return the
        structured report."""
        prev_backend = set_backend(pysigner.PurePythonBackend())
        prev_transport = net.install_transport(self.transport)
        # Fresh observatory ledger per run: the peer map is process-global
        # (keyed by node label), and tier-1 runs scenarios back to back in
        # one process — a stale link row would break same-seed bit-identity.
        net.reset_peers()
        # Scheme install covers EVERY pysigner path for the run — node
        # signature services, backend verification, byzantine policies,
        # EpochChange construction, the SafetyChecker audit — so a run is
        # never half-stubbed (restored in the finally with the rest).
        prev_scheme = pysigner.install_scheme(self.crypto_scheme)
        # Aggregate plane seam: scheme + key registry are process-global
        # (like the pysigner scheme), installed per run and restored with
        # it — a non-agg run installs None/empty, so a stale registry
        # from a prior run can never leak into this one's verification.
        prev_agg_scheme = aggsig.install_agg_scheme(self.agg_scheme)
        prev_agg_registry = aggsig.install_agg_registry(self.agg_registry)
        run_scope = SpawnScope("chaos-run")
        loop = asyncio.get_running_loop()
        # Flight-recorder events follow the VIRTUAL clock for this run, so
        # recorded timelines line up with the fault trace and replay
        # deterministically; a fresh ring isolates the run's dump.
        prev_clock = tracing.set_clock(loop.time)
        tracing.reset()
        self.watchdog_dumps: list[dict] = []

        def _capture(reason: str, detail: dict) -> None:
            # Anomaly-triggered dump, embedded in the report instead of a
            # file: the chaos report is the artifact of record here. The
            # watchdog context (each plane's last K telemetry snapshots)
            # rides along, same as the file-writing auto-dump hook.
            entry = {
                "t": round(loop.time(), 6),
                "reason": reason,
                "detail": detail,
                "events": tracing.RECORDER.events(limit=2_000),
            }
            ctx = tracing.WATCHDOG.context()
            if ctx:
                entry["context"] = ctx
            self.watchdog_dumps.append(entry)

        tracing.WATCHDOG.add_dump_hook(_capture)
        start = loop.time()
        try:
            with run_scope:
                for i in range(self.n):
                    if i not in self._deferred_boots:
                        self._boot(i)
                if self.ingress is not None:
                    self._boot_ingress()
                if self.proofs_enabled and self.proof_squat_rate > 0:
                    self._boot_proof_squatters()
                if self.flood is not None:
                    self._boot_flood()
                if self.telemetry_config is not None:
                    self._boot_telemetry(loop)
                if self.plan.crashes or self.plan.boots:
                    spawn(self._lifecycle(), name="chaos-lifecycle")
                if self.reconfigs:
                    spawn(self._drive_reconfig(), name="chaos-reconfig")
                if self.boundary_crashes:
                    spawn(
                        self._boundary_crash_watcher(),
                        name="chaos-boundary-crash",
                    )
                deadline = start + duration
                while loop.time() < deadline:
                    if self._target_met(min_commits, heal_t, start):
                        break
                    await asyncio.sleep(0.05)
        finally:
            for node in self.nodes:
                if node.running and node.scope is not None:
                    tasks = node.scope.cancel()
                    if tasks:
                        await asyncio.gather(*tasks, return_exceptions=True)
                    if node.store is not None:
                        node.store.close()
                    node.running = False
            stray = run_scope.cancel()
            if stray:
                await asyncio.gather(*stray, return_exceptions=True)
            net.install_transport(prev_transport)
            set_backend(prev_backend)
            pysigner.install_scheme(prev_scheme)
            aggsig.install_agg_scheme(prev_agg_scheme)
            aggsig.install_agg_registry(prev_agg_registry)
            for plane in self.telemetry_planes.values():
                plane.detach_watchdog()
            tracing.WATCHDOG.remove_dump_hook(_capture)
            tracing.set_clock(prev_clock)
            if self._own_store_dir:
                # Self-created scratch stores die with the run (a caller-
                # supplied store_dir is the caller's to keep); repeated
                # seed-bisection runs must not accumulate /tmp directories.
                import shutil

                shutil.rmtree(self.store_dir, ignore_errors=True)
        self.liveness.require_commits(self.honest, min_commits)
        return self._report(loop.time() - start)

    def _injected_windows(self) -> tuple["incidents.FaultWindow", ...]:
        """Fault windows only the orchestrator can parameterize: injected
        load spans (their shapes never land in the report's plan)."""
        windows: list[incidents.FaultWindow] = []
        if self.flood is not None:
            windows.append(
                incidents.FaultWindow(
                    "flood",
                    float(self.flood.t_start),
                    float(self.flood.t_start + self.flood.duration),
                    None,
                )
            )
        curve = getattr(self.ingress, "curve", None)
        if curve is not None and getattr(curve, "kind", None) == "flash":
            # A steady/open-loop curve is background traffic, not a
            # fault; only the flash spike is an injected disruption.
            windows.append(
                incidents.FaultWindow(
                    "ingress_spike",
                    float(curve.t_start),
                    float(curve.t_end),
                    None,
                )
            )
        return tuple(windows)

    def _report(self, elapsed: float) -> dict:
        report = {
            "seed": self.seed,
            "nodes": self.n,
            "byzantine": sorted(self.byzantine),
            "virtual_seconds": round(elapsed, 6),
            # Which signature scheme the run executed under (see
            # chaos/trusted_crypto.py for the stub's trust model) and the
            # seed-derived WAN region per node (empty without a matrix).
            "crypto_mode": (
                self.crypto_scheme.name
                if self.crypto_scheme is not None
                else "exact"
            ),
            "wan_regions": {
                str(i): region
                for i, region in enumerate(self.transport.regions)
            },
            # Per-node network observatory (per-peer link counters + RTT
            # EWMAs, node-index keyed): the canonical section scenario
            # expectations and trace_report read — present even for
            # telemetry-less runs. RTT rows appear only when the scenario
            # enabled probing (Parameters.probe_interval_ms).
            "peers": {
                str(i): self._peer_view(i) for i in range(self.n)
            },
            "plan": self.plan.to_json(),
            "events": self.events,
            "commits": {
                str(i): self.safety.commits.get(i, [])
                for i in range(self.n)
            },
            # Per-node commit instants (virtual seconds): the plateau
            # evidence ingress-overload expectations compare windows over.
            "commit_times": {
                str(i): [round(t, 6) for t in ts]
                for i, ts in self.liveness.commit_times().items()
            },
            # Per-target-node open-loop generator summaries (offered /
            # accepted / shed / retry hints / client latency percentiles).
            "ingress": {
                str(i): gen.summary() for i, gen in self.ingress_drivers
            },
            # Per-node bulk-flood driver counters (BulkFlood scenarios).
            "flood": {
                str(i): dict(stats) for i, stats in self.flood_stats.items()
            },
            # Commit-proof serving plane (§5.5q): per-target tracking-
            # client outcomes — served/verified counts, submit→proof-in-
            # hand latency percentiles, worst proof size, and the end-of-
            # run provability audit (unproved_committed must be zero).
            "proofs": {
                str(i): self._proof_summary(i)
                for i in sorted(self.proof_stats)
            },
            # Byzantine nonce-squatting drivers: every never-admitted
            # subscription must come back SHED (allocation-free).
            "proof_squat": {
                str(i): dict(stats)
                for i, stats in sorted(self.squat_stats.items())
            },
            # Per-node live-telemetry dumps (snapshot ring + SLO burn
            # alerts — utils/telemetry.py). `commits` is overwritten with
            # the per-node truth: the plane's registry view is process-
            # global here, so its own commit sum would count every node.
            # tools/telemetry_dash.py renders this section offline, and a
            # TelemetryServer can serve one node's entry verbatim — the
            # live scrape and the report then show identical numbers.
            "telemetry": {
                str(i): {
                    **plane.dump(),
                    "commits": len(self.liveness.commit_times().get(i, ())),
                }
                for i, plane in self.telemetry_planes.items()
            },
            # Per-node device-scheduler snapshots: lane depths/dispatch
            # counts and the per-lane queue-delay percentiles the
            # bulk_flood_priority expectations assert on (service-local
            # LaneStats — global histograms would bleed across the
            # scenarios one tier-1 process runs back to back).
            "scheduler": {
                str(i): node.service.scheduler.summary()
                for i, node in enumerate(self.nodes)
                if node.service is not None and node.service.scheduler is not None
            },
            # Per-node epoch switches (EpochManager on_switch): every
            # node's observed boundary, with the activation round the
            # reconfig expectations require to be unanimous.
            "epoch_switches": {
                str(i): list(events)
                for i, events in sorted(self.epoch_events.items())
            },
            "final_epochs": {
                str(i): node.epochs.applied_epoch
                for i, node in enumerate(self.nodes)
                if node.epochs is not None
            },
            "fault_trace": self.transport.trace,
            "fault_trace_overflow": self.transport.trace_overflow,
            # Explicit truncation flag (plus the chaos.fault_trace_dropped
            # counter): a capped trace must never read as a complete one.
            "fault_trace_truncated": self.transport.trace_overflow > 0,
            "safety_violations": self.safety.violations,
            "liveness_violations": self.liveness.violations,
            # Per-node flight-recorder dumps (one shared virtual-clock
            # ring, filtered by node label): the cross-node stitching
            # input for tools/trace_report.py, and the diagnosis artifact
            # a failed scenario is debugged from.
            "flight_recorders": {
                str(i): tracing.RECORDER.events(node=i, limit=4_000)
                for i in range(self.n)
            },
            # mono is the VIRTUAL clock the embedded events were stamped
            # with; wall is real time, so a chaos report can be aligned
            # against real per-node dumps like any recorder dump.
            "trace_anchor": {
                "mono": asyncio.get_running_loop().time(),
                # graftlint: allow[determinism] report metadata stamp, not replayed state
                "wall": time.time(),
            },
            "watchdog_dumps": getattr(self, "watchdog_dumps", []),
            "watchdog_triggers": list(tracing.WATCHDOG.triggers),
            "ok": self.safety.ok() and self.liveness.ok(),
        }
        # Incident ledger (§5.5r): fault→alert→recovery attribution over
        # the sections above, embedded so every consumer — expectations,
        # fleet_rollup, telemetry_dash --incidents, trace_report — reads
        # ONE materialization. Health never flips the baseline `ok`:
        # scenarios that want the verdict pin it via expectations, so
        # legacy cells stay comparable across matrix revisions.
        ledger = incidents.report_ledger(
            report,
            extra_windows=self._injected_windows(),
            budget=self.burn_budget,
        )
        incidents.record_metrics(ledger)
        incidents.log_ledger(ledger)
        report["incidents"] = ledger
        report["health"] = ledger["health"]
        return report

    # -- adversarial bookkeeping (forged-signature scenarios) ----------------

    def forged_triples_cached(self) -> int:
        """How many adversary-forged (msg, pk, sig) triples ended up in any
        honest node's VerifiedSigCache — must be ZERO (only successes are
        cached, and a forged signature never verifies)."""
        forged: list[tuple[bytes, bytes, bytes]] = []
        for i in self.byzantine:
            policy = getattr(self.nodes[i], "policy", None)
            for msg, pk, sig in getattr(policy, "forged", ()):
                forged.append((msg, pk.data, sig.data))
        count = 0
        for i in self.honest:
            service = self.nodes[i].service
            if service is None or service.dedup is None:
                continue
            entries = service.dedup._entries
            count += sum(1 for t in forged if t in entries)
        return count
