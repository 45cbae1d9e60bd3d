"""The 2-chain HotStuff core state machine (reference consensus/src/core.rs).

One actor owns ALL protocol state (round, last_voted_round, high_qc,
aggregator, pacemaker timer) and processes, via a single select loop
(core.rs:446-480):
  * Propose / Vote / Timeout / TC / SyncRequest messages from peers
  * LoopBack re-injections from the synchronizers
  * pacemaker timer expiry

Safety rules (core.rs:106-123): vote at most once per round, and only for a
block extending the latest QC (or justified by a TC). Liveness: the pacemaker
(timeout -> Timeout -> TC -> round advance with leader rotation).

Commit rule (2-chain, core.rs:344-350): committing b0 requires two blocks in
consecutive rounds, b0.round + 1 == b1.round, where b1 carries a QC on b0.

Improvement over the reference: the volatile safety state (round,
last_voted_round, high_qc) is persisted to the store and reloaded on restart,
closing the double-vote-after-crash gap the reference acknowledges
(consensus/src/core.rs:121, upstream issue #15).

The port's copy of `hotstuff_tpu/consensus/core.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..crypto import Digest, PublicKey, SignatureService, aggsig
from ..network import net
from ..network.net import NetMessage
from ..store import Store
from ..utils import metrics, tracing
from ..utils.actors import Selector, Timer, spawn
from ..utils.serde import Reader, Writer
from .aggregator import AggCertAggregator, Aggregator
from .config import Committee, Parameters
from .errors import (
    ConsensusError,
    InvalidSignatureError,
    WrongLeaderError,
    ensure,
)
from .leader import LeaderElector
from .mempool_driver import MempoolDriver
from .messages import (
    MAX_RANGE_BATCH,
    QC,
    TC,
    AggQC,
    AggTC,
    AggTimeoutBundle,
    AggVoteBundle,
    Block,
    LoopBack,
    Ping,
    Pong,
    Round,
    SyncRangeReply,
    SyncRangeRequest,
    SyncRequest,
    Timeout,
    TimeoutBundle,
    Vote,
    VoteBundle,
    _bitmap_members,
    _resolve_agg_keys,
    _timeout_digest,
    _vote_digest,
    decode_any_qc,
    decode_stored_block,
    encode_any_qc,
    encode_consensus_message,
    encode_stored_block,
)
from .overlay import (
    KIND_TIMEOUT,
    KIND_VOTE,
    OverlayRouter,
    filter_backed,
    note_plane_frames,
)
from .reconfig import EpochChange, MIN_ACTIVATION_MARGIN, as_manager
from .synchronizer import (
    RANGE_SYNC_THRESHOLD,
    RANGE_WALK_CAP,
    Synchronizer,
    collect_range,
)

log = logging.getLogger("hotstuff.consensus")

_SAFETY_KEY = b"safety-state"
# Leading-u64 sentinel marking the VERSIONED safety-state layout (round
# numbers never reach 2^64-1): the legacy layout cannot carry an AggQC
# high_qc, and legacy bytes must keep decoding byte-identically.
_SAFETY_AGG_SENTINEL = 0xFFFFFFFFFFFFFFFF

# Stage tracing for the protocol state machine (COMPONENTS.md metric table).
_M_PROPOSALS = metrics.counter("consensus.proposals")
_M_VOTES = metrics.counter("consensus.votes")
_M_COMMITS = metrics.counter("consensus.commits")
_M_TIMEOUTS = metrics.counter("consensus.timeouts")
_M_SYNC_SERVED = metrics.counter("consensus.sync_requests_served")
_M_ROUND = metrics.gauge("consensus.round")
_M_PROPOSAL_TO_VOTE = metrics.histogram("consensus.proposal_to_vote_s")
_M_COMMIT_LATENCY = metrics.histogram("consensus.commit_latency_s")
_M_RECONFIG_PROPOSED = metrics.counter("reconfig.proposed")
_M_HANDOFF_COMMITS = metrics.counter("reconfig.handoff_commits")
_M_RANGE_SERVED = metrics.counter("sync.range_served")
_M_RANGE_REPLIES = metrics.counter("sync.range_replies")
_M_RANGE_BLOCKS = metrics.counter("sync.range_blocks")
_M_PARKED = metrics.counter("sync.parked_blocks")
# Aggregate certificate plane (§5.5o). cert_bytes_committed counts the
# encoded certificate bytes of EVERY committed block regardless of mode,
# so legacy and aggregate matrix cells expose comparable
# bytes_per_committed_round columns (utils/telemetry.fleet_rollup).
_M_AGG_PARTIAL_REJECTS = metrics.counter("agg.partial_rejects")
_M_AGG_CERT_BYTES = metrics.counter("agg.cert_bytes_committed")
# Region-aware election attribution (§5.5p). Counted per COMMITTED round
# whenever a region map is wired (EVERY elector mode, so region-blind
# and region-aware cells expose comparable hop columns). The accounted
# leg is the commit-critical propose->certify PIVOT: round r's finished
# certificate reaching round r+1's proposer. Under leader-collector
# rooting that is a literal frame (the _handoff_qc bundle, leader r ->
# leader r+1); under next-leader rooting it is the last tree edge into
# the collector. Either way broadcast/tree frame TOTALS are placement-
# invariant under a population-proportional map; the pivot is the leg
# election placement actually controls. cross_region_hops counts pivots
# that crossed regions, leader_region_matches the co-located ones (they
# partition elect.rounds), and cross_region_hops_blind prices the SAME
# rounds under round-robin placement — a deterministic in-artifact
# counterfactual A/B.
_M_ELECT_ROUNDS = metrics.counter("elect.rounds")
_M_ELECT_MATCHES = metrics.counter("elect.leader_region_matches")
_M_ELECT_HOPS = metrics.counter("elect.cross_region_hops")
_M_ELECT_HOPS_BLIND = metrics.counter("elect.cross_region_hops_blind")

# Cap on the first-seen timestamp map feeding commit_latency_s: Byzantine
# proposals that never commit must not grow it without bound.
_SEEN_CAP = 4096


class Core:
    def __init__(
        self,
        name: PublicKey,
        committee: Committee,
        parameters: Parameters,
        signature_service: SignatureService,
        store: Store,
        leader_elector: LeaderElector,
        mempool_driver: MempoolDriver,
        synchronizer: Synchronizer,
        core_channel: asyncio.Queue,
        network_tx: asyncio.Queue,
        commit_channel: asyncio.Queue,
        verification_service=None,
        overlay_regions: dict[PublicKey, str] | None = None,
        agg_signer: "aggsig.AggSigner | None" = None,
        proof_registry=None,
    ) -> None:
        from ..crypto.batch_service import BatchVerificationService

        self.name = name
        # `committee` may be a static Committee or a reconfig.EpochManager;
        # either way the epoch manager is the single round -> committee
        # authority for this core (and is shared with the leader elector,
        # aggregator and synchronizer when wired by Consensus.run).
        self.epochs = as_manager(committee)
        self.parameters = parameters
        self.signature_service = signature_service
        # Off-loop batched verification: QC/TC/vote signature checks coalesce
        # into backend dispatches in a worker thread instead of blocking the
        # select loop (the seam the reference gets from tokio's threadpool).
        self.verification_service = (
            verification_service or BatchVerificationService()
        )
        self.store = store
        self.leader_elector = leader_elector
        self.mempool_driver = mempool_driver
        self.synchronizer = synchronizer
        self.core_channel = core_channel
        self.network_tx = network_tx
        self.commit_channel = commit_channel
        # Commit-proof serving plane (proofs/registry.py): when wired,
        # every committed block is indexed under its CERTIFYING
        # certificate — the successor's QC — so clients can be served
        # O(1) finality proofs (§5.5q).
        self.proofs = proof_registry

        self.round: Round = 1
        self.last_voted_round: Round = 0
        self.last_committed_round: Round = 0
        self.high_qc: QC | AggQC = QC.genesis()
        # Constant-size certificate plane (§5.5o): with aggregate_certs
        # on AND an aggregate signing key wired, this node's votes and
        # timeouts ride as singleton-bitmap partials and its quorums form
        # AggQC/AggTC. Inbound aggregate traffic is ALWAYS understood
        # (mixed-fleet interop); only the node's own emissions are gated.
        self.agg_signer = agg_signer
        self.agg = bool(parameters.aggregate_certs) and agg_signer is not None
        self.agg_aggregator = AggCertAggregator(
            self.epochs, window=parameters.agg_window
        )
        # Cumulative cert-plane commit stats feeding the "Cert plane:"
        # log line (benchmark LogParser's + CERTS section).
        self._agg_certs_committed = 0
        self._legacy_certs_committed = 0
        self._worst_cert_bytes = 0
        self._agg_depth_max = 0
        # Cumulative election-plane commit stats feeding the
        # "Election plane:" log line (benchmark LogParser's + ELECTION
        # section). Zero — and the line absent — without a region map.
        self._elect_rounds = 0
        self._elect_matches = 0
        self._elect_hops = 0
        self._elect_hops_blind = 0
        # The aggregator seeds verified vote/timeout signatures into the
        # service's dedup cache, so assembled QCs/TCs short-circuit.
        self.aggregator = Aggregator(self.epochs, self.verification_service)
        # Region-aware aggregation overlay (consensus/overlay.py). Always
        # constructed — inbound partial bundles merge regardless; whether
        # this node's OWN votes/timeouts ride the tree is gated by
        # Parameters.aggregation_overlay (default off, the committed
        # all-to-all baseline).
        self.overlay = OverlayRouter(self, overlay_regions)
        self.timer: Timer | None = None  # created inside the running loop
        # Newest TC this node processed or assembled: the lag-recovery
        # answer for a peer whose pacemaker is one round behind (see
        # _handle_timeout). TCs are otherwise fire-and-forget, and a
        # node that misses one stays a round behind the fleet for the
        # rest of a stall — fatal when the committee's quorum needs
        # every member (small post-churn committees).
        self.last_tc: TC | AggTC | None = None
        # Lag-recovery reply dedup: author -> (last_tc.round sent, when).
        # The stale-timeout branch deliberately spends no crypto, so an
        # unauthenticated flood forging a staked author could otherwise
        # reflect one full TC (O(n) signatures) per tiny frame at that
        # author's registered address; capping at one reply per (author,
        # TC round) per pacemaker period bounds the amplification to the
        # laggard's own honest re-timeout cadence while still re-serving
        # a reply the network dropped. Keys are stake-gated, so the map
        # is committee-bounded.
        self._lag_replies: dict[PublicKey, tuple[Round, float]] = {}
        # EpochChange queued for this node's next proposal (schedule_reconfig)
        self._pending_reconfig: EpochChange | None = None
        # Single-slot serve cache for chained range-sync batches:
        # (target digest bytes, walk floor, ancestor chain oldest-first).
        # Safe to reuse — a target's ancestry is immutable chain content.
        self._range_walk: tuple[bytes, Round, list[Block]] | None = None
        # Pacemaker backoff state: consecutive local timeouts without an
        # intervening QC-driven round advance (see Parameters.timeout_backoff).
        self._consecutive_timeouts = 0
        # block digest -> first-seen monotonic time, for commit_latency_s
        # (insertion-ordered; bounded by _SEEN_CAP, oldest evicted).
        self._block_seen: dict[Digest, float] = {}
        # Network-observatory probe sequence (see _probe_loop); runs only
        # when Parameters.probe_interval_ms > 0.
        self._probe_seq = 0

    @property
    def committee(self):
        """The committee governing the CURRENT round (epoch-resolved)."""
        return self.epochs.committee_for_round(self.round)

    def schedule_reconfig(self, change: EpochChange) -> None:
        """Queue a committee change for this node's next proposal. Carried
        until a proposal includes it; silently dropped once stale (the
        target epoch activated, or the activation round is no longer far
        enough ahead to commit first)."""
        self._pending_reconfig = change

    def _take_reconfig(self) -> EpochChange | None:
        change = self._pending_reconfig
        if change is None:
            return None
        if (
            change.new_epoch != self.epochs.applied_epoch + 1
            or change.activation_round < self.round + MIN_ACTIVATION_MARGIN
        ):
            self._pending_reconfig = None  # applied elsewhere, or too late
            return None
        if self.epochs.epoch_for_round(self.round) + 1 != change.new_epoch:
            # Applied but not yet ACTIVE predecessor boundary: a carrier
            # proposed now would ride a round the schedule still maps to
            # the pre-predecessor epoch and fail every replica's
            # sequencing check. Keep it queued until rounds cross the
            # previous activation boundary (the rolling-churn shape:
            # several EpochChanges in flight back to back).
            return None
        return change

    # -- persistence of safety-critical state (fixes reference issue #15) ----

    async def _load_safety_state(self) -> None:
        raw = await self.store.read(_SAFETY_KEY)
        if raw is None:
            return
        r = Reader(raw)
        first = r.u64()
        if first == _SAFETY_AGG_SENTINEL:
            # Versioned layout: the high_qc may be either certificate form.
            r.u8()  # layout version (1)
            self.round = r.u64()
            self.last_voted_round = r.u64()
            self.last_committed_round = r.u64()
            self.high_qc = decode_any_qc(r)
        else:
            self.round = first
            self.last_voted_round = r.u64()
            self.last_committed_round = r.u64()
            self.high_qc = QC.decode(r)
        log.info(
            "Recovered safety state: round %s, last_voted %s",
            self.round,
            self.last_voted_round,
        )

    async def _store_safety_state(self) -> None:
        w = Writer()
        if isinstance(self.high_qc, AggQC):
            # Sentinel-prefixed versioned layout; a legacy-form high_qc
            # keeps writing the historical bytes untouched.
            w.u64(_SAFETY_AGG_SENTINEL)
            w.u8(1)
            w.u64(self.round)
            w.u64(self.last_voted_round)
            w.u64(self.last_committed_round)
            encode_any_qc(w, self.high_qc)
        else:
            w.u64(self.round)
            w.u64(self.last_voted_round)
            w.u64(self.last_committed_round)
            self.high_qc.encode(w)
        await self.store.write(_SAFETY_KEY, w.bytes())

    # -- helpers -------------------------------------------------------------

    async def _transmit(
        self,
        msg,
        to: PublicKey | None,
        trace: "tracing.TraceContext | None" = None,
        urgent: bool = False,
    ) -> None:
        """Send to one authority, or broadcast to all others when to is None
        (consensus/src/synchronizer.rs:109-129 transmit helper). `trace`
        rides the frame trailer (utils/tracing.py) for cross-node
        commit-latency attribution. Direct sends resolve the address
        across every known epoch (a catch-up reply may target a peer only
        present in the adjacent epoch's committee); `urgent` selects the
        network's hot egress lane (sync recovery replies)."""
        data = encode_consensus_message(msg)
        if to is not None:
            addr = self.epochs.address(to)
            addrs = [addr] if addr else []
        else:
            addrs = self.committee.broadcast_addresses(self.name)
        if addrs:
            await self.network_tx.put(
                NetMessage(data, addrs, urgent=urgent, trace=trace)
            )

    @staticmethod
    def _trace_ctx(round_: Round, digest: Digest) -> "tracing.TraceContext | None":
        """Outbound trace context for block (round, digest); None with
        tracing disabled so the wire stays trailer-free."""
        if not tracing.enabled():
            return None
        return tracing.context_for(round_, digest.data)

    async def _store_block(self, block: Block) -> None:
        await self.store.write(block.digest().data, encode_stored_block(block))

    def _agg_bit(self, round_: Round) -> int | None:
        """This node's bit position in round_'s committee bitmap (sorted
        key order — the AggQC/AggTC convention); None when not a member
        of that round's committee."""
        keys = self.epochs.committee_for_round(round_).sorted_keys()
        try:
            return keys.index(self.name)
        except ValueError:
            return None

    # -- voting & committing -------------------------------------------------

    async def _make_vote(self, block: Block) -> Vote | AggVoteBundle | None:
        """Safety rules (core.rs:106-123), plus the epoch-final
        certification wall: while a next-epoch handoff is pending, this
        node refuses to help certify any round at or past the declared
        activation boundary — the old committee certifies THROUGH the
        epoch-final position and owns nothing after it, which is what
        makes a late-landing commit unable to re-map gap rounds
        (consensus/reconfig.py, §5.5j)."""
        if self.epochs.handoff_blocks(block.round):
            self.epochs.note_hold(block.round, "vote")
            return None
        safety_rule_1 = block.round > self.last_voted_round
        safety_rule_2 = block.qc.round + 1 == block.round
        if block.tc is not None:
            # TC justification: block jumps rounds but its QC is at least as
            # high as anything 2f+1 nodes saw when they timed out.
            ok_tc = (
                block.tc.round + 1 == block.round
                and block.qc.round >= max(block.tc.high_qc_rounds())
            )
            safety_rule_2 = safety_rule_2 or ok_tc
        if not (safety_rule_1 and safety_rule_2):
            return None
        self.last_voted_round = block.round
        await self._store_safety_state()
        digest = block.digest()
        if self.agg:
            # Aggregate mode: the vote IS a singleton-bitmap partial —
            # one aggregate-scheme signature over the same vote digest,
            # mergeable by any interior node on its way to the leader.
            bit = self._agg_bit(block.round)
            if bit is None:
                return None
            sig = self.agg_signer.sign(_vote_digest(digest, block.round).data)
            return AggVoteBundle(block.round, digest, 1 << bit, sig)
        signature = await self.signature_service.request_signature(
            _vote_digest(digest, block.round)
        )
        return Vote(digest, block.round, self.name, signature)

    async def _commit(self, block: Block, child: Block, grandchild: Block) -> None:
        """Commit `block` and all uncommitted ancestors, oldest first
        (core.rs:125-165). `child`/`grandchild` are the caller's b1 and
        the block under processing — the chain continuation above
        `block`, giving each committed EpochChange's LOCAL commit
        position for the late-apply observability check
        (reconfig.EpochManager.apply; the boundary itself stays the
        declared activation round)."""
        if self.last_committed_round >= block.round:
            return
        to_commit = [block]
        parent = block
        while True:
            parent_digest = parent.parent()
            if parent.qc.is_genesis():
                break
            raw = await self.store.read(parent_digest.data)
            if raw is None:
                log.error("missing ancestor during commit of %s", block)
                break
            parent = decode_stored_block(raw)
            if parent.round <= self.last_committed_round:
                break
            to_commit.append(parent)
        self.last_committed_round = block.round
        # Persist the floor BEFORE announcing the commit: the epoch-
        # boundary crash scenarios land a crash inside the commit path
        # (the switch hook fires here), and a floor that only becomes
        # durable at the NEXT vote would make the restarted node
        # re-commit its newest block — the monotonicity violation the
        # persisted safety state exists to prevent.
        await self._store_safety_state()
        # Commit-path synchronizer hygiene: the committed floor gates the
        # range-sync threshold, and fetches/waiters for branches at or
        # below it are abandoned forks to reclaim (the old leak).
        self.synchronizer.note_committed(block.round)
        self.synchronizer.cleanup(block.round)
        now = time.perf_counter()
        # to_commit is NEWEST-first: index i's chain grandchild is
        # to_commit[i-2], falling back to the caller's continuation for
        # the two newest entries. Applied oldest-first so stacked epoch
        # changes in one commit cascade sequence correctly.
        chain_above = {0: grandchild, 1: child}
        for i in range(len(to_commit) - 1, -1, -1):
            b = to_commit[i]
            if b.reconfig is not None:
                trigger = chain_above[i] if i < 2 else to_commit[i - 2]
                # The epoch-commit rule: the successor committee schedules
                # only HERE, when the carrying block is 2-chain committed
                # (apply is idempotent — a change can ride several blocks).
                await self.epochs.apply(
                    b.reconfig, store=self.store, trigger_round=trigger.round
                )
        # Handoff hygiene: a pending change whose every carrier the
        # committed chain just passed WITHOUT applying rode a dead fork —
        # drop it so its boundary stops walling certification.
        await self.epochs.note_commit(self.last_committed_round, store=self.store)
        for i in range(len(to_commit) - 1, -1, -1):
            b = to_commit[i]
            d = b.digest()
            _M_COMMITS.inc()
            self._note_cert_stats(b)
            self._note_election_stats(b)
            seen = self._block_seen.pop(d, None)
            if seen is not None:
                _M_COMMIT_LATENCY.record(now - seen)
            if tracing.enabled():
                tracing.event(
                    "commit",
                    tracing.trace_id(b.round, d.data),
                    (now - seen) if seen is not None else None,
                    round=b.round,
                )
            # NOTE: These log entries are used to compute performance.
            log.info("Committed B%s(%s)", b.round, d)
            for payload_digest in b.payload:
                log.info("Committed B%s(%s) -> %s", b.round, d, payload_digest)
            if self.proofs is not None:
                # The CERTIFYING certificate for to_commit[i] is the
                # successor block's carried QC (successor.qc.hash == d):
                # the 2-chain edge a stateless client can verify with
                # committee keys alone — exactly what the proof plane
                # serves (§5.5q).
                cert = (to_commit[i - 1] if i >= 1 else child).qc
                await self.proofs.note_commit(b, cert)
            await self.commit_channel.put(b)
        # NOTE: parsed by the benchmark LogParser (+ CERTS section).
        log.info(
            "Cert plane: %d aggregate / %d entry-list certs committed, "
            "worst cert %d B, agg depth %d",
            self._agg_certs_committed,
            self._legacy_certs_committed,
            self._worst_cert_bytes,
            self._agg_depth_max,
        )
        if self._elect_rounds:
            # NOTE: parsed by the benchmark LogParser (+ ELECTION section).
            log.info(
                "Election plane: %d round(s) committed, %d co-located "
                "pivot(s), %d cross-region hop(s), %d blind",
                self._elect_rounds,
                self._elect_matches,
                self._elect_hops,
                self._elect_hops_blind,
            )

    def _note_cert_stats(self, block: Block) -> None:
        """Per-committed-block certificate accounting: the encoded bytes
        feed agg.cert_bytes_committed (the fleet_rollup
        bytes_per_committed_round numerator, counted in EVERY mode so
        legacy and aggregate cells compare), the form split and worst
        size feed the cumulative "Cert plane:" line."""
        certs = [] if block.qc.is_genesis() else [block.qc]
        if block.tc is not None:
            certs.append(block.tc)
        for cert in certs:
            w = Writer()
            cert.encode(w)
            size = len(w.bytes())
            _M_AGG_CERT_BYTES.inc(size)
            if size > self._worst_cert_bytes:
                self._worst_cert_bytes = size
            if isinstance(cert, (AggQC, AggTC)):
                self._agg_certs_committed += 1
            else:
                self._legacy_certs_committed += 1

    def _note_election_stats(self, block: Block) -> None:
        """Per-committed-round election geometry (§5.5p): does the
        round's propose->certify pivot — its certificate travelling
        from round r's leader to round r+1's proposer (the _handoff_qc
        frame under leader-collector rooting) — stay inside one region?
        Scores the same pivot under round-robin placement as the blind
        counterfactual. Pure arithmetic over the frozen region map and
        the committed round — counters only, so same-seed replay stays
        bit-identical."""
        regions = self.overlay.region_of
        if not regions:
            return
        leader = self.leader_elector.get_leader(block.round)
        collector = self.leader_elector.get_leader(block.round + 1)
        self._elect_rounds += 1
        _M_ELECT_ROUNDS.inc()
        if regions.get(leader, "") == regions.get(collector, ""):
            self._elect_matches += 1
            _M_ELECT_MATCHES.inc()
        else:
            self._elect_hops += 1
            _M_ELECT_HOPS.inc()
        keys = self.epochs.schedule.sorted_keys_for_round(block.round)
        next_keys = self.epochs.schedule.sorted_keys_for_round(block.round + 1)
        blind_leader = keys[block.round % len(keys)]
        blind_collector = next_keys[(block.round + 1) % len(next_keys)]
        if regions.get(blind_leader, "") != regions.get(blind_collector, ""):
            self._elect_hops_blind += 1
            _M_ELECT_HOPS_BLIND.inc()

    # -- round pacing --------------------------------------------------------

    async def _process_qc(self, qc: QC | AggQC) -> None:
        """Adopt a higher QC and advance past its round (core.rs:263-276,321)."""
        if self.epochs.handoff_pending() and not qc.is_genesis():
            # Epoch-final commit unlock: with a handoff pending, the
            # observation that completes the carrier's 2-chain may never
            # arrive inside a block — when the completing pair hugs the
            # boundary, the QC on the pair's second block can only ride
            # a WALLED round's proposal; and a catch-up node may hold
            # the full pair plus its certificate (range-synced store +
            # a timeout's high_qc) while the wedged fleet produces no
            # further blocks at all. Commit straight off the adopted
            # certificate here; outside a pending handoff this path
            # never runs, so historical replay is byte-identical.
            await self._try_handoff_commit(qc)
        if qc.round > self.high_qc.round and tracing.enabled():
            # QC-assembly stage on NON-assembling nodes: the first time
            # this node sees a quorum certificate for the block.
            tracing.event(
                "qc", tracing.trace_id(qc.round, qc.hash.data), adopted=True
            )
        if qc.round >= self.round and self._consecutive_timeouts:
            # A QC advancing the round is real progress: restore the base
            # pacemaker delay. (TC-driven advances deliberately keep the
            # backed-off delay — a timeout round is not progress.)
            self._consecutive_timeouts = 0
            if self.timer is not None:
                self.timer.set_delay_ms(self.parameters.timeout_delay)
        await self._advance_round(qc.round)
        if qc.round > self.high_qc.round:
            self.high_qc = qc

    async def _try_handoff_commit(self, qc: QC) -> None:
        """Commit off an adopted certificate at the epoch-final edge: if
        `qc` certifies a stored block b1 whose own QC is consecutive
        (b0.round + 1 == b1.round), the 2-chain for b0 is complete — the
        observation normally arrives inside the NEXT block, which the
        wall may forbid. The commit trigger round is b1's (the round of
        the completing certificate), the honest local commit position."""
        if qc.round <= self.last_committed_round:
            return
        raw = await self.store.read(qc.hash.data)
        if raw is None:
            return
        b1 = decode_stored_block(raw)
        if b1.qc.is_genesis() or b1.qc.round + 1 != b1.round:
            return
        raw0 = await self.store.read(b1.parent().data)
        if raw0 is None:
            return
        b0 = decode_stored_block(raw0)
        if b0.round <= self.last_committed_round:
            return
        _M_HANDOFF_COMMITS.inc()
        log.info(
            "Handoff commit unlock: QC at round %s completes the 2-chain "
            "below the epoch boundary",
            qc.round,
        )
        await self._commit(b0, b1, b1)

    async def _advance_round(self, round_: Round) -> None:
        if round_ < self.round:
            return
        target = round_ + 1
        boundary = self.epochs.handoff_boundary()
        if boundary is not None and target > boundary:
            # Epoch-final wall, pacemaker side: while a handoff is
            # pending, this node may ENTER the boundary round (where the
            # successor committee's first traffic lands) but not cross
            # it — the rounds past the boundary belong to a committee it
            # has not committed yet. Crossing anyway (via old-committee
            # TCs formed during the stall) would strand it: everything
            # arriving at the boundary round becomes "stale", including
            # the very certificates whose fetch would complete its
            # handoff (the 64-node churn wedge).
            if boundary <= self.round:
                return
            target = boundary
        self.round = target
        _M_ROUND.set(self.round)
        # The epoch manager's current() (broadcast fan-out, synchronizer
        # peer picks) follows the newest round this core has reached.
        self.epochs.note_round(self.round)
        log.debug("Moved to round %s", self.round)
        if self.timer is not None:
            self.timer.reset()
        self.aggregator.cleanup(self.round)
        self.agg_aggregator.cleanup(self.round)
        self.overlay.cleanup(self.round)
        # Round/high_qc persistence piggybacks on the next pre-vote or
        # pre-timeout safety write (exactly one flushed write per round);
        # only last_voted_round must be durable BEFORE a signature leaves.

    async def _local_timeout_round(self) -> None:
        """Pacemaker fired (core.rs:175-197)."""
        _M_TIMEOUTS.inc()
        tracing.event(
            "timeout", round=self.round,
            consecutive=self._consecutive_timeouts + 1,
        )
        tracing.WATCHDOG.note_timeout(
            self.round, self._consecutive_timeouts + 1
        )
        log.warning("Timeout reached for round %s", self.round)
        self.last_voted_round = max(self.last_voted_round, self.round)
        await self._store_safety_state()
        agg_bit = self._agg_bit(self.round) if self.agg else None
        if agg_bit is not None:
            # Aggregate mode: a singleton-group partial (one group for
            # this node's high_qc round) carrying the backing certificate.
            sig = self.agg_signer.sign(
                _timeout_digest(self.round, self.high_qc.round).data
            )
            timeout: Timeout | AggTimeoutBundle = AggTimeoutBundle(
                self.round, self.high_qc,
                ((self.high_qc.round, 1 << agg_bit),), sig,
            )
        else:
            signature = await self.signature_service.request_signature(
                _timeout_digest(self.round, self.high_qc.round)
            )
            timeout = Timeout(self.high_qc, self.round, self.name, signature)
        if self.timer is not None:
            # Exponential backoff (liveness only — timeouts carry no safety
            # weight): under overload, firing at a fixed cadence adds
            # Timeout/TC verification storms to the very backlog that caused
            # the timeout. Growth starts at the THIRD consecutive timeout:
            # a single crashed leader inherently stalls two rounds per
            # rotation (the round whose votes it should collect, then its
            # own round), and backing off inside that ordinary 2-timeout
            # cycle would tax every crash-fault view change; only longer
            # chains (overload, partition) see growing delays. Restored by
            # the next QC-driven advance.
            self._consecutive_timeouts += 1
            p = self.parameters
            delay = min(
                p.timeout_delay
                * (p.timeout_backoff ** max(0, self._consecutive_timeouts - 2)),
                p.max_timeout_delay,
            )
            self.timer.set_delay_ms(max(delay, p.timeout_delay))
            self.timer.reset()
        if isinstance(timeout, AggTimeoutBundle):
            if self.overlay.enabled:
                await self.overlay.on_own_timeout_agg(timeout)
            else:
                await self._transmit(timeout, None)
                note_plane_frames(
                    KIND_TIMEOUT,
                    len(self.committee.broadcast_addresses(self.name)),
                )
            await self._handle_agg_timeout_bundle(timeout)
        elif self.overlay.enabled:
            # Overlay mode: ONE bundle frame up the round's aggregation
            # tree (plus a bounded gossip fallback if the round stays
            # stalled) instead of an n-1 frame broadcast — the O(n²)
            # timeout-storm fix (consensus/overlay.py).
            await self.overlay.on_own_timeout(timeout)
            await self._handle_timeout(timeout)
        else:
            await self._transmit(timeout, None)
            note_plane_frames(
                KIND_TIMEOUT,
                len(self.committee.broadcast_addresses(self.name)),
            )
            await self._handle_timeout(timeout)

    # -- proposals -----------------------------------------------------------

    async def _generate_proposal(self, tc: TC | AggTC | None) -> None:
        """Leader path (core.rs:278-318)."""
        if self.epochs.handoff_blocks(self.round):
            # Epoch-final wall, proposer side: nothing the old committee
            # proposes at or past a pending boundary may be certified, so
            # do not even ask — the round falls to the pacemaker until
            # the carrier's commit lands (then the successor committee
            # owns these rounds).
            self.epochs.note_hold(self.round, "proposal")
            return
        t0 = time.perf_counter()
        payload = await self.mempool_driver.get(self.parameters.max_payload_size)
        payload_dur = time.perf_counter() - t0
        reconfig = self._take_reconfig()
        digest = Block.make_digest(
            self.name, self.round, payload, self.high_qc, reconfig
        )
        signature = await self.signature_service.request_signature(digest)
        block = Block(
            self.high_qc, tc, self.name, self.round, tuple(payload), signature,
            reconfig,
        )
        _M_PROPOSALS.inc()
        if reconfig is not None:
            _M_RECONFIG_PROPOSED.inc()
            log.info(
                "Proposing %s in B%s", reconfig, block.round
            )
            # The proposer arms its OWN wall too: its proposal bypasses
            # _handle_proposal (it goes straight to _process_block), so
            # this is where the leader's pending handoff is recorded.
            await self.epochs.note_pending(
                reconfig, block.round, store=self.store
            )
        if tracing.enabled():
            tid = tracing.trace_id(block.round, digest.data)
            tracing.event("propose", tid, origin=True)
            # The leader's payload-fetch leg is the mempool Get above.
            tracing.event("payload", tid, payload_dur, digests=len(payload))
        if block.payload:
            # NOTE: This log entry is used to compute performance.
            log.info("Created B%s(%s)", block.round, block.digest())
        else:
            log.debug("Created empty %s", block)
        await self._transmit(block, None, trace=self._trace_ctx(block.round, digest))
        await self._process_block(block)

    async def _process_block(self, block: Block, replay: bool = False) -> None:
        """Ordering + commit logic (core.rs:327-378)."""
        t0 = time.perf_counter()
        ancestors = await self.synchronizer.get_ancestors(block)
        if ancestors is None:
            log.debug("processing of %s suspended: missing ancestors", block)
            return
        b0, b1 = ancestors
        await self._store_block(block)
        self._block_seen.setdefault(block.digest(), t0)
        while len(self._block_seen) > _SEEN_CAP:
            self._block_seen.pop(next(iter(self._block_seen)))

        # 2-chain commit rule.
        if b0.round + 1 == b1.round:
            await self._commit(b0, b1, block)
        await self.mempool_driver.cleanup(b0, b1, block)

        if replay or block.round != self.round:
            # Replayed (range-synced) blocks are historical: their QCs
            # already exist, so voting would only burn a signing + a
            # durable safety-state write + a stale frame per ancient
            # block — the round-match gate alone misses this on a node
            # whose round is still dragging up through the replay.
            return
        # NOTE: deliberately NO timer reset here. The pacemaker re-arms only
        # on round ADVANCE (core.rs:267-268): resetting on every current-round
        # block would let a Byzantine leader suppress this replica's Timeout
        # by re-sending its round-r proposal, and with f crashed replicas the
        # remaining honest timeouts could no longer reach 2f+1 for a TC.
        vote = await self._make_vote(block)
        if vote is None:
            return
        _M_VOTES.inc()
        _M_PROPOSAL_TO_VOTE.record(time.perf_counter() - t0)
        if tracing.enabled():
            tracing.event(
                "vote", tracing.trace_id(block.round, block.digest().data)
            )
        log.debug("created %s", vote)
        # Vote sink: the next leader (baseline — it needs the QC to
        # propose), or THIS round's leader under leader-collector mode
        # (§5.5p — the certificate forms in the proposing region and
        # hands off to the next proposer in one frame, _handoff_qc).
        sink = self.leader_elector.get_leader(
            self.round if self.parameters.leader_collector else self.round + 1
        )
        if isinstance(vote, AggVoteBundle):
            if sink == self.name:
                await self._handle_agg_vote_bundle(vote)
            elif self.overlay.enabled:
                await self.overlay.on_own_vote_agg(vote)
            else:
                await self._transmit(
                    vote, sink,
                    trace=self._trace_ctx(vote.round, vote.hash),
                )
                note_plane_frames(KIND_VOTE, 1)
            return
        if sink == self.name:
            await self._handle_vote(vote)
        elif self.overlay.enabled:
            # Overlay mode: the vote rides the region-aware tree rooted
            # at the sink — interior nodes merge partial bundles so the
            # collector's fan-in is O(fanout), not O(n).
            await self.overlay.on_own_vote(vote)
        else:
            await self._transmit(
                vote, sink,
                trace=self._trace_ctx(vote.round, vote.hash),
            )
            note_plane_frames(KIND_VOTE, 1)

    # -- message handlers ----------------------------------------------------

    async def _handle_proposal(self, block: Block, replay: bool = False) -> None:
        digest = block.digest()
        # Disabled-mode fast path: skip the trace-id formatting and the
        # extra clock reads entirely (tid=None keeps service groups untagged).
        traced = tracing.enabled()
        tid = tracing.trace_id(block.round, digest.data) if traced else None
        if traced:
            tracing.event("propose", tid)
        t0 = time.perf_counter()
        try:
            leader = self.leader_elector.get_leader(block.round)
            ensure(
                block.author == leader,
                WrongLeaderError(block.round, block.author, leader),
            )
            await block.verify_async(
                self.epochs, self.verification_service, trace=tid
            )
            if block.reconfig is not None:
                # Epoch sequencing + activation-margin admission (the
                # signature already rode the verify_async group).
                self.epochs.validate(block.reconfig, block.round)
                # Epoch-final handoff: an admitted carrier arms the
                # certification wall at its declared boundary until its
                # commit lands (persisted — a crash here must wake with
                # the wall intact).
                await self.epochs.note_pending(
                    block.reconfig, block.round, store=self.store
                )
        except ConsensusError:
            if (
                block.round > self.last_committed_round + RANGE_SYNC_THRESHOLD
                and await self.store.read(block.parent().data) is None
            ):
                # Catch-up seam: a block this far past our COMMITTED floor
                # may be certified by a committee epoch we have not
                # committed yet (reconfig.py), in which case every check
                # above judges it with stale epoch knowledge. Park it
                # unverified, fetch its claimed ancestry (range sync),
                # and re-validate from scratch when the parent arrives.
                # Nothing is trusted until that second pass succeeds. The
                # floor (not self.round) is the right yardstick: a joiner
                # admitted at an epoch boundary ADVANCES its round by
                # adopting certified high_qcs from the stall-round
                # timeouts around it while owning none of the chain — a
                # round-relative gate would then reject every proposal
                # (stale-epoch leader check) without ever fetching
                # ancestry, wedging the whole committee when the joiner
                # is needed for quorum. The parent-missing guard matters:
                # with the parent present this IS the second pass — a
                # failure now is genuine garbage, and re-parking it would
                # spin (the waiter fires instantly).
                if await self.synchronizer.fetch_unverified(block):
                    _M_PARKED.inc()
                    log.info(
                        "parking unverifiable B%s (%s rounds past the "
                        "committed floor %s) pending ancestry sync",
                        block.round,
                        block.round - self.last_committed_round,
                        self.last_committed_round,
                    )
                    return
            raise
        if traced:
            dur = time.perf_counter() - t0
            tracing.event("verify", tid, dur)
            if not block.qc.is_genesis():
                # Verifying this block also verified its embedded QC — the
                # verify leg of the PARENT block's lifecycle on this node.
                tracing.event(
                    "verify",
                    tracing.trace_id(block.qc.round, block.qc.hash.data),
                    dur,
                    via=tid,
                )
        await self._process_qc(block.qc)
        if block.tc is not None:
            self._note_tc(block.tc)
            await self._advance_round(block.tc.round)
        t0 = time.perf_counter()
        available = await self.mempool_driver.verify(block)
        if traced:
            tracing.event(
                "payload", tid, time.perf_counter() - t0, available=available
            )
        if not available:
            log.debug("%s waiting for payload availability", block)
            return
        await self._process_block(block, replay=replay)

    async def _handle_vote(self, vote: Vote) -> None:
        if vote.round < self.round:
            return
        traced = tracing.enabled()
        tid = tracing.trace_id(vote.round, vote.hash.data) if traced else None
        t0 = time.perf_counter()
        await vote.verify_async(
            self.epochs, self.verification_service, trace=tid
        )
        if traced:
            tracing.event("verify", tid, time.perf_counter() - t0, vote=True)
        qc = self.aggregator.add_vote(vote)
        if qc is not None:
            log.debug("assembled %s", qc)
            await self._process_qc(qc)
            if self.leader_elector.get_leader(self.round) == self.name:
                await self._generate_proposal(None)
            else:
                await self._handoff_qc(qc)

    async def _handoff_qc(self, qc: QC | AggQC) -> None:
        """Leader-collector handoff (§5.5p): this node collected round
        r's votes (it is round r's leader — Parameters.leader_collector
        roots the vote plane there) but round r+1's proposer sits
        elsewhere. The COMPLETE certificate rides one explicit bundle
        frame to the next leader, which re-verifies and assembles its
        own QC through the ordinary bundle handlers — no new message
        type, and the frame is the literal propose->certify pivot the
        elect.cross_region_hops counter prices. No-op outside
        leader-collector mode (the baseline's next-leader sink already
        holds the QC it needs)."""
        if not self.parameters.leader_collector:
            return
        next_leader = self.leader_elector.get_leader(qc.round + 1)
        if next_leader == self.name:
            return
        if hasattr(qc, "votes"):
            bundle = VoteBundle(qc.round, qc.hash, tuple(qc.votes))
        else:
            bundle = AggVoteBundle(qc.round, qc.hash, qc.bitmap, qc.agg_sig)
        note_plane_frames(KIND_VOTE, 1)
        await self._transmit(
            bundle, next_leader,
            urgent=True,
            trace=self._trace_ctx(qc.round, qc.hash),
        )

    def _note_tc(self, tc: TC | AggTC) -> None:
        if self.last_tc is None or tc.round > self.last_tc.round:
            self.last_tc = tc

    async def _handle_timeout(self, timeout: Timeout) -> None:
        if timeout.round < self.round:
            # Lag recovery: a timeout a few rounds behind us is the
            # signature of a peer that missed the TCs which advanced the
            # rest of the fleet (TCs are fire-and-forget). Re-serve our
            # newest TC directly — it advances the laggard past every
            # missed round in one hop. Without this, a committee whose
            # quorum needs the lagging members (post-churn committees,
            # joiners exiting their handoff a few stall-rounds behind)
            # wedges with each side re-timing-out rounds the other is
            # not in. Bounded: only lag within the range-sync threshold
            # (deeper lag rides the range-sync paths), only for a
            # claimed author with stake in the stale round's OR the
            # current round's committee (a joiner stuck at a boundary
            # is a member of the next epoch only), one direct frame per
            # received timeout, no crypto spent on the stale frame.
            now = asyncio.get_running_loop().time()
            prev = self._lag_replies.get(timeout.author)
            fresh = (
                prev is None
                or prev[0] != self.last_tc.round
                or (now - prev[1]) * 1000.0 >= self.parameters.timeout_delay
            ) if self.last_tc is not None else False
            if (
                fresh
                and timeout.round >= self.round - RANGE_SYNC_THRESHOLD
                and self.last_tc.round >= timeout.round
                and (
                    self.epochs.committee_for_round(timeout.round).stake(
                        timeout.author
                    )
                    > 0
                    or self.epochs.committee_for_round(self.round).stake(
                        timeout.author
                    )
                    > 0
                )
            ):
                self._lag_replies[timeout.author] = (self.last_tc.round, now)
                await self._transmit(self.last_tc, timeout.author, urgent=True)
            return
        try:
            await timeout.verify_async(self.epochs, self.verification_service)
        except ConsensusError:
            # Stale-epoch bootstrap (synchronizer.fetch_certified): a
            # timeout we cannot verify whose high_qc sits far past our
            # committed floor is the signature of a node that missed one
            # or more epoch boundaries — and when the committee needs
            # THIS node for quorum, these timeouts are the only traffic
            # that will ever arrive. Fetch the certified ancestry; the
            # replay installs the committed epoch switches, then live
            # traffic verifies. The timeout itself stays rejected.
            qc = timeout.high_qc
            if (
                not qc.is_genesis()
                and qc.round
                > self.last_committed_round + RANGE_SYNC_THRESHOLD
                and await self.synchronizer.fetch_certified(qc.hash, qc.round)
            ):
                _M_PARKED.inc()
                log.info(
                    "unverifiable timeout at round %s: bootstrapping range "
                    "sync from its high_qc (round %s, floor %s)",
                    timeout.round,
                    qc.round,
                    self.last_committed_round,
                )
                return
            raise
        await self._process_qc(timeout.high_qc)
        hqc = timeout.high_qc
        if (
            not hqc.is_genesis()
            and hqc.round > self.last_committed_round
            and await self.store.read(hqc.hash.data) is None
        ):
            # Certified-gap closure: this VERIFIED high_qc certifies a
            # block we never received. During a stall a node can run
            # ahead of its floor by adopting such certificates — and
            # once the whole committee waits on it at a boundary, no
            # future proposal will ever deliver the missing ancestry
            # (rounds cannot form without this node). Fetch the
            # certified block directly; its ancestry cascade and the
            # replayed epoch switches close the floor gap.
            await self.synchronizer.fetch_certified(hqc.hash, hqc.round)
        tc = self.aggregator.add_timeout(timeout)
        if tc is not None:
            log.debug("assembled %s", tc)
            self._note_tc(tc)
            await self._advance_round(tc.round)
            await self._transmit(tc, None)
            if self.leader_elector.get_leader(self.round) == self.name:
                await self._generate_proposal(tc)

    async def _handle_vote_bundle(self, bundle: VoteBundle) -> None:
        """Aggregation-overlay partial vote quorum (consensus/overlay.py).
        Unseen entries are batch-verified as ONE group on the scheduler's
        `aggregate` lane; an invalid entry rejects ALONE (counted in
        agg.invalid_entries) without poisoning the rest. The next leader
        feeds verified entries straight into its QC aggregator; everyone
        else merges and forwards one frame up the tree."""
        self.overlay.note_received()
        if bundle.round < self.round:
            return
        key = OverlayRouter.vote_key(bundle.round, bundle.hash)
        fresh = self.overlay.fresh(key, bundle.votes)
        if not fresh:
            return
        committee = self.epochs.committee_for_round(bundle.round)
        known = [(pk, sig) for pk, sig in fresh if committee.stake(pk) > 0]
        self.overlay.note_invalid(len(fresh) - len(known))
        if not known:
            return
        digest = _vote_digest(bundle.hash, bundle.round).data
        mask = await self.verification_service.verify_group(
            [digest] * len(known), known, committee=True, source="aggregate",
        )
        valid = [entry for entry, ok in zip(known, mask) if ok]
        self.overlay.note_invalid(len(known) - len(valid))
        new = self.overlay.merge(key, valid)
        if not new or bundle.round < self.round:
            return
        if self._vote_sink(bundle.round):
            for pk, sig in new:
                qc = self.aggregator.add_vote_entry(
                    bundle.round, bundle.hash, pk, sig
                )
                if qc is not None:
                    # NOTE: parsed by the benchmark LogParser (+ AGG:).
                    log.info(
                        "Agg bundle quorum: QC round %s from %s entries",
                        qc.round,
                        len(qc.votes),
                    )
                    await self._process_qc(qc)
                    if self.leader_elector.get_leader(self.round) == self.name:
                        await self._generate_proposal(None)
                    else:
                        await self._handoff_qc(qc)
                    return
        else:
            if await self._try_collector_quorum(key, bundle.round):
                return
            await self.overlay.after_merge(key)

    def _vote_sink(self, round_: Round) -> bool:
        """Is this node the vote-plane COLLECTOR for `round_` — the one
        assembler that feeds verified entries into its own QC
        aggregator? Exactly the node the round's tree roots at: the
        next leader (baseline — it needs the QC to propose) or the
        round's own leader under leader-collector mode (§5.5p). Nobody
        else may sink partials — under leader-collector the next leader
        sits INTERIOR in the round's tree, and swallowing its children's
        partials would starve the collector's subtree of quorum. The
        next leader instead assembles via the merged-state quorum watch
        (_try_collector_quorum) once the handoff frame lands."""
        return self.leader_elector.get_leader(
            round_ if self.parameters.leader_collector else round_ + 1
        ) == self.name

    async def _try_collector_quorum(self, key: tuple, round_: Round) -> bool:
        """Leader-collector quorum watch (§5.5p): the next proposer,
        merging vote partials as an ordinary interior node, assembles
        the certificate directly from merged overlay state the moment
        coverage reaches quorum — one merge after the collector's
        complete handoff bundle lands (or after fallback gossip
        delivers the same coverage the hard way). Returns True when a
        certificate was assembled and processed."""
        if not self.parameters.leader_collector or self.round > round_:
            return False
        if self.leader_elector.get_leader(round_ + 1) != self.name:
            return False
        committee = self.epochs.committee_for_round(round_)
        qc = self.overlay.quorum_certificate(key, committee)
        if qc is None:
            return False
        # NOTE: parsed by the benchmark LogParser (+ AGG:).
        log.info(
            "Agg bundle quorum: QC round %s from %s entries",
            qc.round,
            qc.signers() if hasattr(qc, "signers") else len(qc.votes),
        )
        await self._process_qc(qc)
        if self.leader_elector.get_leader(self.round) == self.name:
            await self._generate_proposal(None)
        return True

    async def _handle_timeout_bundle(self, bundle: TimeoutBundle) -> None:
        """Aggregation-overlay partial timeout quorum: entries and the
        carried high_qc verify as one `aggregate`-lane group (the QC is
        quorum-checked structurally first, like a Timeout's); any node
        that accumulates 2f+1 merged entries assembles the TC and
        broadcasts it — the storm-free replacement for every node
        broadcasting every Timeout."""
        self.overlay.note_received()
        if bundle.round < self.round:
            return
        key = OverlayRouter.timeout_key(bundle.round)
        fresh = self.overlay.fresh(key, bundle.timeouts)
        committee = self.epochs.committee_for_round(bundle.round)
        known = [entry for entry in fresh if committee.stake(entry[0]) > 0]
        self.overlay.note_invalid(len(fresh) - len(known))
        qc_ok: bool | None = bundle.high_qc.is_genesis()
        if not qc_ok:
            try:
                bundle.high_qc.check_quorum(self.epochs)
                qc_ok = None  # decided by the verification mask below
            except ConsensusError:
                self.overlay.note_invalid(1)
                qc_ok = False
        # Backing pre-filter: an entry's high_qc_round claim must be
        # covered by the bundle's carried QC (overlay.filter_backed — a
        # validly SIGNED but unbacked claim would poison every TC it
        # enters with an unsatisfiable justification round). Claims above
        # a structurally bad carried QC back to nothing (genesis only).
        backed_round = 0
        if qc_ok is not False and not bundle.high_qc.is_genesis():
            backed_round = bundle.high_qc.round
        known, unbacked = filter_backed(known, backed_round)
        self.overlay.note_invalid(unbacked)
        msgs = [
            _timeout_digest(bundle.round, hqr).data for _pk, _sig, hqr in known
        ]
        pairs: list = [(pk, sig) for pk, sig, _hqr in known]
        qc_lo = len(msgs)
        if qc_ok is None:
            m, p = bundle.high_qc.signed_items()
            msgs += m
            pairs += p
        if not msgs:
            return
        mask = await self.verification_service.verify_group(
            msgs, pairs, committee=True, source="aggregate",
        )
        valid = [entry for entry, ok in zip(known, mask[:qc_lo]) if ok]
        self.overlay.note_invalid(len(known) - len(valid))
        if qc_ok is None:
            qc_ok = all(mask[qc_lo:])
            if not qc_ok:
                self.overlay.note_invalid(1)
        if not qc_ok:
            # The carried QC's signatures failed AFTER the pre-filter
            # admitted claims against its round: those entries lost their
            # backing — only genesis claims survive.
            backed = [entry for entry in valid if entry[2] == 0]
            self.overlay.note_invalid(len(valid) - len(backed))
            valid = backed
        adopt_qc = qc_ok and not bundle.high_qc.is_genesis()
        new = self.overlay.merge(
            key, valid, high_qc=bundle.high_qc if adopt_qc else None
        )
        if adopt_qc:
            await self._process_qc(bundle.high_qc)
        if not new or bundle.round < self.round:
            return
        for pk, sig, hqr in new:
            tc = self.aggregator.add_timeout_entry(bundle.round, pk, sig, hqr)
            if tc is not None:
                # NOTE: parsed by the benchmark LogParser (+ AGG:).
                log.info(
                    "Agg bundle quorum: TC round %s from %s entries",
                    tc.round,
                    len(tc.votes),
                )
                self._note_tc(tc)
                await self._advance_round(tc.round)
                await self._transmit(tc, None)
                if self.leader_elector.get_leader(self.round) == self.name:
                    await self._generate_proposal(tc)
                return
        await self.overlay.after_merge(key)

    async def _handle_agg_vote_bundle(self, bundle: AggVoteBundle) -> None:
        """Aggregate-certificate vote partial (§5.5o). Verification is
        ATOMIC — the partial verifies as a whole or is rejected as a
        whole (Handel's rule: an aggregate has no per-entry signatures to
        salvage), so a forged member poisons only the partial carrying
        it. Verified partials feed the Handel packing state: the next
        leader's AggQCMaker when this node collects, the overlay partial
        set (merge + forward one frame up the tree) otherwise."""
        self.overlay.note_received()
        if bundle.round < self.round:
            return
        committee = self.epochs.committee_for_round(bundle.round)
        try:
            members = _bitmap_members(bundle.bitmap, committee)
            ensure(
                bool(members),
                InvalidSignatureError("empty aggregate vote partial"),
            )
            ok = aggsig.active_agg_scheme().verify(
                _resolve_agg_keys(members),
                bundle.signed_digest().data,
                bundle.agg_sig,
            )
            ensure(
                ok, InvalidSignatureError("aggregate vote partial rejected")
            )
        except ConsensusError:
            _M_AGG_PARTIAL_REJECTS.inc()
            self.overlay.note_invalid(1)
            raise
        if bundle.depth > self._agg_depth_max:
            self._agg_depth_max = bundle.depth
        if self._vote_sink(bundle.round):
            qc = self.agg_aggregator.add_vote_partial(bundle)
            if qc is not None:
                # NOTE: parsed by the benchmark LogParser (+ AGG:).
                log.info(
                    "Agg bundle quorum: QC round %s from %s entries",
                    qc.round,
                    qc.signers(),
                )
                await self._process_qc(qc)
                if self.leader_elector.get_leader(self.round) == self.name:
                    await self._generate_proposal(None)
                else:
                    await self._handoff_qc(qc)
            return
        key = OverlayRouter.vote_key(bundle.round, bundle.hash)
        self.overlay.merge_agg_vote(
            key, bundle.bitmap, bundle.agg_sig, bundle.depth
        )
        if await self._try_collector_quorum(key, bundle.round):
            return
        await self.overlay.after_merge(key)

    async def _handle_agg_timeout_bundle(self, bundle: AggTimeoutBundle) -> None:
        """Aggregate-certificate timeout partial. Atomicity REPLACES the
        legacy filter_backed per-entry salvage: a bundle whose max
        claimed high-qc round exceeds its carried certificate's round is
        rejected WHOLE (an honest sender never produces one), the
        carried certificate itself must verify, and the groups must be
        bitmap-disjoint — only then does the one aggregate signature get
        checked over the per-group timeout digests. Any node reaching
        2f+1 packed stake assembles the AggTC and broadcasts it."""
        self.overlay.note_received()
        if bundle.round < self.round:
            return
        committee = self.epochs.committee_for_round(bundle.round)
        try:
            ensure(
                bool(bundle.groups),
                InvalidSignatureError("empty aggregate timeout partial"),
            )
            claimed = max(hqr for hqr, _ in bundle.groups)
            ensure(
                claimed <= bundle.high_qc.round,
                InvalidSignatureError(
                    "aggregate timeout partial claims an unbacked high-qc "
                    f"round {claimed} > carried {bundle.high_qc.round}"
                ),
            )
            if not bundle.high_qc.is_genesis():
                await bundle.high_qc.verify_async(
                    self.epochs, self.verification_service
                )
            seen = 0
            groups = []
            for hqr, bm in bundle.groups:
                ensure(
                    not bm & seen,
                    InvalidSignatureError(
                        "overlapping groups in aggregate timeout partial"
                    ),
                )
                seen |= bm
                members = _bitmap_members(bm, committee)
                ensure(
                    bool(members),
                    InvalidSignatureError("empty aggregate timeout group"),
                )
                groups.append(
                    (
                        _resolve_agg_keys(members),
                        _timeout_digest(bundle.round, hqr).data,
                    )
                )
            ok = aggsig.active_agg_scheme().verify_groups(
                groups, bundle.agg_sig
            )
            ensure(
                ok, InvalidSignatureError("aggregate timeout partial rejected")
            )
        except ConsensusError:
            _M_AGG_PARTIAL_REJECTS.inc()
            self.overlay.note_invalid(1)
            raise
        if bundle.depth > self._agg_depth_max:
            self._agg_depth_max = bundle.depth
        if not bundle.high_qc.is_genesis():
            await self._process_qc(bundle.high_qc)
            if bundle.round < self.round:
                return  # the carried certificate already outran this round
        tc = self.agg_aggregator.add_timeout_partial(
            bundle.round, bundle.groups, bundle.agg_sig, bundle.depth
        )
        if tc is not None:
            # NOTE: parsed by the benchmark LogParser (+ AGG:).
            log.info(
                "Agg bundle quorum: TC round %s from %s entries",
                tc.round,
                tc.signers(),
            )
            self._note_tc(tc)
            await self._advance_round(tc.round)
            await self._transmit(tc, None)
            if self.leader_elector.get_leader(self.round) == self.name:
                await self._generate_proposal(tc)
            return
        key = OverlayRouter.timeout_key(bundle.round)
        self.overlay.merge_agg_timeout(
            key,
            bundle.groups,
            bundle.agg_sig,
            bundle.depth,
            carried_cert=bundle.high_qc,
        )
        await self.overlay.after_merge(key)

    async def _handle_tc(self, tc: TC | AggTC) -> None:
        """A TC received directly (core.rs:438-444)."""
        await tc.verify_async(self.epochs, self.verification_service)
        self._note_tc(tc)
        await self._advance_round(tc.round)
        if self.leader_elector.get_leader(self.round) == self.name:
            await self._generate_proposal(tc)

    async def _handle_sync_request(self, request: SyncRequest) -> None:
        """Re-send a stored block to a lagging peer (core.rs:418-436)."""
        raw = await self.store.read(request.digest.data)
        if raw is None:
            return
        _M_SYNC_SERVED.inc()
        block = decode_stored_block(raw)
        await self._transmit(block, request.requester, urgent=True)

    async def _handle_sync_range_request(self, request: SyncRangeRequest) -> None:
        """Serve a catch-up batch: the ancestor chain ending at the
        requested target, oldest-first, capped (synchronizer.collect_range).
        Unknown targets are ignored — the requester's retry escalation
        finds a peer that has it.

        A chained catch-up re-requests the SAME target with a rising
        from_round; re-walking the whole ancestry per batch would make
        the serve side quadratic in the gap (each walk reads+decodes up
        to the full chain to find the oldest 64 blocks). The single-slot
        walk cache keeps the full (walk-capped) chain for the last
        target: one walk per catch-up, a slice per batch."""
        cached = self._range_walk
        if (
            cached is not None
            and cached[0] == request.target.data
            and request.from_round >= cached[1]
        ):
            chain = cached[2]
        else:
            chain = await collect_range(
                self.store, request.target, request.from_round, cap=RANGE_WALK_CAP
            )
            self._range_walk = (request.target.data, request.from_round, chain)
        blocks = [b for b in chain if b.round > request.from_round][:MAX_RANGE_BATCH]
        if not blocks:
            return
        _M_RANGE_SERVED.inc()
        await self._transmit(
            SyncRangeReply(request.target, tuple(blocks)),
            request.requester,
            urgent=True,
        )

    async def _handle_sync_range_reply(self, reply: SyncRangeReply) -> None:
        """Ingest a catch-up batch. Every block runs the FULL proposal
        path (leader check, batched signature verification, per-epoch QC
        quorums, ordering, commit rule) in oldest-first order, so epoch
        switches committed mid-batch govern the validation of the blocks
        that follow them. A block that fails aborts the rest of the batch
        (later blocks depend on it); already-stored blocks are skipped, so
        duplicate replies from an escalated broadcast are cheap."""
        if not reply.blocks:
            return
        _M_RANGE_REPLIES.inc()
        processed = 0
        for block in reply.blocks:
            if await self.store.read(block.digest().data) is not None:
                continue
            try:
                await self._handle_proposal(block, replay=True)
            except ConsensusError as e:
                log.warning("range-sync block %s rejected: %s", block, e)
                break
            processed += 1
        if not processed:
            return
        _M_RANGE_BLOCKS.inc(processed)
        # NOTE: parsed by the benchmark LogParser (catch-up progress).
        log.info("Range sync fetched %s blocks", processed)
        if await self.store.read(reply.target.data) is None:
            # Still short of the target: chain the next batch eagerly off
            # the advanced committed floor instead of waiting out a retry.
            await self.synchronizer.continue_range(reply.target)
        else:
            log.info(
                "Range sync caught up: target %s resolved at round %s",
                reply.target.short(),
                self.last_committed_round,
            )

    # -- network observatory probes (network/net.py peer ledger) -------------

    # Peer-RTT-map log cadence: one summary per this many probe rounds
    # (the lines the benchmark LogParser's NETWORK section scrapes).
    PROBE_LOG_EVERY = 8

    async def _probe_loop(self) -> None:
        """Broadcast one Ping per Parameters.probe_interval_ms and fold
        the answering Pongs into the per-peer RTT EWMAs (network/net.py).
        Timestamps ride the loop clock, so under the chaos virtual-time
        loop every measured RTT — and therefore the whole ledger — is a
        pure function of the seed. Never spawned when the interval is 0:
        probe frames share the chaos transport's per-link fault streams
        with protocol traffic, so enabling them is a determinism-pin
        opt-in, not a default."""
        interval = self.parameters.probe_interval_ms / 1000.0
        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(interval)
            self._probe_seq += 1
            for addr in self.committee.broadcast_addresses(self.name):
                net.note_probe_sent(addr)
            ping = Ping(self.name, self._probe_seq, int(loop.time() * 1e6))
            await self._transmit(ping, None)
            if self._probe_seq % self.PROBE_LOG_EVERY == 0:
                self._log_peer_map()

    def _log_peer_map(self) -> None:
        # NOTE: these log entries are parsed by the benchmark LogParser.
        snap = net.peer_snapshot()
        rtts = {
            peer: s["rtt_ewma_ms"]
            for peer, s in snap.items()
            if s["rtt_ewma_ms"] is not None
        }
        sent = sum(s["probes_sent"] for s in snap.values())
        answered = sum(s["pongs_received"] for s in snap.values())
        if rtts:
            classes = net.rtt_classes(rtts)
            log.info(
                "Peer RTT map: %s peer(s) in %s class(es), worst EWMA %.3f ms",
                len(rtts),
                max(classes.values()) + 1,
                max(rtts.values()),
            )
        log.info("Probe summary: %s sent, %s answered", sent, answered)

    async def _handle_ping(self, ping: Ping) -> None:
        """Answer a peer's probe directly to its origin. Unsigned and
        stateless by design (see messages.Ping); an origin key outside
        every known epoch simply gets no reply."""
        addr = self.epochs.address(ping.origin)
        if addr is not None:
            net.note_ping_received(addr)
        await self._transmit(
            Pong(ping.origin, self.name, ping.seq, ping.sent_at_us), ping.origin
        )

    async def _handle_pong(self, pong: Pong) -> None:
        if pong.origin != self.name:
            return  # a misrouted (or forged) echo of someone else's probe
        addr = self.epochs.address(pong.responder)
        if addr is None:
            return
        rtt = (
            asyncio.get_running_loop().time() - pong.sent_at_us / 1e6
        )
        if rtt < 0:
            return  # echoed stamp from the future: not our clock's probe
        net.note_pong_rtt(addr, rtt)
        tracing.event(
            "net.probe",
            None,
            dur=rtt,
            peer=f"{addr[0]}:{addr[1]}",
            seq=pong.seq,
        )

    # -- main loop -----------------------------------------------------------

    async def run(self) -> None:
        await self._load_safety_state()
        # Rebuild committed epoch boundaries BEFORE processing traffic: a
        # node restarting past a committee switch must judge certificates
        # with the epoch knowledge its crashed incarnation had persisted.
        await self.epochs.load(self.store)
        self.epochs.note_round(self.round)
        self.synchronizer.note_committed(self.last_committed_round)
        self.timer = Timer(self.parameters.timeout_delay)
        if self.parameters.probe_interval_ms > 0:
            spawn(self._probe_loop(), name="consensus-probe")

        # Bootstrap: the round-1 leader proposes immediately (core.rs:446-454).
        if self.leader_elector.get_leader(self.round) == self.name:
            await self._generate_proposal(None)

        selector = Selector()
        selector.add("message", self.core_channel.get)
        # The pacemaker loses ties: a proposal already queued when the timer
        # expires must be processed first, or _local_timeout_round's
        # last_voted_round bump would withhold the vote for a block that
        # arrived in time (the reference's randomized select! has this race
        # half the time; here it is deterministic).
        selector.add("timer", self.timer.wait, priority=1)
        while True:
            branch, value = await selector.next()
            try:
                if branch == "timer":
                    # Discard stale expiries that raced a reset() (a message
                    # advancing the round may have completed the timer branch
                    # before the reset took effect).
                    if self.timer.expired():
                        await self._local_timeout_round()
                elif isinstance(value, Block):
                    await self._handle_proposal(value)
                elif isinstance(value, Vote):
                    await self._handle_vote(value)
                elif isinstance(value, Timeout):
                    await self._handle_timeout(value)
                elif isinstance(value, VoteBundle):
                    await self._handle_vote_bundle(value)
                elif isinstance(value, TimeoutBundle):
                    await self._handle_timeout_bundle(value)
                elif isinstance(value, AggVoteBundle):
                    await self._handle_agg_vote_bundle(value)
                elif isinstance(value, AggTimeoutBundle):
                    await self._handle_agg_timeout_bundle(value)
                elif isinstance(value, (TC, AggTC)):
                    await self._handle_tc(value)
                elif isinstance(value, SyncRequest):
                    await self._handle_sync_request(value)
                elif isinstance(value, SyncRangeRequest):
                    await self._handle_sync_range_request(value)
                elif isinstance(value, SyncRangeReply):
                    await self._handle_sync_range_reply(value)
                elif isinstance(value, Ping):
                    await self._handle_ping(value)
                elif isinstance(value, Pong):
                    await self._handle_pong(value)
                elif isinstance(value, LoopBack):
                    await self._process_block(value.block)
                else:
                    log.warning("unexpected core message: %r", value)
            except ConsensusError as e:
                log.warning("%s", e)
            except Exception as e:
                # A transient failure (e.g. a crypto-backend error surfaced
                # through verify_async) must not kill the consensus actor:
                # the message is dropped, the protocol's retry machinery
                # (pacemaker, sync tickers) recovers the state.
                log.error("consensus core error: %r", e)
