"""Block-ancestry synchronizer (reference consensus/src/synchronizer.rs).

When a block's parent is missing locally, the synchronizer:
  1. requests the parent digest from ONE deterministically chosen peer
     (full-committee broadcast only after a retry — the fan-out
     escalation that tames retry storms; synchronizer.rs:56-65
     broadcasts immediately),
  2. spawns a waiter on store.notify_read(parent) that re-injects the
     blocked block into the core via LoopBack once the parent is stored
     (:104-107,68-76),
  3. re-sends stale requests every TIMER_ACCURACY ms, implementing a
     "perfect point-to-point link" over the fire-and-forget network
     (:79-93).

Catch-up extensions beyond the reference:

  * RANGE SYNC — when the blocked block sits more than
    RANGE_SYNC_THRESHOLD rounds past our committed round (a node joining
    from genesis, or returning after a long crash), a per-digest fetch
    would crawl: one block per request/retry cycle. Instead the
    synchronizer sends a SyncRangeRequest for the whole missing ancestor
    chain; the peer answers with up to MAX_RANGE_BATCH blocks oldest-
    first (consensus/messages.py), each verified through the normal
    proposal path, and the core chains the next batch eagerly
    (`continue_range`) until the target resolves.
  * UNVERIFIED PARKING — a proposal the node cannot validate yet
    (`fetch_unverified`): during an epoch reconfiguration a lagging node
    may receive blocks certified by a committee it has not learned
    (consensus/reconfig.py). The block is parked and RE-INJECTED RAW
    (not as LoopBack) once its parent arrives, so the core re-runs FULL
    validation with the epoch knowledge the synced ancestors installed.
    Nothing is trusted meanwhile: parked blocks only direct which
    ancestry to fetch.
  * CLEANUP — `cleanup(round_)` drops pending fetches and cancels
    waiters for branches at or below the committed round: an abandoned
    fork's entries used to live (and retry!) forever, since only a
    successful waiter popped them.

Sync traffic (requests, range requests) rides the network's URGENT
egress lane: it is the recovery path that un-stalls consensus and must
not queue behind bulk gossip (network/net.py NetSender lanes).

The port's copy of `hotstuff_tpu/consensus/synchronizer.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from ..crypto import Digest, PublicKey, sha512_32
from ..network.net import Address, NetMessage
from ..store import Store
from ..utils import metrics, tracing
from ..utils.actors import spawn
from .messages import (
    MAX_RANGE_BATCH,
    Block,
    LoopBack,
    Round,
    SyncRangeRequest,
    SyncRequest,
    decode_stored_block,
    encode_consensus_message,
)
from .reconfig import as_manager

log = logging.getLogger("hotstuff.consensus")

TIMER_ACCURACY_MS = 5_000  # reference synchronizer.rs TIMER_ACCURACY

# Gap (blocked round - committed round) beyond which a per-digest fetch
# switches to batched range sync. Also the core's threshold for parking
# unverifiable far-ahead proposals (core.py CATCHUP path).
RANGE_SYNC_THRESHOLD = 8

# Bound on concurrently tracked blocked blocks: a Byzantine flood of
# fabricated far-future proposals must not grow the waiter set without
# limit (cleanup() reclaims abandoned entries as rounds commit).
WAITING_CAP = 1_024

# Serve-side bound on the ancestor walk answering one range request.
RANGE_WALK_CAP = 1_024

_M_SYNC_REQUESTS = metrics.counter("consensus.sync_requests")
_M_SYNC_RETRIES = metrics.counter("consensus.sync_retries")
_M_SYNC_ABANDONED = metrics.counter("consensus.sync_abandoned")
_M_SYNC_ESCALATIONS = metrics.counter("consensus.sync_escalations")
_M_RANGE_REQUESTS = metrics.counter("sync.range_requests")


@dataclass(slots=True)
class _Fetch:
    """State of one missing-parent fetch (keyed by the parent digest)."""

    ts: float  # last request instant (loop clock)
    round: Round  # round of the BLOCKED block (for cleanup)
    attempts: int = 0  # sends so far; >= 1 escalates to full broadcast
    ranged: bool = False  # batched range fetch instead of per-digest
    from_round: Round = 0  # floor sent with the last range request
    announced: bool = False  # "Range sync started" logged once


async def collect_range(
    store: Store,
    target: Digest,
    from_round: Round,
    cap: int = MAX_RANGE_BATCH,
    walk_cap: int = RANGE_WALK_CAP,
) -> list[Block]:
    """Serve-side walk: the ancestor chain ENDING at `target` (inclusive),
    truncated below at `from_round` (exclusive) and above at `cap`
    OLDEST blocks — the receiver must be able to verify each block
    against its already-stored parent, so a capped reply keeps the old
    end, not the new one. Returns [] when `target` is unknown."""
    chain: list[Block] = []
    digest = target
    for _ in range(walk_cap):
        raw = await store.read(digest.data)
        if raw is None:
            if not chain:
                return []  # unknown target: nothing to serve
            break
        block = decode_stored_block(raw)
        if block.round <= from_round:
            break
        chain.append(block)
        if block.qc.is_genesis():
            break
        digest = block.parent()
    chain.reverse()  # oldest first
    return chain[:cap]


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee,  # Committee or reconfig.EpochManager
        store: Store,
        network_tx: asyncio.Queue,
        core_channel: asyncio.Queue,
        sync_retry_delay: int,
    ) -> None:
        self.name = name
        self.epochs = as_manager(committee)
        self.store = store
        self.network_tx = network_tx
        self.core_channel = core_channel
        self.sync_retry_delay = sync_retry_delay
        # parent digest -> fetch state (network request dedup/retry)
        self._pending: dict[Digest, _Fetch] = {}
        # blocked block digest -> (waiter task, blocked round): one waiter
        # per BLOCKED block — two different blocks may await the same
        # parent (reference synchronizer.rs:51 keys pending this way).
        self._waiting: dict[Digest, tuple[asyncio.Task, Round]] = {}
        self._committed_round: Round = 0
        self._retry_task = spawn(self._retry_loop(), name="consensus-sync-retry")

    @property
    def committee(self):
        return self.epochs.current()

    # -- commit-path bookkeeping --------------------------------------------

    def note_committed(self, round_: Round) -> None:
        self._committed_round = max(self._committed_round, round_)

    def cleanup(self, round_: Round) -> None:
        """Reclaim fetches for abandoned branches: a blocked block at or
        below the committed round can never commit (its round is taken),
        so its waiter task and retry entry are dead weight — and without
        this, `_pending` retries an unreachable digest forever (the
        pre-reconfig leak). Called from the core's commit path."""
        for blocked, (task, rnd) in list(self._waiting.items()):
            if rnd <= round_:
                task.cancel()
                del self._waiting[blocked]
                _M_SYNC_ABANDONED.inc()
        for digest, fetch in list(self._pending.items()):
            if fetch.round <= round_:
                del self._pending[digest]

    # -- fetch paths ---------------------------------------------------------

    async def get_parent_block(self, block: Block) -> Block | None:
        """Return the parent, or None after registering fetch + loopback
        (synchronizer.rs:131-145)."""
        if block.qc.is_genesis():
            return Block.genesis()
        parent = block.parent()
        raw = await self.store.read(parent.data)
        if raw is not None:
            return decode_stored_block(raw)
        await self._register(parent, block, reverify=False)
        return None

    async def get_ancestors(self, block: Block) -> tuple[Block, Block] | None:
        """(b0, b1) = grandparent, parent -- the 2-chain needed for the commit
        rule (synchronizer.rs:147-161)."""
        b1 = await self.get_parent_block(block)
        if b1 is None:
            return None
        b0 = await self.get_parent_block(b1)
        if b0 is None:
            # Parent present but grandparent missing: extremely rare (parent
            # was stored only after ITS ancestry check); waiter handles it.
            return None
        return b0, b1

    async def fetch_unverified(self, block: Block) -> bool:
        """Catch-up parking for a proposal that FAILED validation while
        sitting far past our round (possibly certified by an epoch we
        have not learned — see module docstring). Registers a range
        fetch for its claimed ancestry and arranges the RAW block's
        re-injection (full revalidation) once the parent arrives.
        Returns False when the parked set is at capacity (caller should
        drop the block and let retries recover)."""
        blocked = block.digest()
        if blocked not in self._waiting and len(self._waiting) >= WAITING_CAP:
            return False
        await self._register(block.parent(), block, reverify=True)
        return True

    async def fetch_certified(self, digest: Digest, round_: Round) -> bool:
        """Fetch a block we only know as a CERTIFICATE reference (a
        Timeout's embedded high_qc hash) that our store lacks.

        Two callers, one mechanism (consensus/core._handle_timeout):

        * stale-epoch BOOTSTRAP — a joiner admitted at an epoch boundary
          (or a node that missed several boundaries) may be unable to
          verify ANY live traffic, while the committee needs that very
          node for quorum, so no proposals flow and the proposal-parking
          seam (`fetch_unverified`) never fires; the unverifiable
          timeouts' high_qc still names a chain position to fetch;
        * certified-gap CLOSURE — a verified timeout's high_qc certifies
          a block we never received (the node ran ahead of its floor by
          adopting certificates during a stall); nothing else would ever
          deliver the block, since proposals reference it only as
          ancestry of FUTURE rounds that cannot form while the committee
          waits for this node.

        Nothing is trusted from the container — the digest only directs
        which ancestry to fetch, and every served block re-runs full
        validation. Per-digest for small gaps, batched range sync past
        RANGE_SYNC_THRESHOLD. Bounded: digest dedup, WAITING_CAP, and a
        one-range-pipeline gate (one catch-up at a time)."""
        gap = round_ - self._committed_round
        if gap <= 0:
            return False
        if digest in self._pending or digest in self._waiting:
            return False
        ranged = gap > RANGE_SYNC_THRESHOLD
        if ranged and any(f.ranged for f in self._pending.values()):
            return False  # an active pipeline is already closing the gap
        if len(self._waiting) >= WAITING_CAP:
            return False
        if await self.store.read(digest.data) is not None:
            return False
        fetch = _Fetch(
            ts=asyncio.get_running_loop().time(), round=round_, ranged=ranged
        )
        self._pending[digest] = fetch
        self._waiting[digest] = (
            spawn(
                self._certified_waiter(digest),
                name=f"sync-certified-{digest.short()}",
            ),
            round_,
        )
        await self._send(digest, fetch)
        return True

    async def _certified_waiter(self, digest: Digest) -> None:
        # No re-injection: the range replay already ran every block
        # (including the target) through the full proposal path — this
        # waiter only reclaims the fetch/waiting entries on arrival.
        await self.store.notify_read(digest.data)
        self._pending.pop(digest, None)
        self._waiting.pop(digest, None)

    async def _register(
        self, parent: Digest, block: Block, reverify: bool
    ) -> None:
        blocked = block.digest()
        if blocked not in self._waiting:
            if len(self._waiting) >= WAITING_CAP:
                log.warning(
                    "sync waiter set at capacity (%d); dropping %s",
                    WAITING_CAP,
                    block,
                )
                return
            self._waiting[blocked] = (
                spawn(
                    self._waiter(parent, block, reverify),
                    name=f"sync-wait-{parent.short()}",
                ),
                block.round,
            )
        if parent not in self._pending:
            # Loop clock, not time.monotonic(): identical on a production
            # loop, but under the chaos runner's virtual-time loop the
            # retry schedule must follow VIRTUAL time or dropped sync
            # requests would never be re-sent (wall time barely moves).
            gap = block.round - self._committed_round
            fetch = _Fetch(
                ts=asyncio.get_running_loop().time(),
                round=block.round,
                ranged=gap > RANGE_SYNC_THRESHOLD,
            )
            self._pending[parent] = fetch
            if fetch.ranged and any(
                f.ranged and f.round <= fetch.round
                for f in self._pending.values()
                if f is not fetch
            ):
                # Suppress a ranged send while a DEEPER (or equal) range
                # pipeline is active: during catch-up every live proposal
                # suspends on a DIFFERENT parent, and firing a
                # SyncRangeRequest per round would fan out near-identical
                # 64-block batches (the chains share ancestry). The entry
                # is registered but not sent: as the active pipeline
                # closes the gap, the waiter cascade resolves these; the
                # retry timer covers the residue if the active fetch
                # dies. A fetch BELOW every active one always sends — it
                # is the connecting fetch when a gap exceeds the serve
                # walk cap and a batch arrives detached from the
                # committed floor (its blocks suspend on an ancestor the
                # batch did not reach).
                return
            await self._send(parent, fetch)

    async def continue_range(self, target: Digest) -> None:
        """Eager batch chaining: the core processed a range reply that
        advanced the committed floor but the target is still missing —
        request the next batch immediately instead of waiting out the
        retry timer. No-progress replies deliberately fall through to the
        timer (a peer serving junk must not drive a hot request loop)."""
        fetch = self._pending.get(target)
        if fetch is None or not fetch.ranged:
            return
        if self._committed_round <= fetch.from_round:
            return  # no forward progress since the last request
        fetch.ts = asyncio.get_running_loop().time()
        # The deterministic first-choice peer just served a good batch:
        # keep the continuation on it instead of escalating to broadcast
        # (retries still escalate via the timer if it goes quiet).
        fetch.attempts = 0
        await self._send(target, fetch)

    async def _waiter(self, digest: Digest, blocked: Block, reverify: bool) -> None:
        await self.store.notify_read(digest.data)
        self._pending.pop(digest, None)
        self._waiting.pop(blocked.digest(), None)
        # Parked-unverified blocks re-enter as RAW proposals so the core
        # re-runs leader/signature/epoch validation with the ancestors
        # (and any committed epoch switches) now in place; ordinary
        # suspended blocks were already validated and LoopBack straight
        # into ordering.
        await self.core_channel.put(blocked if reverify else LoopBack(blocked))

    # -- request fan-out -----------------------------------------------------

    def _peers(self, digest: Digest, attempts: int) -> list[Address]:
        """Escalating fan-out: the first request goes to ONE peer chosen
        as a pure function of (digest, own key) — deterministic under
        chaos replay, uniformly spread across the committee — and only a
        retry escalates to the full broadcast. The old always-broadcast
        behaviour turned every missing digest into n-1 frames per retry
        tick across the whole committee (the retry-storm satellite)."""
        addrs = sorted(self.epochs.current().broadcast_addresses(self.name))
        if not addrs:
            return []
        if attempts == 0:
            i = int.from_bytes(
                sha512_32(digest.data + self.name.data)[:8], "little"
            ) % len(addrs)
            return [addrs[i]]
        return addrs

    async def _send(self, digest: Digest, fetch: _Fetch) -> None:
        addrs = self._peers(digest, fetch.attempts)
        if not addrs:
            return
        if fetch.attempts == 1:
            _M_SYNC_ESCALATIONS.inc()
        if fetch.ranged:
            _M_RANGE_REQUESTS.inc()
            fetch.from_round = self._committed_round
            if not fetch.announced:
                fetch.announced = True
                # NOTE: parsed by the benchmark LogParser (catch-up lag).
                log.info(
                    "Range sync started for %s: %d rounds behind",
                    digest.short(),
                    max(fetch.round - self._committed_round, 0),
                )
            if tracing.enabled():
                tracing.event(
                    "sync.request", digest=digest.short(), range=True,
                    from_round=fetch.from_round,
                )
            msg = SyncRangeRequest(digest, fetch.from_round, self.name)
        else:
            _M_SYNC_REQUESTS.inc()
            if tracing.enabled():
                tracing.event("sync.request", digest=digest.short())
            msg = SyncRequest(digest, self.name)
        fetch.attempts += 1
        data = encode_consensus_message(msg)
        # Urgent lane: recovery traffic must not queue behind bulk gossip.
        await self.network_tx.put(NetMessage(data, addrs, urgent=True))

    async def _retry_loop(self) -> None:
        while True:
            await asyncio.sleep(TIMER_ACCURACY_MS / 1000.0)
            await self._retry_pass(asyncio.get_running_loop().time())

    async def _retry_pass(self, now: float) -> None:
        """One sweep over the pending fetches (factored out of the loop
        for the frame-count regression tests). Re-sends any fetch whose
        last request is older than sync_retry_delay, escalating the
        fan-out (see `_peers`); `ts` resets so consecutive retries are
        spaced by the full retry delay, not the timer tick."""
        for digest, fetch in list(self._pending.items()):
            if (now - fetch.ts) * 1000.0 >= self.sync_retry_delay:
                log.debug("retrying sync request for %s", digest.short())
                _M_SYNC_RETRIES.inc()
                if tracing.enabled():
                    tracing.event("sync.retry", digest=digest.short())
                fetch.ts = now
                await self._send(digest, fetch)
