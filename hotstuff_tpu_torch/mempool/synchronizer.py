"""Payload-availability synchronizer (reference mempool/src/synchronizer.rs).

When consensus asks whether a block's payloads are locally available
(`verify_payload`, synchronizer.rs:197-214):
  * all present  -> ACCEPT
  * any missing  -> send a PayloadRequest to the block's author, spawn a
    cancellable waiter on notify_read of ALL missing digests
    (try_join_all, :158-173), and return WAIT; when the last payload arrives
    the block is looped back to the consensus core (:114).
Waiters are cancelled when their block's round is cleaned up (:216), and a
retry ticker re-broadcasts stale requests (:123-147).

The port's copy of `hotstuff_tpu/mempool/synchronizer.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import Digest, PublicKey
from ..network.net import NetMessage
from ..store import Store
from ..utils.actors import spawn
from ..consensus.messages import Block, LoopBack
from ..consensus.mempool_driver import PayloadStatus
from .messages import PayloadRequest, encode_mempool_message

log = logging.getLogger("hotstuff.mempool")

TIMER_ACCURACY_MS = 5_000


class Synchronizer:
    def __init__(
        self,
        name: PublicKey,
        committee,  # MempoolCommittee | MempoolEpochView (epoch-aware)
        store: Store,
        network_tx: asyncio.Queue,
        consensus_channel: asyncio.Queue,
        sync_retry_delay: int,
    ) -> None:
        self.name = name
        self.committee = committee
        self.store = store
        self.network_tx = network_tx
        self.consensus_channel = consensus_channel
        self.sync_retry_delay = sync_retry_delay
        # block digest -> (round, waiter task, requested payload digests, ts)
        self._pending: dict[Digest, tuple[int, asyncio.Task, tuple[Digest, ...], float]] = {}
        spawn(self._retry_loop(), name="mempool-sync-retry")

    async def verify_payload(self, block: Block) -> PayloadStatus:
        missing = []
        for digest in block.payload:
            if await self.store.read(b"payload:" + digest.data) is None:
                missing.append(digest)
        if not missing:
            return PayloadStatus.ACCEPT
        block_digest = block.digest()
        if block_digest not in self._pending:
            log.debug(
                "%s missing %d payloads; requesting from author", block, len(missing)
            )
            waiter = spawn(
                self._waiter(block, tuple(missing)),
                name=f"payload-wait-{block_digest.short()}",
            )
            self._pending[block_digest] = (
                block.round,
                waiter,
                tuple(missing),
                # Loop clock (== monotonic in production): the chaos
                # runner's virtual-time loop must drive the retry schedule.
                asyncio.get_running_loop().time(),
            )
            await self._request(tuple(missing), [block.author])
        return PayloadStatus.WAIT

    async def _waiter(self, block: Block, missing: tuple[Digest, ...]) -> None:
        await asyncio.gather(
            *(self.store.notify_read(b"payload:" + d.data) for d in missing)
        )
        self._pending.pop(block.digest(), None)
        await self.consensus_channel.put(LoopBack(block))

    async def _request(
        self, digests: tuple[Digest, ...], authors: list[PublicKey] | None
    ) -> None:
        data = encode_mempool_message(PayloadRequest(digests, self.name))
        if authors is None:  # retry path: broadcast
            # Epoch-aware: the CURRENT committee (a MempoolEpochView
            # resolves it through the shared EpochManager) — after a
            # boundary, retries reach the members who actually hold the
            # successor epoch's payloads.
            addrs = self.committee.broadcast_addresses(self.name)
        else:
            addrs = [
                a
                for a in (self.committee.mempool_address(x) for x in authors)
                if a is not None
            ]
        if addrs:
            # Urgent: a sync request stuck behind the very gossip backlog
            # that caused the miss would never un-stall consensus.
            await self.network_tx.put(NetMessage(data, addrs, urgent=True))

    def cleanup(self, round_: int) -> None:
        """Cancel waiters for blocks at or below the committed round
        (synchronizer.rs:216-221)."""
        for digest, (r, task, _, _) in list(self._pending.items()):
            if r <= round_:
                task.cancel()
                del self._pending[digest]

    async def _retry_loop(self) -> None:
        while True:
            await asyncio.sleep(TIMER_ACCURACY_MS / 1000.0)
            now = asyncio.get_running_loop().time()
            for digest, (r, task, missing, ts) in list(self._pending.items()):
                if (now - ts) * 1000.0 >= self.sync_retry_delay:
                    log.debug("retrying payload request for block %s", digest.short())
                    await self._request(missing, None)
