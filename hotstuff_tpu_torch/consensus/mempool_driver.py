"""Consensus-side proxy to the mempool (reference consensus/src/mempool.rs).

ConsensusMempoolMessage variants (mempool.rs:16-20):
  * Get(max, reply)        -> payload digests for a new block
  * Verify(block, reply)   -> payload availability: Accept / Reject / Wait
  * Cleanup(b0, b1, block) -> drop state for committed/ordered payloads

On Wait the mempool synchronizer fetches missing payloads and loops the block
back to the consensus core when they arrive, so `verify` simply returns False
and the core drops the block for now (consensus/src/mempool.rs:41-60).

The port's copy of `hotstuff_tpu/consensus/mempool_driver.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from enum import Enum

from .messages import Block


class PayloadStatus(Enum):
    ACCEPT = "accept"
    REJECT = "reject"
    WAIT = "wait"


@dataclass(slots=True)
class MempoolGet:
    max_size: int
    reply: asyncio.Future


@dataclass(slots=True)
class MempoolVerify:
    block: Block
    reply: asyncio.Future


@dataclass(slots=True)
class MempoolCleanup:
    b0: Block
    b1: Block
    block: Block


class MempoolDriver:
    def __init__(self, mempool_channel: asyncio.Queue) -> None:
        self._tx = mempool_channel

    async def get(self, max_size: int) -> list:
        fut = asyncio.get_running_loop().create_future()
        await self._tx.put(MempoolGet(max_size, fut))
        return await fut

    async def verify(self, block: Block) -> bool:
        """True iff all payloads are locally available (Accept). Reject raises;
        Wait returns False after the mempool registered a fetch+loopback."""
        if not block.payload:
            return True
        fut = asyncio.get_running_loop().create_future()
        await self._tx.put(MempoolVerify(block, fut))
        status = await fut
        if status == PayloadStatus.REJECT:
            from .errors import MalformedBlockError

            raise MalformedBlockError(f"invalid payload in {block}")
        return status == PayloadStatus.ACCEPT

    async def cleanup(self, b0: Block, b1: Block, block: Block) -> None:
        await self._tx.put(MempoolCleanup(b0, b1, block))
