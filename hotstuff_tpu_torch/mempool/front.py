"""Client-facing transaction listener (reference mempool/src/front.rs).

Accepts raw length-delimited transaction bytes from load generators / clients
and forwards them into the PayloadMaker's channel. No authentication: this is
the benchmark ingress port, exactly as in the reference.

The port's copy of `hotstuff_tpu/mempool/front.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging

from ..network.net import Address, FrameReader
from ..utils import metrics
from ..utils.actors import spawn

log = logging.getLogger("hotstuff.mempool")

_M_FRONT_DROPPED = metrics.counter("mempool.front_dropped")


class Front:
    """Admission control at the ingress (SURVEY §5.3): the intake queue is
    bounded with drop-OLDEST overflow. Blocking on a full queue looks
    gentler but is worse under sustained overload — every queued tx ages
    while it waits, so the node spends its capacity committing stale
    transactions nobody is waiting for anymore, and end-to-end latency
    grows without bound. Dropping the oldest keeps the queue fresh and
    makes throughput flat (not collapsing) past saturation.

    The deliver queue's BOUND is the admission policy's other half:
    Mempool.run sizes it from `MempoolParameters.front_queue_capacity`
    (the previous implicit channel default left the bound undeclared),
    and every eviction counts into `mempool.front_dropped` — the same
    shed-visibility contract the authenticated ingress lanes
    (hotstuff_tpu/ingress) carry, minus the per-client backpressure
    response this anonymous port cannot deliver."""

    LOG_EVERY = 10_000  # dropped-tx log cadence

    def __init__(self, address: Address, deliver: asyncio.Queue) -> None:
        self._address = address
        self._deliver = deliver
        self.dropped = 0
        spawn(self._run(), name="front")

    async def _run(self) -> None:
        server = await asyncio.start_server(
            self._handle, host=self._address[0], port=self._address[1]
        )
        log.debug("front listening on %s", self._address)
        async with server:
            await server.serve_forever()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        frames = FrameReader(reader)
        while True:
            try:
                tx = await frames.next_frame()
            except ConnectionError:
                break
            if tx is None:
                break
            try:
                self._deliver.put_nowait(tx)
            except asyncio.QueueFull:
                # Drop-oldest: evict the stalest queued tx for the new one.
                try:
                    self._deliver.get_nowait()
                except asyncio.QueueEmpty:
                    pass
                self._deliver.put_nowait(tx)
                self.dropped += 1
                _M_FRONT_DROPPED.inc()
                if self.dropped % self.LOG_EVERY == 1:
                    log.warning(
                        "front overloaded: %s transactions dropped "
                        "(drop-oldest admission control)",
                        self.dropped,
                    )
        try:
            writer.close()
        except Exception:
            pass
