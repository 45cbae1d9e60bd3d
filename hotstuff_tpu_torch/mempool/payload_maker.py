"""Transaction batching actor (reference mempool/src/payload.rs).

Accumulates client transactions and flushes a signed Payload when the batch
would exceed max_payload_size (then pauses min_block_delay, pacing block
production, payload.rs:43-53) or on-demand when consensus needs a payload and
the queue is empty (`make`, payload.rs:55-63,120).

Intake is PER-PLANE (the scheduler source-class split applied to the
mempool seam): the anonymous Front feeds `tx_in` (bounded,
drop-oldest at the Front), the authenticated ingress pipeline feeds its
own `ingress_in` lane (bounded, BLOCKING producer). The earlier coexistence
caveat — the Front's drop-oldest overflow evicting accepted ingress
bodies out of a shared queue — is structurally gone: an eviction in one
lane cannot touch the other, and the ingress lane's backpressure chain
(full lane → pipeline drain blocks → admission sheds with retry-after)
actually engages instead of being defeated by Front evictions freeing
slots.

The port's copy of `hotstuff_tpu/mempool/payload_maker.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import PublicKey, SignatureService
from ..utils import metrics, tracing
from ..utils.actors import Selector, channel, spawn
from .messages import OwnPayload, Payload, Transaction

log = logging.getLogger("hotstuff.mempool")

_M_INGRESS_TXS = metrics.counter("mempool.ingress_lane_txs")

# How often the guarded ingress intake re-checks a standing backlog; only
# ever polled while the core queue is at capacity (see _ingress_get).
_BACKLOG_POLL_S = 0.05


class PayloadMaker:
    def __init__(
        self,
        name: PublicKey,
        signature_service: SignatureService,
        max_payload_size: int,
        min_block_delay: int,
        tx_in: asyncio.Queue,
        core_channel: asyncio.Queue,
        ingress_in: asyncio.Queue | None = None,
        proof_registry=None,
    ) -> None:
        self.name = name
        self.signature_service = signature_service
        self.max_payload_size = max_payload_size
        self.min_block_delay = min_block_delay
        self.tx_in = tx_in
        self.ingress_in = ingress_in
        self.core_channel = core_channel
        # Commit-proof serving plane: flushed ingress bodies are paired
        # back to their admitted tx digests under the payload digest, so
        # a later commit of that payload resolves (client, nonce) →
        # proof (proofs/registry.py note_payload).
        self.proof_registry = proof_registry
        self._make_requests: asyncio.Queue = channel()
        self._buffer: list[Transaction] = []
        self._size = 0
        # Load shedding (set by Mempool.run): when this returns True the
        # mempool queue is at capacity, and flushing another payload would
        # only burn a signature + a committee broadcast before the insert
        # fails with QueueFullError (core.rs:131). Shed incoming FRONT txs
        # instead, so throughput stays flat past saturation; the ingress
        # lane never sheds here — its intake pauses and backpressure
        # propagates to admission (see _ingress_get).
        self.backlog_fn = lambda: False
        self.shed = 0
        self._backlogged = False  # last observed backpressure state
        spawn(self._run(), name="payload-maker")

    async def request_make(self) -> Payload:
        """Force an immediate flush; returns the payload (possibly empty).
        Used by the mempool core when consensus asks for digests and the
        queue is dry (mempool/src/core.rs:251-268)."""
        fut = asyncio.get_running_loop().create_future()
        await self._make_requests.put(fut)
        return await fut

    async def _make(self) -> Payload:
        # Never emit a payload past the wire cap: backlog-buffered ingress
        # txs append WITHOUT flushing (both flush conditions in _ingest are
        # gated off under backlog), so the buffer can sit over
        # max_payload_size when the backlog clears — and an oversized
        # payload fails every peer's `payload.size() <= max_payload_size`
        # ingress check (core.py), a forever-unavailable digest that would
        # stall any block referencing it. Split at the cap; the remainder
        # stays buffered for the next flush/make (every single tx fits:
        # oversized ones are dropped at _ingest).
        split, taken = 0, 0
        for tx in self._buffer:
            if taken + len(tx) > self.max_payload_size and split:
                break
            taken += len(tx)
            split += 1
        txs, self._buffer = self._buffer[:split], self._buffer[split:]
        self._size -= taken
        digest = Payload.make_digest(self.name, txs)
        if self.proof_registry is not None and txs:
            self.proof_registry.note_payload(txs, digest)
        signature = await self.signature_service.request_signature(digest)
        payload = Payload(tuple(txs), self.name, signature)
        object.__setattr__(payload, "_digest", digest)  # seed the cache
        return payload

    async def _ingest(self, tx: Transaction, shed_ok: bool = True) -> None:
        backlogged = self.backlog_fn()
        if backlogged != self._backlogged or backlogged:
            # Transitions land in the flight recorder; sustained pressure
            # feeds the anomaly watchdog (the freeze signature:
            # cold-lane egress pinned at capacity while rounds stall).
            self._backlogged = backlogged
            tracing.WATCHDOG.note_backpressure(backlogged)
        if backlogged and shed_ok:
            self.shed += 1
            if self.shed % 10_000 == 1:
                log.warning(
                    "payload maker shedding: %s transactions dropped "
                    "(mempool queue at capacity)",
                    self.shed,
                )
            return
        if len(tx) > self.max_payload_size:
            # A single oversized tx would flush as a payload every honest
            # peer rejects at ingress (PayloadTooBigError), leaving a
            # forever-unavailable digest in our queue. Drop it here.
            log.warning(
                "dropping oversized transaction (%s B > %s B cap)",
                len(tx),
                self.max_payload_size,
            )
            return
        if not shed_ok:
            _M_INGRESS_TXS.inc()
        # While backlogged, a shed_ok=False (ingress) tx BUFFERS without
        # flushing: _ingress_get stops consuming under backlog, so at most
        # the already-armed item lands here, and flushing now would sign +
        # gossip a payload the full core queue rejects (QueueFullError —
        # the whole payload, front txs included, would be lost).
        if (
            self._size + len(tx) > self.max_payload_size
            and self._buffer
            and not backlogged
        ):
            await self._flush()
        self._buffer.append(tx)
        self._size += len(tx)
        if self._size >= self.max_payload_size and not backlogged:
            await self._flush()

    async def _flush(self) -> None:
        payload = await self._make()
        await self.core_channel.put(OwnPayload(payload))
        if self.min_block_delay:
            # Pace block production (payload.rs:49-52).
            await asyncio.sleep(self.min_block_delay / 1000.0)

    async def _ingress_get(self) -> Transaction:
        """Guarded ingress intake: holds off CONSUMING while the core
        queue is backlogged — the lane is bounded and its producer (the
        IngressPipeline drain) blocks on put, which is the backpressure
        chain that ends in admission shedding with a retry-after hint.
        Consuming during backlog would instead strand an accepted body in
        the buffer (or force a shed the client was already promised
        ACCEPTED against)."""
        while self.backlog_fn():
            await asyncio.sleep(_BACKLOG_POLL_S)
        return await self.ingress_in.get()

    async def _run(self) -> None:
        selector = Selector()
        selector.add("tx", self.tx_in.get)
        if self.ingress_in is not None:
            # Lower priority number = wins same-instant races: an accepted
            # ingress body (client already told ACCEPTED) beats anonymous
            # Front traffic into the buffer.
            selector.add("ingress", self._ingress_get, priority=-1)
        selector.add("make", self._make_requests.get)
        while True:
            branch, value = await selector.next()
            if branch == "make":
                payload = await self._make()
                if not value.cancelled():
                    value.set_result(payload)
                continue
            await self._ingest(value, shed_ok=branch == "tx")
            # Drain whatever is already queued without an event-loop
            # round trip per transaction (~13% of node CPU at 4k tx/s
            # went to per-tx actor wakeups before this) — but yield to
            # any pending consensus-driven make request: starving it
            # would stall Core._get_payload and halt round progress.
            # NOTE: the request may sit in the selector's armed task
            # (which already consumed the queue item), so check both.
            # Ingress drains first (lane priority), and only while the
            # core queue has room — mirroring _ingress_get's guard.
            while not selector.ready("make") and self._make_requests.empty():
                if self.ingress_in is not None and not self.backlog_fn():
                    try:
                        tx = self.ingress_in.get_nowait()
                    except asyncio.QueueEmpty:
                        pass
                    else:
                        await self._ingest(tx, shed_ok=False)
                        continue
                try:
                    tx = self.tx_in.get_nowait()
                except asyncio.QueueEmpty:
                    break
                await self._ingest(tx)
