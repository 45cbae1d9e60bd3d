"""IngressPipeline: admission → batched signature verification → sink.

A copy of `hotstuff_tpu/ingress/pipeline.py` for the port. Client
transactions are admitted (`admission.py`), their ed25519 signatures
verified in groups of `IngressConfig.verify_batch` through a
`BatchVerificationService` (`crypto/batch_service.py`, and so the card's
`TorchBackend` with its crossover routing), tagged `source="ingress"`,
`committee=False` (client keys are never in the validator table) and
`dedup=False` (a repeated client transaction is a replay, which admission
rejects before any crypto, so client traffic never enters the
verified-signature cache), and only then forwarded into `deliver`, a
bounded sink (the node's mempool ingress lane; the bench's counter).
With a `proof_registry` (`proofs/registry.py`), every verified
transaction's (client, nonce) and digest are recorded there just before
its body goes into the sink: the first link of the submit, commit, proof
chain.

Backpressure is end to end: a full sink blocks the drain loop, the lanes
fill, and admission sheds with retry-after. A dispatch that fails marks
its whole batch BAD_SIGNATURE, as in the reference (nothing unverified
is ever forwarded); `ingress.rejected_sigs` counts it, so a failing card
shows there.

Every stage records `ingress.*` flight-recorder events (`utils/tracing.py`;
trace id from the transaction digest) and counts into the `ingress.*`
metrics.

One change against the reference: the drain keeps up to `DRAIN_WIDTH`
batches in verification at once, each answered and forwarded as it
completes (the reference's drain takes one at a time, and so waits out the
scheduler's ingress deadline, the card's round trip and the event loop's
hops for every 64 transactions). A batch that is not full goes only while
none is in flight, so a sparse stream still gathers into batches behind
the one in verification, as in the reference; a backlog goes out in full
batches, `DRAIN_WIDTH` at a time.

With `IngressConfig.verify_interval` set (the chaos scenarios' drain pacer,
which models a verify capacity of verify_batch / verify_interval tx/s under
a virtual clock), the drain width is 1: one batch at a time, each holding
its slot for the pause after it, as in the reference, so the paced
capacity is the reference's too.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto.batch_service import BatchVerificationService
from ..utils import metrics, tracing
from ..utils.actors import spawn
from . import messages
from .admission import AdmissionController, IngressConfig
from .messages import ClientTransaction, IngressResponse

log = logging.getLogger("hotstuff.ingress")

_M_RECEIVED = metrics.counter("ingress.received")
_M_VERIFIED = metrics.counter("ingress.verified_sigs")
_M_REJECTED = metrics.counter("ingress.rejected_sigs")
_M_FORWARDED = metrics.counter("ingress.forwarded")
_M_VERIFY_BATCH = metrics.histogram(
    "ingress.verify_batch_size", metrics.SIZE_BUCKETS
)
_M_LATENCY = metrics.histogram("ingress.latency_s")

LOG_EVERY = 10_000  # shed/reject log cadence
DRAIN_WIDTH = 4  # verification batches the drain keeps in flight at once


class IngressPipeline:
    """One per node. `deliver` is the PayloadMaker's tx queue (or any
    bounded sink); `service` is the node's BatchVerificationService."""

    def __init__(
        self,
        service: BatchVerificationService,
        deliver: asyncio.Queue,
        config: IngressConfig | None = None,
        proof_registry=None,
    ) -> None:
        self.service = service
        self.deliver = deliver
        self.proof_registry = proof_registry
        self.admission = AdmissionController(config)
        self._pending = asyncio.Event()  # set whenever a lane has work or a batch completes
        self._in_flight = 0  # batches in verification
        self._task: asyncio.Task | None = None
        self.stats = {"received": 0, "accepted": 0, "responded": 0}

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            # actors.spawn: the drain loop joins the creating scope, so a
            # chaos crash of the owning node tears it down too.
            self._task = spawn(self._run(), name="ingress-drain")

    # -- submission ----------------------------------------------------------

    async def submit(self, tx: ClientTransaction) -> IngressResponse:
        """Submit one client transaction; resolves to its response once
        admission rejects it (immediately) or its verification batch
        completes and the body is in the mempool queue."""
        t0 = asyncio.get_running_loop().time()
        out = self.admit(tx)
        if isinstance(out, IngressResponse):
            return out
        return await self.result(out, t0)

    def admit(self, tx: ClientTransaction) -> IngressResponse | asyncio.Future:
        """`submit`'s admission step, without awaiting: the response of a
        transaction admission rejects (shed, replay, malformed), or the
        future its verification batch resolves (`result` awaits it). The
        TCP server answers a rejection inline, so a flood that admission
        sheds costs the event loop no task a frame."""
        self._ensure_task()
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        _M_RECEIVED.inc()
        self.stats["received"] += 1
        if tracing.enabled():
            tracing.event("ingress.recv", tracing.trace_id(0, tx.digest().data))
        future = loop.create_future()
        lane, status, retry_ms = self.admission.admit(tx, (tx, t0, future))
        if lane is None:
            if tracing.enabled():
                kind = (
                    "ingress.shed" if status == messages.SHED else "ingress.reject"
                )
                tracing.event(
                    kind,
                    tracing.trace_id(0, tx.digest().data),
                    status=messages.STATUS_NAMES.get(status, status),
                    retry_after_ms=retry_ms,
                )
            shed = self.admission.shed
            if status == messages.SHED and shed % LOG_EVERY == 1:
                log.warning(
                    "ingress overloaded: %s transactions shed with "
                    "retry-after backpressure", shed,
                )
            _M_LATENCY.record(loop.time() - t0)
            return IngressResponse(tx.nonce, status, retry_ms)
        if tracing.enabled():
            tracing.event(
                "ingress.admit", tracing.trace_id(0, tx.digest().data), lane=lane
            )
        self._pending.set()
        return future

    async def result(self, future: asyncio.Future, t0: float) -> IngressResponse:
        """An admitted transaction's response, `t0` (event-loop time) its
        arrival."""
        resp = await future
        _M_LATENCY.record(asyncio.get_running_loop().time() - t0)
        return resp

    # -- drain loop ----------------------------------------------------------

    async def _run(self) -> None:
        cfg = self.admission.config
        width = 1 if cfg.verify_interval else DRAIN_WIDTH
        while True:
            n = self._in_flight
            if n < width and (n == 0 or self.admission.depth() >= cfg.verify_batch):
                batch = self.admission.take(cfg.verify_batch)
                if batch:
                    self._in_flight += 1
                    if width == 1:
                        # Paced: awaited in this task, as the reference's
                        # drain is, so no task hop reorders a virtual instant.
                        await self._drain(batch)
                    else:
                        spawn(self._drain(batch), name="ingress-verify")
                    continue
            self._pending.clear()
            await self._pending.wait()

    async def _drain(self, batch: list) -> None:
        """Verify one batch and answer each transaction in it: forward the
        verified ones into the sink, reject the rest; then wake the drain
        loop."""
        cfg = self.admission.config
        try:
            loop = asyncio.get_running_loop()
            msgs = [tx.digest().data for tx, _t0, _f in batch]
            pairs = [(tx.client, tx.signature) for tx, _t0, _f in batch]
            _M_VERIFY_BATCH.record(len(batch))
            trace = None
            if tracing.enabled():
                # Batch-head trace id: tags the group's verify.batch event
                # so trace_report's verify-lane table attributes ingress
                # queueing delay alongside the consensus lane's.
                trace = tracing.trace_id(0, batch[0][0].digest().data)
                tracing.event("ingress.verify", trace, n=len(batch))
            try:
                mask = await self.service.verify_group(
                    msgs, pairs, urgent=False, committee=False, dedup=False,
                    source="ingress", trace=trace,
                )
            except Exception as e:
                # A backend failure must not wedge clients: fail the whole
                # batch as BAD_SIGNATURE (conservative — nothing unverified
                # ever reaches the mempool) and keep draining.
                log.warning("ingress verification dispatch failed: %r", e)
                mask = [False] * len(batch)
            accepted = 0
            for (tx, _t0, future), ok in zip(batch, mask):
                if ok:
                    _M_VERIFIED.inc()
                    accepted += 1
                    if self.proof_registry is not None:
                        self.proof_registry.note_tx(
                            tx.client, tx.nonce, tx.digest(), body=tx.body
                        )
                    # Bounded sink: blocking here is the backpressure path
                    # (lanes fill behind us, admission sheds with
                    # retry-after) — the one place ingress may wait.
                    await self.deliver.put(tx.body)
                    _M_FORWARDED.inc()
                    if tracing.enabled():
                        tracing.event(
                            "ingress.forward", tracing.trace_id(0, tx.digest().data)
                        )
                    resp = IngressResponse(tx.nonce, messages.ACCEPTED)
                else:
                    _M_REJECTED.inc()
                    self.admission.forget(tx)  # failed sigs release the nonce
                    if tracing.enabled():
                        tracing.event(
                            "ingress.reject",
                            tracing.trace_id(0, tx.digest().data),
                            status="bad_signature",
                        )
                    resp = IngressResponse(tx.nonce, messages.BAD_SIGNATURE)
                if not future.done():
                    future.set_result(resp)
                self.stats["responded"] += 1
            self.stats["accepted"] += accepted
            self.admission.note_drained(len(batch), loop.time())
            if cfg.verify_interval:
                # Deliberate drain pacing (see IngressConfig): capacity =
                # verify_batch / verify_interval tx/s.
                await asyncio.sleep(cfg.verify_interval)
        finally:
            self._in_flight -= 1
            self._pending.set()
