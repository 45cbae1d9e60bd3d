"""Mempool core actor (reference mempool/src/core.rs).

Maintains the queue of undelivered payload digests, persists and gossips
payloads, answers PayloadRequests, and serves the consensus driver
(Get/Verify/Cleanup). Under benchmark mode it reproduces the fork's injected
workload: every own/others payload triggers a batched verification of
len(transactions) synthetic (message, key, signature) triples drawn from a
pre-generated pool (mempool/src/core.rs:68-101,135-148,211-224) -- this is
the compute-dense kernel the card's CryptoBackend accelerates, measured as
votes-verified/sec.

The port's copy of `hotstuff_tpu/mempool/core.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging

from ..crypto import Digest, PublicKey, Signature, generate_keypair
from ..network.net import NetMessage
from ..store import Store
from ..utils import metrics, tracing
from ..utils.actors import Selector, spawn
from ..utils.serde import Reader, Writer
from ..consensus.mempool_driver import (
    MempoolCleanup,
    MempoolGet,
    MempoolVerify,
    PayloadStatus,
)
from .config import MempoolCommittee, MempoolParameters
from .errors import (
    InvalidPayloadSignatureError,
    MempoolError,
    PayloadTooBigError,
    QueueFullError,
    UnknownAuthorityError,
    ensure,
)
from .messages import OwnPayload, Payload, PayloadRequest
from .messages import encode_mempool_message
from .payload_maker import PayloadMaker
from .synchronizer import Synchronizer

log = logging.getLogger("hotstuff.mempool")

PAYLOAD_PREFIX = b"payload:"

_M_PAYLOADS_OWN = metrics.counter("mempool.payloads_own")
_M_PAYLOADS_OTHER = metrics.counter("mempool.payloads_other")
_M_PAYLOAD_BYTES = metrics.counter("mempool.payload_bytes")
_M_REQUESTS_SERVED = metrics.counter("mempool.payload_requests_served")
_M_GOSSIP_DROPPED = metrics.counter("mempool.gossip_dropped")
_M_SYNTHETIC_SKIPPED = metrics.counter("mempool.synthetic_skipped")
_M_REQUESTS_CLAMPED = metrics.counter("mempool.requests_clamped")
_M_VERIFY_BATCH = metrics.histogram(
    "mempool.verify_batch_size", metrics.SIZE_BUCKETS
)


class SyntheticPool:
    """Pre-generated (message, key, signature) triples for the benchmark
    workload (mempool/src/core.rs:68-101: 200k at startup in the fork; size is
    configurable here, drawn cyclically so per-payload work is identical)."""

    def __init__(self, size: int, seed: int = 7) -> None:
        import random

        rng = random.Random(seed)
        self.messages: list[bytes] = []
        self.pairs: list[tuple[PublicKey, Signature]] = []
        for _ in range(size):
            pk, sk = generate_keypair(rng)
            msg = rng.randbytes(32)
            self.messages.append(msg)
            self.pairs.append((pk, Signature.new(Digest(msg), sk)))
        self._cursor = 0

    def take(self, n: int) -> tuple[list[bytes], list[tuple[PublicKey, Signature]]]:
        msgs, pairs = [], []
        size = len(self.messages)
        for _ in range(n):
            i = self._cursor
            msgs.append(self.messages[i])
            pairs.append(self.pairs[i])
            self._cursor = (i + 1) % size
        return msgs, pairs


class Core:
    def __init__(
        self,
        name: PublicKey,
        committee: MempoolCommittee,
        parameters: MempoolParameters,
        store: Store,
        payload_maker: PayloadMaker,
        synchronizer: Synchronizer,
        core_channel: asyncio.Queue,
        consensus_mempool_channel: asyncio.Queue,
        network_tx: asyncio.Queue,
        verification_service=None,
        max_inflight_verifications: int = 8,
    ) -> None:
        from ..crypto.batch_service import BatchVerificationService

        self.name = name
        # MempoolCommittee (static, the pre-reconfig behaviour) or a
        # MempoolEpochView resolving through the node's shared
        # EpochManager: gossip fan-out (broadcast_addresses) follows the
        # CURRENT epoch's committee — a joiner starts receiving payload
        # gossip at the activation boundary, a leaver stops at it —
        # while acceptance (exists) and serving (mempool_address) span
        # the known epochs so boundary-adjacent payloads stay available.
        self.committee = committee
        self.parameters = parameters
        self.store = store
        self.payload_maker = payload_maker
        self.synchronizer = synchronizer
        self.core_channel = core_channel
        self.consensus_mempool_channel = consensus_mempool_channel
        self.network_tx = network_tx
        # Batched off-loop verification: synthetic workload batches and
        # foreign-payload signatures run as bounded background tasks so a
        # device dispatch never stalls the core's select loop (the reference
        # blocks its tokio task here, mempool/src/core.rs:135-148 — this is
        # strictly more pipelined).
        self.verification_service = (
            verification_service or BatchVerificationService()
        )
        self._verify_sem = asyncio.Semaphore(max_inflight_verifications)
        # Payload ACCEPTANCE (1 urgent signature + store) gets its own,
        # larger bound: cheap enough that 64 in flight is generous, but a
        # Byzantine peer streaming payloads must not grow _inflight (and
        # the heap) without limit. Overflowing gossip is dropped — it is
        # best-effort by contract; the payload synchronizer recovers any
        # payload consensus actually needs.
        self._accept_sem = asyncio.Semaphore(64)
        self._inflight: set[asyncio.Task] = set()
        self._gossip_dropped = 0  # payloads shed at full acceptance bound
        self._synthetic_skipped = 0  # workload sigs skipped at a full pipeline
        self._requests_clamped = 0  # oversized payload requests clamped
        # Undelivered payload digests, insertion-ordered (core.rs:50 queue).
        self.queue: dict[Digest, None] = {}
        # Digests already consumed by consensus cleanup. Background payload
        # verification may finish AFTER the block containing the payload
        # committed; inserting then would re-propose a committed payload.
        # Bounded insertion-ordered set (evicts oldest).
        self._cleaned: dict[Digest, None] = {}
        self._cleaned_cap = 4 * parameters.queue_capacity
        self.pool: SyntheticPool | None = None
        if parameters.benchmark_mode:
            log.info(
                "Generating %s synthetic signatures for the benchmark workload",
                parameters.synthetic_pool_size,
            )
            self.pool = SyntheticPool(parameters.synthetic_pool_size)

    # -- persistence ---------------------------------------------------------

    async def _store_payload(self, payload: Payload) -> None:
        w = Writer()
        payload.encode(w)
        await self.store.write(PAYLOAD_PREFIX + payload.digest().data, w.bytes())

    # -- benchmark workload --------------------------------------------------

    async def _submit_synthetic_batch(self, kind: str, n: int) -> None:
        """The fork's injected hot path (mempool/src/core.rs:135-148,211-224),
        run as a bounded background task — multiple batches stay in flight
        while the core keeps processing. The log line here is the single
        source of the votes/sec metric.
        NOTE: This log entry is used to compute performance."""
        if self.pool is None or n == 0:
            return
        if self._verify_sem.locked():
            # Pure measurement load must never block the core loop: with
            # the pipeline saturated, admitting another batch would park
            # this actor on the semaphore and stop it serving
            # PayloadRequests — the recovery path consensus stalls on.
            before = self._synthetic_skipped
            self._synthetic_skipped += n
            _M_SYNTHETIC_SKIPPED.inc(n)
            if before == 0 or before // 25_000 != self._synthetic_skipped // 25_000:
                log.warning(
                    "verification pipeline saturated: %s synthetic workload "
                    "signatures skipped so far (measured rate reflects "
                    "capacity, not demand)",
                    self._synthetic_skipped,
                )
            return
        log.info("Verifying %s transaction batch. Size: %s", kind, n)
        _M_VERIFY_BATCH.record(n)
        msgs, pairs = self.pool.take(n)
        await self._spawn_verification(self._run_synthetic, msgs, pairs)

    async def _run_synthetic(self, msgs, pairs) -> None:
        # dedup=False: the pool cycles a fixed set of pre-signed triples;
        # the verified-signature cache would otherwise absorb every repeat
        # and the measured rate would be the cache's, not the backend's.
        mask = await self.verification_service.verify_group(
            msgs, pairs, urgent=False, dedup=False, source="mempool"
        )
        if not all(mask):
            log.error("synthetic batch verification failed (backend bug?)")

    async def _spawn_verification(self, fn, *args, sem=None) -> None:
        """Run `fn(*args)` in a background task, holding a slot of `sem`
        (default: the workload pipeline cap `_verify_sem`; payload
        acceptance passes the wider `_accept_sem`). Callers check
        `sem.locked()` BEFORE calling (dropping or skipping instead), so
        the acquire here never actually parks the core loop. Deferred-call
        form (not a coroutine argument) so a task cancelled before it
        first runs leaves no never-awaited coroutine behind."""
        sem = self._verify_sem if sem is None else sem
        await sem.acquire()
        task = spawn(self._release_after(sem, fn, *args), name="mempool-verify")
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    async def _release_after(self, sem, fn, *args) -> None:
        try:
            await fn(*args)
        except Exception as e:  # must not kill the task group silently
            log.warning("background verification error: %r", e)
        finally:
            sem.release()

    # -- payload handling ----------------------------------------------------

    async def _handle_own_payload(self, payload: Payload) -> Digest:
        digest = payload.digest()
        _M_PAYLOADS_OWN.inc()
        _M_PAYLOAD_BYTES.inc(payload.size())
        await self._submit_synthetic_batch("OWN", len(payload.transactions))
        # NOTE: These log entries are used to compute performance.
        log.info("Payload %s contains %s B", digest, payload.size())
        for sample_id in payload.sample_tx_ids():
            log.info("Payload %s contains sample tx %s", digest, sample_id)
        await self._store_payload(payload)
        # Share early: disseminate bytes while consensus orders digests later
        # (core.rs:174-175).
        addrs = self.committee.broadcast_addresses(self.name)
        if addrs:
            # Payload gossip rides its own trace lane (round 0 + payload
            # digest prefix): the consensus-side "payload" stage then shows
            # WHETHER availability stalled, and these events show WHY.
            trace = None
            if tracing.enabled():
                trace = tracing.TraceContext(0, digest.data)
                tracing.event("payload.gossip", trace.trace_id, peers=len(addrs))
            await self.network_tx.put(
                NetMessage(encode_mempool_message(payload), addrs, trace=trace)
            )
        self._queue_insert(digest)
        return digest

    async def _handle_others_payload(self, payload: Payload) -> None:
        """Byzantine-input checks at ingress (core.rs:193-234). Structural
        checks raise typed MempoolErrors synchronously; the signature check
        and synthetic workload run in a bounded background task, after which
        the payload is stored (waking any notify_read synchronizer waiters)
        and queued."""
        ensure(
            self.committee.exists(payload.author),
            UnknownAuthorityError(payload.author.short()),
        )
        ensure(
            payload.size() <= self.parameters.max_payload_size,
            PayloadTooBigError(payload.size(), self.parameters.max_payload_size),
        )
        # Acceptance (verify the author's ONE signature, store, queue) is
        # cheap and consensus-critical: it rides its own wide bound
        # (_accept_sem), never the workload-saturated _verify_sem. Only
        # the synthetic workload batch rides the capped pipeline (see
        # _finish_others_payload): under saturation the measurement load
        # is skipped, never the payload. Blocking the core loop here (an
        # earlier design awaited a semaphore slot held by queued
        # workload batches) starved PayloadRequest serving and froze
        # commits under saturation; dropping at
        # the acceptance bound keeps the loop responsive against a
        # Byzantine payload flood, and the synchronizer re-fetches
        # anything consensus actually needs.
        if self._accept_sem.locked():
            self._gossip_dropped += 1
            _M_GOSSIP_DROPPED.inc()
            if self._gossip_dropped % 1_000 == 1:
                log.warning(
                    "payload acceptance bound full: %s gossiped payloads "
                    "dropped",
                    self._gossip_dropped,
                )
            return
        await self._spawn_verification(
            self._finish_others_payload, payload, sem=self._accept_sem
        )

    async def _finish_others_payload(self, payload: Payload) -> None:
        ok = await payload.verify_async(self.committee, self.verification_service)
        if not ok:
            raise InvalidPayloadSignatureError(payload.author.short())
        _M_PAYLOADS_OTHER.inc()
        _M_PAYLOAD_BYTES.inc(payload.size())
        # Store + queue as soon as the REAL signature verifies: consensus
        # blocks on payload availability, and the synthetic workload below is
        # pure load whose result never gates acceptance (the reference
        # verifies pre-generated triples, mempool/src/core.rs:211-224 — the
        # outcome is measured, not consumed).
        await self._store_payload(payload)
        if tracing.enabled():
            tracing.event(
                "payload.stored", tracing.trace_id(0, payload.digest().data)
            )
        self._queue_insert(payload.digest())
        # The synthetic OTHER batch rides the capped pipeline; at a full
        # pipeline the measurement load is skipped so acceptance never
        # queues behind it.
        await self._submit_synthetic_batch("OTHER", len(payload.transactions))

    def _queue_insert(self, digest: Digest) -> None:
        if digest in self._cleaned:
            return  # already ordered and cleaned up; do not re-propose
        ensure(
            len(self.queue) < self.parameters.queue_capacity,
            QueueFullError(self.parameters.queue_capacity),
        )
        self.queue[digest] = None

    async def _handle_request(self, request: PayloadRequest) -> None:
        """Serve stored payloads to a lagging peer (core.rs:236-249).

        Byzantine bound: replies ride the URGENT egress lane (they un-stall
        the requester's consensus), which a hostile requester could exploit
        as a priority-amplified reflector — at most
        `parameters.max_request_digests` payloads are served per request
        (the PREFIX, so an honest requester with an unusually large block
        still makes progress via its retry loop), and unknown requesters
        are ignored."""
        digests = request.digests
        cap = self.parameters.max_request_digests
        if len(digests) > cap:
            self._requests_clamped += 1
            _M_REQUESTS_CLAMPED.inc()
            if self._requests_clamped % 1_000 == 1:
                log.warning(
                    "clamping oversized payload request (%s digests) from "
                    "%s (%s clamped so far)",
                    len(digests),
                    request.requester.short(),
                    self._requests_clamped,
                )
            digests = digests[:cap]
        addr = self.committee.mempool_address(request.requester)
        if addr is None:
            return
        for digest in digests:
            raw = await self.store.read(PAYLOAD_PREFIX + digest.data)
            if raw is not None:
                _M_REQUESTS_SERVED.inc()
                payload = Payload.decode(Reader(raw))
                trace = None
                if tracing.enabled():
                    trace = tracing.context_for(0, digest.data)
                    tracing.event("payload.served", trace.trace_id)
                # Urgent: the requester's consensus is stalled on this
                # payload; behind the gossip backlog it would drop and the
                # requester would re-broadcast forever.
                await self.network_tx.put(
                    NetMessage(
                        encode_mempool_message(payload), [addr], urgent=True,
                        trace=trace,
                    )
                )

    # -- consensus driver ----------------------------------------------------

    async def _get_payload(self, max_size: int) -> list[Digest]:
        """Pop up to max_size/32 digests; if the queue is dry, force the
        PayloadMaker to flush (core.rs:251-268)."""
        limit = max(1, max_size // Digest.SIZE)
        if self.queue:
            out = []
            for digest in list(self.queue):
                if len(out) >= limit:
                    break
                out.append(digest)
                del self.queue[digest]
            return out
        payload = await self.payload_maker.request_make()
        if not payload.transactions:
            return []
        digest = await self._handle_own_payload(payload)
        # A freshly-made payload can collide with an already-committed digest
        # (identical tx content re-made after a cleanup): _queue_insert skips
        # cleaned digests, and re-proposing one would double-include it.
        if digest not in self.queue:
            return []
        del self.queue[digest]  # it is being delivered right now
        return [digest]

    async def _cleanup(self, msg: MempoolCleanup) -> None:
        for block in (msg.b0, msg.b1, msg.block):
            for digest in block.payload:
                self.queue.pop(digest, None)
                self._cleaned[digest] = None
        while len(self._cleaned) > self._cleaned_cap:
            self._cleaned.pop(next(iter(self._cleaned)))
        self.synchronizer.cleanup(msg.b0.round)

    # -- main loop -----------------------------------------------------------

    async def run(self) -> None:
        selector = Selector()
        selector.add("net", self.core_channel.get)
        selector.add("consensus", self.consensus_mempool_channel.get)
        while True:
            branch, msg = await selector.next()
            # Requests carrying a reply future MUST always be resolved, even
            # on internal errors: the consensus core blocks on the reply in
            # its single select loop, so a dropped future deadlocks the node.
            if isinstance(msg, MempoolGet):
                try:
                    result = await self._get_payload(msg.max_size)
                except Exception as e:
                    log.error("get_payload failed: %r", e)
                    result = []
                if not msg.reply.done():
                    msg.reply.set_result(result)
                continue
            if isinstance(msg, MempoolVerify):
                try:
                    status = await self.synchronizer.verify_payload(msg.block)
                except Exception as e:
                    log.error("verify_payload failed: %r", e)
                    status = PayloadStatus.WAIT
                if not msg.reply.done():
                    msg.reply.set_result(status)
                continue
            try:
                if isinstance(msg, OwnPayload):
                    await self._handle_own_payload(msg.payload)
                elif isinstance(msg, Payload):
                    await self._handle_others_payload(msg)
                elif isinstance(msg, PayloadRequest):
                    await self._handle_request(msg)
                elif isinstance(msg, MempoolCleanup):
                    await self._cleanup(msg)
                else:
                    log.warning("unexpected mempool message: %r", msg)
            except MempoolError as e:  # typed Byzantine-input rejection
                log.warning("%s", e)
            except Exception as e:  # a Byzantine message must not kill the actor
                log.warning("mempool core error: %r", e)

    async def drain_verifications(self) -> None:
        """Await all in-flight background verifications (test/shutdown aid)."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
