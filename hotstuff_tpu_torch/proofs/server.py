"""Proof serving: in-process service + framed-TCP front-end.

`ProofService` answers ProofQuery against the node's ProofRegistry with
the same overload discipline as the ingress admission plane
(ingress/admission.py): explicit shedding with a retry-after hint
derived from an observed-rate EWMA, never unbounded queueing. The two
modes differ only in WHO waits:

  * MODE_QUERY resolves immediately — OK with the proof, PENDING with a
    retry hint (admitted here, commit not yet seen), or UNKNOWN.
  * MODE_SUBSCRIBE parks the reply until the commit lands, but ONLY for
    a (client, nonce) this node actually admitted: a subscription for a
    never-admitted nonce is SHED with a retry hint and allocates
    NOTHING — the nonce-squatting flood costs the attacker a round trip
    and this node a dict lookup (the Byzantine proof-squatter scenario
    pins `proofs.subs_shed` and the bounded registry size). Admitted
    subscriptions are bounded globally too (registry.max_waiters);
    overflow sheds the same way, and an obedient client's retry lands
    after the backlog drained.

`ProofServer`/`ProofClient` are the framed-TCP wrappers, riding the
exact connection discipline of the ingress RPC (ingress/server.py): one
reader + one serialized writer task per connection, responses correlated
by echoed nonce, MALFORMED replies for undecodable frames.

The retry hint mirrors admission's drain-rate estimate: an EWMA over
resolutions observed per note-commit tick, quoting the time for the
current waiter backlog to half-drain (clamped to the same
[RETRY_MIN_MS, RETRY_MAX_MS] band). Deterministic under the chaos
virtual clock — only event-loop time, passed by the caller, is read.

The port's copy of `hotstuff_tpu/proofs/server.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging

from ..network.net import Address, FrameReader, frame
from ..utils import metrics
from ..utils.actors import channel, spawn
from .messages import (
    MODE_SUBSCRIBE,
    PROOF_MALFORMED,
    PROOF_OK,
    PROOF_PENDING,
    PROOF_SHED,
    PROOF_UNKNOWN,
    ProofQuery,
    ProofReply,
    decode_proof_message,
    encode_proof_message,
)
from .registry import ProofRegistry

log = logging.getLogger("hotstuff.proofs")

_M_QUERIES = metrics.counter("proofs.queries")
_M_SERVED = metrics.counter("proofs.served")
_M_UNKNOWN = metrics.counter("proofs.unknown")
_M_SUBS_SHED = metrics.counter("proofs.subs_shed")
_M_WIRE_MALFORMED = metrics.counter("proofs.malformed")
_M_SERVE_S = metrics.histogram("proofs.serve_s")
_M_PROOF_BYTES = metrics.histogram("proofs.proof_bytes", metrics.SIZE_BUCKETS)

RETRY_MIN_MS = 50
RETRY_MAX_MS = 5_000


class ProofService:
    """One per node; answers queries against the node's registry."""

    def __init__(self, registry: ProofRegistry) -> None:
        self.registry = registry
        # Resolution-rate EWMA (proofs/sec), fed by the registry's commit
        # notes through note_resolved(); seeds pessimistic like admission.
        self._resolve_rate = 0.0
        self._last_resolve_t: float | None = None
        self.stats = {
            "queries": 0, "served": 0, "pending": 0, "unknown": 0,
            "subs": 0, "subs_shed": 0, "worst_proof_bytes": 0,
        }

    async def handle(self, query: ProofQuery, now: float) -> ProofReply:
        """Answer one query; `now` is event-loop time (virtual under
        chaos). A SUBSCRIBE for an admitted-but-uncommitted key awaits
        the commit; everything else resolves immediately."""
        self.stats["queries"] += 1
        _M_QUERIES.inc()
        proof, known = self.registry.proof_for_client(query.client, query.nonce)
        if proof is not None:
            return self._serve(query, proof, now, now)
        if query.mode != MODE_SUBSCRIBE:
            if known:
                self.stats["pending"] += 1
                return ProofReply(
                    query.nonce, PROOF_PENDING, self._retry_after_ms()
                )
            self.stats["unknown"] += 1
            _M_UNKNOWN.inc()
            return ProofReply(query.nonce, PROOF_UNKNOWN)
        if not known:
            # Never-admitted subscribe: shed WITHOUT allocating — the
            # squatter's slot budget is zero, the honest client whose
            # submit raced just retries after the hint.
            self.stats["subs_shed"] += 1
            _M_SUBS_SHED.inc()
            return ProofReply(query.nonce, PROOF_SHED, self._retry_after_ms())
        fut = self.registry.add_waiter(query.client, query.nonce)
        if fut is None:  # waiter table full (registry counted the shed)
            self.stats["subs_shed"] += 1
            return ProofReply(query.nonce, PROOF_SHED, self._retry_after_ms())
        self.stats["subs"] += 1
        try:
            proof = await fut
        except asyncio.CancelledError:
            self.registry.drop_waiter(query.client, query.nonce, fut)
            raise
        loop = asyncio.get_running_loop()
        return self._serve(query, proof, now, loop.time())

    def _serve(
        self, query: ProofQuery, proof, t0: float, now: float
    ) -> ProofReply:
        self.stats["served"] += 1
        _M_SERVED.inc()
        _M_SERVE_S.record(now - t0)
        size = proof.encoded_size()
        _M_PROOF_BYTES.record(size)
        if size > self.stats["worst_proof_bytes"]:
            self.stats["worst_proof_bytes"] = size
        self.note_resolved(1, now)
        # NOTE: cumulative, last-line-wins; parsed by the benchmark
        # LogParser (+ PROOFS section).
        log.info(
            "Proof served: %d proofs served, %d subscriptions, "
            "%d shed, worst proof %d B",
            self.stats["served"],
            self.stats["subs"],
            self.stats["subs_shed"],
            self.stats["worst_proof_bytes"],
        )
        return ProofReply(query.nonce, PROOF_OK, 0, proof)

    def note_resolved(self, n: int, now: float) -> None:
        """EWMA resolution-rate update (admission.note_drained's shape)."""
        if self._last_resolve_t is not None:
            dt = now - self._last_resolve_t
            if dt > 0:
                inst = n / dt
                self._resolve_rate = (
                    inst
                    if self._resolve_rate == 0.0
                    else 0.8 * self._resolve_rate + 0.2 * inst
                )
        self._last_resolve_t = now

    def _retry_after_ms(self) -> int:
        """Time for the waiter backlog to half-drain at the observed
        resolution rate — admission's estimator applied to the proof
        plane (a zero-observation start quotes the conservative max)."""
        if self._resolve_rate <= 0.0:
            return RETRY_MAX_MS
        backlog = max(1, self.registry.waiters())
        ms = int(1000.0 * (backlog / 2.0) / self._resolve_rate)
        return max(RETRY_MIN_MS, min(RETRY_MAX_MS, ms))


class ProofServer:
    """Accept loop on the proof port; one reader + one writer task per
    connection, queries fan out into the shared service."""

    def __init__(self, address: Address, service: ProofService) -> None:
        self._address = address
        self.service = service
        self._task = spawn(self._run(), name="proof-server")

    async def _run(self) -> None:
        server = await asyncio.start_server(
            self._handle, host=self._address[0], port=self._address[1]
        )
        log.info("Proof server listening on %s", self._address)
        async with server:
            await server.serve_forever()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        # Same per-connection shape as the ingress RPC: responses
        # serialize through one queue + writer task (subscriptions
        # complete out of order), per-query tasks die with the
        # connection.
        responses = channel()
        writer_task = spawn(
            self._write_replies(responses, writer), name="proof-writer"
        )
        inflight: set[asyncio.Task] = set()
        frames = FrameReader(reader)
        try:
            while True:
                try:
                    data = await frames.next_frame()
                except ConnectionError as e:
                    log.warning(
                        "proofs: dropping connection from %s: %s", peer, e
                    )
                    break
                if data is None:
                    break
                try:
                    msg = decode_proof_message(data)
                except Exception as e:
                    _M_WIRE_MALFORMED.inc()
                    log.warning(
                        "proofs: undecodable frame from %s: %r", peer, e
                    )
                    await responses.put(ProofReply(0, PROOF_MALFORMED))
                    continue
                if not isinstance(msg, ProofQuery):
                    _M_WIRE_MALFORMED.inc()
                    await responses.put(ProofReply(0, PROOF_MALFORMED))
                    continue
                task = spawn(self._answer(msg, responses), name="proof-handle")
                inflight.add(task)
                task.add_done_callback(inflight.discard)
        finally:
            writer_task.cancel()
            for task in list(inflight):
                task.cancel()
            try:
                writer.close()
            except Exception:
                pass

    async def _answer(self, query: ProofQuery, responses) -> None:
        loop = asyncio.get_running_loop()
        reply = await self.service.handle(query, loop.time())
        await responses.put(reply)

    async def _write_replies(self, responses, writer) -> None:
        while True:
            reply = await responses.get()
            try:
                writer.write(frame(encode_proof_message(reply)))
                await writer.drain()
            except (ConnectionError, OSError):
                return  # client went away; reader loop will notice EOF


class ProofClient:
    """Client side: pipelined queries over one connection, reply futures
    keyed by nonce (FIFO per nonce, like the ingress client). Used by
    `python -m hotstuff_tpu_torch.loadgen --proofs`; in-process drivers call
    ProofService.handle directly."""

    def __init__(self) -> None:
        self._writer: asyncio.StreamWriter | None = None
        self._waiters: dict[int, list[asyncio.Future]] = {}
        self._reader_task: asyncio.Task | None = None

    async def connect(self, address: Address) -> None:
        reader, self._writer = await asyncio.open_connection(
            address[0], address[1]
        )
        self._reader_task = spawn(
            self._read_replies(reader), name="proof-client-reader"
        )

    async def _read_replies(self, reader: asyncio.StreamReader) -> None:
        frames = FrameReader(reader)
        while True:
            try:
                data = await frames.next_frame()
            except ConnectionError:
                data = None
            if data is None:
                break
            try:
                msg = decode_proof_message(data)
            except Exception as e:
                log.warning("proof client: undecodable reply: %r", e)
                continue
            queue = self._waiters.get(getattr(msg, "nonce", -1))
            if queue:
                fut = queue.pop(0)
                if not queue:
                    del self._waiters[msg.nonce]
                if not fut.done():
                    fut.set_result(msg)
        waiters, self._waiters = self._waiters, {}
        for queue in waiters.values():
            for fut in queue:
                if not fut.done():
                    fut.set_exception(
                        ConnectionError("proof connection closed")
                    )

    async def query(self, query: ProofQuery) -> ProofReply:
        if self._writer is None:
            raise ConnectionError("proof client not connected")
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(query.nonce, []).append(fut)
        self._writer.write(frame(encode_proof_message(query)))
        await self._writer.drain()
        return await fut

    def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
