"""Ingress RPC front-end: framed TCP server + client.

Rides the exact wire discipline of the rest of the stack — 4-byte
big-endian length prefixes read through `network/net.FrameReader` — so a
client speaks to the ingress port the same way nodes speak to each
other. Unlike the node-to-node planes this is a REQUEST/RESPONSE
surface: every decoded ClientTransaction gets exactly one
IngressResponse back on the same connection, correlated by nonce (a
client may pipeline submissions; responses can complete out of order
because admission rejections resolve immediately while accepted
transactions wait out their verification batch).

An undecodable frame is answered with MALFORMED(nonce=0) and the
connection survives — frame boundaries are intact (the length prefix
parsed), so subsequent frames are still well-delimited. A frame
violating the length cap drops the connection, same as NetReceiver.

The port's copy of `hotstuff_tpu/ingress/server.py`, its imports rewritten to
this package. Two changes, both for a flood that the node sheds: admission
runs inline in the connection's reader (`IngressPipeline.admit`), and only
an admitted transaction gets a task (the reference spawns one a frame, so
a shed flood fills the event loop's ready queue); and the reader yields to
the loop every YIELD_EVERY frames; the writer sends every queued response
in one write.
"""

from __future__ import annotations

import asyncio
import logging

from ..network.net import Address, FrameReader, frame
from ..utils import metrics
from ..utils.actors import channel, spawn
from . import messages
from .messages import (
    ClientTransaction,
    IngressResponse,
    decode_ingress_message,
    encode_ingress_message,
)
from .pipeline import IngressPipeline

log = logging.getLogger("hotstuff.ingress")

# Frames a connection's reader handles before it yields to the event loop:
# a flood arrives faster than it is answered, so every read finds a full
# buffer, and without a yield one connection's backlog would hold the loop
# (the node's consensus rounds included) for hundreds of frames at a time.
YIELD_EVERY = 32

# Wire-level rejects (undecodable frames) never reach admission, but a
# garbage-frame flood must still be visible to monitoring.
_M_WIRE_MALFORMED = metrics.counter("ingress.malformed")


class IngressServer:
    """Accept loop on the ingress port; one reader + one writer task per
    connection, submissions fan out into the shared pipeline."""

    def __init__(self, address: Address, pipeline: IngressPipeline) -> None:
        self._address = address
        self.pipeline = pipeline
        self._task = spawn(self._run(), name="ingress-server")

    async def _run(self) -> None:
        server = await asyncio.start_server(
            self._handle, host=self._address[0], port=self._address[1]
        )
        log.info("Ingress listening on %s", self._address)
        async with server:
            await server.serve_forever()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        # Responses serialize through one queue + writer task: per-tx
        # submit tasks complete concurrently and interleaved writes would
        # corrupt the frame stream. Bounded: a client that stops reading
        # eventually blocks its own submissions, nobody else's.
        responses = channel()
        writer_task = spawn(
            self._write_responses(responses, writer), name="ingress-writer"
        )
        # Per-connection submit tasks, cancelled on disconnect: once the
        # writer stops draining `responses`, a completed submit would
        # otherwise park forever on its put and leak with the connection.
        inflight: set[asyncio.Task] = set()
        frames = FrameReader(reader)
        loop = asyncio.get_running_loop()
        handled = 0
        try:
            while True:
                handled += 1
                if handled % YIELD_EVERY == 0:
                    await asyncio.sleep(0)
                try:
                    data = await frames.next_frame()
                except ConnectionError as e:
                    log.warning(
                        "ingress: dropping connection from %s: %s", peer, e
                    )
                    break
                if data is None:
                    break
                try:
                    msg = decode_ingress_message(data)
                except Exception as e:
                    _M_WIRE_MALFORMED.inc()
                    log.warning(
                        "ingress: undecodable frame from %s: %r", peer, e
                    )
                    await responses.put(
                        IngressResponse(0, messages.MALFORMED)
                    )
                    continue
                if not isinstance(msg, ClientTransaction):
                    _M_WIRE_MALFORMED.inc()
                    await responses.put(
                        IngressResponse(0, messages.MALFORMED)
                    )
                    continue
                # Admission inline: a rejection (shed, replay, malformed)
                # is answered here, with no task; only an admitted
                # transaction waits out its verification batch in a task.
                t0 = loop.time()
                out = self.pipeline.admit(msg)
                if isinstance(out, IngressResponse):
                    await responses.put(out)
                    continue
                task = spawn(
                    self._answer(out, t0, responses), name="ingress-handle"
                )
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

    async def _answer(self, future, t0: float, responses) -> None:
        resp = await self.pipeline.result(future, t0)
        await responses.put(resp)

    async def _write_responses(self, responses, writer) -> None:
        while True:
            # Every response already queued goes out in one write (one
            # send, not one a response).
            batch = [await responses.get()]
            while not responses.empty():
                batch.append(responses.get_nowait())
            try:
                writer.write(b"".join(frame(encode_ingress_message(r)) for r in batch))
                await writer.drain()
            except (ConnectionError, OSError):
                return  # client went away; reader loop will notice EOF


class IngressClient:
    """Client side of the RPC: pipelined submissions over one connection,
    response futures keyed by nonce. Used by `python -m hotstuff_tpu_torch.loadgen`;
    in-process drivers call IngressPipeline.submit directly."""

    def __init__(self) -> None:
        self._writer: asyncio.StreamWriter | None = None
        # nonce -> FIFO of waiters: submitters SHOULD use unique nonces
        # (the replay filter rejects repeats), but a repeat in flight must
        # cross-match FIFO rather than silently orphan the first future.
        self._waiters: dict[int, list[asyncio.Future]] = {}
        self._reader_task: asyncio.Task | None = None

    async def connect(self, address: Address) -> None:
        reader, self._writer = await asyncio.open_connection(
            address[0], address[1]
        )
        self._reader_task = spawn(
            self._read_responses(reader), name="ingress-client-reader"
        )

    async def _read_responses(self, reader: asyncio.StreamReader) -> None:
        frames = FrameReader(reader)
        while True:
            try:
                data = await frames.next_frame()
            except ConnectionError:
                data = None
            if data is None:
                break
            try:
                msg = decode_ingress_message(data)
            except Exception as e:
                log.warning("ingress client: undecodable response: %r", e)
                continue
            queue = self._waiters.get(getattr(msg, "nonce", -1))
            if queue:
                fut = queue.pop(0)
                if not queue:
                    del self._waiters[msg.nonce]
                if not fut.done():
                    fut.set_result(msg)
        # Connection gone: fail every outstanding waiter.
        waiters, self._waiters = self._waiters, {}
        for queue in waiters.values():
            for fut in queue:
                if not fut.done():
                    fut.set_exception(
                        ConnectionError("ingress connection closed")
                    )

    async def submit(self, tx: ClientTransaction) -> IngressResponse:
        if self._writer is None:
            raise ConnectionError("ingress client not connected")
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(tx.nonce, []).append(fut)
        self._writer.write(frame(encode_ingress_message(tx)))
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
