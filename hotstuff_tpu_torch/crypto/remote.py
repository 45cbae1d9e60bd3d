"""Crypto sidecar of the port: one process owns the card, many nodes share it.

A copy of `hotstuff_tpu/crypto/remote.py` around `TorchBackend`. A sidecar
process holds the backend and serves batch verification over a local TCP
socket; nodes install a `RemoteBackend` that ships batches at or above its
crossover to the sidecar and verifies smaller ones on their own CPU
(OpenSSL where the `cryptography` package imports, as the reference does).
Requests from every connection funnel through one
`BatchVerificationService`, so batches coalesce across the committee
before they reach the card.

Wire protocol (little-endian, one request per round trip per connection),
byte for byte the reference's, so unchanged reference nodes
(`--crypto remote`) talk to this sidecar:
  request:  u32 body_len, u32 n, then n x { u32 mlen, msg, 32 B pk, 64 B sig }
  response: u32 n, then n x u8 validity
A request over MAX_REQUEST_BYTES, a runt (body under 4 bytes) or a body
that does not parse drops its connection; the server keeps serving.

Run it as

    python -m hotstuff_tpu_torch.crypto.remote --port 9700 --committee .committee.json

It prints `Crypto sidecar (torch) successfully booted on host:port` once it
accepts connections (the benchmark harness waits for "successfully
booted"). `--sharded` splits every batch over every visible GPU
(`parallel/mesh.py`), the counterpart of the reference node's
`--crypto-sharded`; with `--committee` each GPU then holds a replica of the
committee's tables. The reference's `--max-delay` is not ported: it bound
only the reference service's single-queue flush loop, and the port's
scheduler sets every flush deadline per source class. The wire carries the
urgent bit alone, so requests take the consensus lane (under
`urgent_below` items) or the mempool lane.

`--multihost` (the reference's `:340-345`, `:378-387`) joins a job of
several sidecar processes (`parallel.init_multihost`; the job's address,
size and this process's rank from `MASTER_ADDR`, `MASTER_PORT`,
`WORLD_SIZE` and `RANK`) and serves a backend over the job's global mesh:
every batch is split over every process's devices (its visible GPUs; one
CPU shard with `--device cpu`, which runs the plain versions), and with
`--committee` each process registers one table replica per device of its
own. The job is SPMD, as the reference's: every sidecar of it must be sent
the same requests in the same order, one at a time, since each batch's
masks are gathered from every process; a sidecar sent a request the others
were not waits in that gather forever. Start one sidecar a rank:

    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \
        python -m hotstuff_tpu_torch.crypto.remote --port 9700 --multihost
    MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 WORLD_SIZE=2 RANK=1 \
        python -m hotstuff_tpu_torch.crypto.remote --port 9701 --multihost

`--sharded` splits over this process's GPUs alone and is refused beside
`--multihost`.

On a normal exit (the server's end or an interrupt) the dispatch pipelines'
worker threads are drained by `ops.pipeline.close_all`, which that module
registers with `atexit`; on SIGTERM they end with the process.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import struct
import threading
from typing import Sequence

from .backend import CryptoBackend, host_backend, host_route, make_backend
from .batch_service import BatchVerificationService
from .primitives import PublicKey, Signature

log = logging.getLogger("hotstuff.crypto")

# Ingress caps: a buggy or hostile co-tenant must not be able to run the
# process that owns the card out of memory. Per-item caps do not bound a
# request's size, so the bytes buffered per request are capped too (the
# largest honest request, one coalesced batch of ~8,192 items of ~200 B,
# is ~1.6 MB).
MAX_REQUEST_ITEMS = 1_000_000
MAX_MESSAGE_LEN = 16 * 1024 * 1024
MAX_REQUEST_BYTES = 64 * 1024 * 1024

# The client's round-trip timeout in seconds, and its bulk connections:
# concurrent callers each borrow a socket, so one batch streams in while
# another is on the card.
CLIENT_TIMEOUT_S = 30.0
CLIENT_POOL_SIZE = 5


def _encode_request(
    messages: Sequence[bytes],
    keys: Sequence[PublicKey],
    signatures: Sequence[Signature],
) -> bytes:
    parts = [struct.pack("<I", len(messages))]
    for m, k, s in zip(messages, keys, signatures):
        parts.append(struct.pack("<I", len(m)))
        parts.append(m)
        parts.append(k.data if isinstance(k, PublicKey) else k)
        parts.append(s.data if isinstance(s, Signature) else s)
    body = b"".join(parts)
    return struct.pack("<I", len(body)) + body


def _encode_reply(mask: Sequence[bool]) -> bytes:
    return struct.pack("<I", len(mask)) + bytes(int(b) for b in mask)


def _parse_request(body: memoryview) -> tuple[list[bytes], list[tuple[PublicKey, Signature]]]:
    """Parse a request body (after the length prefix). Raises ValueError on
    malformed framing or a cap violation."""
    (n,) = struct.unpack("<I", body[:4])
    if n > MAX_REQUEST_ITEMS:
        raise ValueError(f"{n} items exceeds cap")
    off = 4
    msgs: list[bytes] = []
    pairs: list[tuple[PublicKey, Signature]] = []
    end = len(body)
    for _ in range(n):
        if off + 4 > end:
            raise ValueError("truncated item header")
        (mlen,) = struct.unpack("<I", body[off : off + 4])
        off += 4
        if mlen > MAX_MESSAGE_LEN or off + mlen + 96 > end:
            raise ValueError("item exceeds body")
        msgs.append(bytes(body[off : off + mlen]))
        off += mlen
        pairs.append(
            (
                PublicKey(bytes(body[off : off + 32])),
                Signature(bytes(body[off + 32 : off + 96])),
            )
        )
        off += 96
    if off != end:
        raise ValueError("trailing bytes in request body")
    return msgs, pairs


class RemoteBackend(CryptoBackend):
    """CryptoBackend that ships batches to the sidecar.

    Batches below `crossover` verify on the local host. If the sidecar
    cannot be reached after a retry on a fresh connection, the batch
    verifies on the host too, with a warning: a sidecar outage must not
    halt the protocol. `stats` counts both. The host verifier is chosen once
    (`host`, see `backend.host_backend`): OpenSSL, the reference's host path, where
    `cryptography` imports; `host_route` says which ("openssl" or "exact").
    Both give the card's verdicts."""

    name = "remote"

    # Requests below this ride the reserved urgent socket, as the sidecar's
    # `urgent_below` sends them to the critical lane.
    URGENT_BELOW = 256

    def __init__(self, addr: tuple[str, int], crossover: int = 64, host: str | None = None):
        self.addr = addr
        self.crossover = crossover
        self._host = host_backend(host)
        self.host_route = host_route(self._host)
        log.info("remote backend %s:%s: batches under %d and sidecar outages verify on the host (%s)",
                 addr[0], addr[1], crossover, self.host_route)
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._pool_sem = threading.BoundedSemaphore(CLIENT_POOL_SIZE)
        # Urgent lane: one reserved socket and slot for small requests.
        self._urgent_sem = threading.BoundedSemaphore(1)
        self._urgent_sock: socket.socket | None = None
        self._stats_lock = threading.Lock()
        self.stats = {"remote_batches": 0, "remote_sigs": 0, "cpu_batches": 0, "cpu_sigs": 0}

    def _count(self, kind: str, n: int) -> None:
        with self._stats_lock:
            self.stats[f"{kind}_batches"] += 1
            self.stats[f"{kind}_sigs"] += n

    def _dial(self) -> socket.socket:
        s = socket.create_connection(self.addr, timeout=CLIENT_TIMEOUT_S)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _borrow(self, urgent: bool) -> socket.socket:
        with self._pool_lock:
            if urgent:
                if self._urgent_sock is not None:
                    sock, self._urgent_sock = self._urgent_sock, None
                    return sock
            elif self._pool:
                return self._pool.pop()
        return self._dial()

    def _give_back(self, sock: socket.socket, urgent: bool) -> None:
        with self._pool_lock:
            if urgent and self._urgent_sock is None:
                self._urgent_sock = sock
            else:
                self._pool.append(sock)

    def _flush_pool(self) -> None:
        with self._pool_lock:
            stale, self._pool = self._pool, []
            if self._urgent_sock is not None:
                stale.append(self._urgent_sock)
                self._urgent_sock = None
        for s in stale:
            try:
                s.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every pooled connection."""
        self._flush_pool()

    def _recv_exact(self, sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("sidecar closed connection")
            buf += chunk
        return bytes(buf)

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
    ) -> list[bool]:
        n = len(messages)
        if n == 0:
            return []
        if n < self.crossover:
            self._count("cpu", n)
            return self._host.verify_batch_mask(messages, keys, signatures)
        payload = _encode_request(messages, keys, signatures)
        urgent = n < self.URGENT_BELOW
        sem = self._urgent_sem if urgent else self._pool_sem
        with sem:  # bound concurrent round trips per lane
            for attempt in (0, 1):
                sock = None
                try:
                    if attempt == 0:
                        sock = self._borrow(urgent)
                    else:
                        # Pooled sockets may all be stale (sidecar restart):
                        # the last attempt dials fresh.
                        self._flush_pool()
                        sock = self._dial()
                    sock.sendall(payload)
                    (count,) = struct.unpack("<I", self._recv_exact(sock, 4))
                    if count != n:
                        raise ConnectionError("sidecar count mismatch")
                    mask = self._recv_exact(sock, n)
                    self._give_back(sock, urgent)
                    self._count("remote", n)
                    return [b != 0 for b in mask]
                except (OSError, ConnectionError) as e:
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                    if attempt == 1:
                        log.warning("sidecar unreachable (%s); falling back to CPU", e)
        self._count("cpu", n)
        return self._host.verify_batch_mask(messages, keys, signatures)


# ---------------------------------------------------------------------------
# Sidecar server


async def _handle_connection(reader, writer, service: BatchVerificationService, urgent_below: int):
    peer = writer.get_extra_info("peername")
    log.debug("sidecar connection from %s", peer)
    try:
        while True:
            try:
                (body_len,) = struct.unpack("<I", await reader.readexactly(4))
            except (asyncio.IncompleteReadError, ConnectionResetError):
                break
            if body_len > MAX_REQUEST_BYTES:
                log.warning(
                    "dropping connection %s: %s B request exceeds %s B cap",
                    peer, body_len, MAX_REQUEST_BYTES,
                )
                break
            if body_len < 4:
                log.warning("dropping connection %s: runt request", peer)
                break
            body = memoryview(await reader.readexactly(body_len))
            try:
                msgs, pairs = _parse_request(body)
            except ValueError as e:
                log.warning("dropping connection %s: malformed request (%s)", peer, e)
                break
            n = len(msgs)
            del body  # free the wire buffer before the dispatch wait
            # Small requests are consensus-critical: flush at once.
            mask = await service.verify_group(msgs, pairs, urgent=n < urgent_below)
            writer.write(_encode_reply(mask))
            await writer.drain()
    finally:
        writer.close()


def warmup_backend(backend: CryptoBackend) -> None:
    """Run the backend's own warmup (`TorchBackend.warmup`: build the
    kernels and run every bucket width) before serving, so no first
    request pays for it. Backends without one need none."""
    warm = getattr(backend, "warmup", None)
    if warm is not None:
        secs = warm()
        log.info("backend warmup finished in %.1f s", secs)


async def start(
    addr: tuple[str, int],
    backend: CryptoBackend,
    max_batch: int = 8192,
    urgent_below: int = 256,
) -> tuple[asyncio.Server, BatchVerificationService]:
    """Start accepting on `addr` (port 0 picks a free port) with one
    BatchVerificationService shared by every connection, and log the
    readiness line with the bound address. Returns the server and the
    service (whose `stats`, `scheduler` and `dedup` callers may read)."""
    service = BatchVerificationService(backend, max_batch=max_batch)

    async def handler(reader, writer):
        await _handle_connection(reader, writer, service, urgent_below)

    server = await asyncio.start_server(handler, addr[0], addr[1])
    port = server.sockets[0].getsockname()[1]
    # NOTE: parsed by the benchmark harness to detect readiness.
    log.info("Crypto sidecar (%s) successfully booted on %s:%s", backend.name, addr[0], port)
    return server, service


async def serve(
    addr: tuple[str, int],
    backend: CryptoBackend,
    max_batch: int = 8192,
    urgent_below: int = 256,
) -> None:
    """Run the sidecar server forever."""
    server, _ = await start(addr, backend, max_batch, urgent_below)
    async with server:
        await server.serve_forever()


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..node.config import read_consensus_keys
    from ..utils.logging import setup_logging

    p = argparse.ArgumentParser(description="crypto verification sidecar on the card")
    p.add_argument("-v", "--verbose", action="count", default=2)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where TorchBackend verifies (cpu: the kernels' plain versions)")
    p.add_argument("--max-batch", type=int, default=8192)
    p.add_argument("--min-bucket", type=int, default=128,
                   help="narrowest bucket width in lanes (TorchBackend's min_bucket)")
    p.add_argument("--chunk", type=int, default=None, help="lanes per kernel launch (default 4,096)")
    p.add_argument(
        "--committee", default=None, metavar="PATH",
        help="node committee file: register its consensus keys as device-resident "
        "tables at boot",
    )
    p.add_argument("--sharded", action="store_true",
                   help="split every batch over every visible GPU (needs --device cuda); "
                   "--committee then registers one table replica per GPU")
    p.add_argument("--multihost", action="store_true",
                   help="join a job of several sidecars (parallel.init_multihost: MASTER_ADDR, MASTER_PORT, "
                   "WORLD_SIZE, RANK from the environment) and split every batch over every process's "
                   "devices; every sidecar of the job must be sent the same requests in the same order")
    p.add_argument("--no-warmup", action="store_true", help="skip the bucket warmup")
    args = p.parse_args(argv)
    if args.chunk is not None and args.chunk <= 0:
        p.error("--chunk must be positive")
    if args.sharded and args.device != "cuda":
        p.error("--sharded needs --device cuda")
    if args.multihost and args.sharded:
        p.error("--multihost splits over every process's devices; it cannot be given with --sharded")
    setup_logging(args.verbose)
    if args.multihost:
        from ..parallel.mesh import init_multihost

        placement = dict(mesh=init_multihost(device=None if args.device == "cuda" else args.device))
    else:
        placement = dict(sharded=True) if args.sharded else dict(device=args.device)
    backend = make_backend("torch", min_bucket=args.min_bucket, chunk=args.chunk, **placement)
    if not args.no_warmup:
        warmup_backend(backend)
    if args.committee is not None:
        # After the generic warmup, with the same warmup policy.
        backend.register_committee(read_consensus_keys(args.committee), warmup=not args.no_warmup)
    asyncio.run(serve((args.host, args.port), backend, max_batch=args.max_batch))


if __name__ == "__main__":
    main()
