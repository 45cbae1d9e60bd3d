"""The port's framed TCP front ends, `ingress/server.py` (`IngressServer`,
`IngressClient`) and `proofs/server.py` (`ProofServer`, `ProofClient`),
against the reference's over localhost TCP, with an exact tolerance
(responses and frames byte for byte):

  * the reference's `test_ingress_server_over_real_tcp` and
    `test_loadgen_over_tcp_multiple_clients_share_connection` on the port;
  * the port's client against the reference's server and the reference's
    client against the port's server: the same responses, and the same
    response frames for the same request frames;
  * a garbage frame answered MALFORMED(nonce=0) with the connection kept,
    an oversized length prefix dropping the connection (the server keeps
    serving), and the `ingress.malformed` / `proofs.malformed` counters;
  * the same for the proof port.
"""

from __future__ import annotations

import asyncio
import random
import struct

import pytest

import chip_smoke
from hotstuff_tpu import ingress as ref
from hotstuff_tpu import proofs as ref_proofs
from hotstuff_tpu.consensus import messages as ref_msgs
from hotstuff_tpu.crypto import backend as ref_backend
from hotstuff_tpu.crypto import primitives as ref_prim
from hotstuff_tpu.crypto.batch_service import BatchVerificationService as RefService
from hotstuff_tpu_torch import ingress as port
from hotstuff_tpu_torch import proofs as port_proofs
from hotstuff_tpu_torch.consensus.messages import QC, Block
from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature
from hotstuff_tpu_torch.crypto.backend import CpuBackend
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytest.importorskip("cryptography")

SEED = bytes(range(32))
PKGS = {"port": port, "ref": ref}


def _tx(pkg, nonce=1, fee=1, body=b"\x01" + bytes(31), seed=SEED):
    return pkg.ClientTransaction.new_signed(seed, nonce, fee, body)


def _pipeline(pkg):
    """A pipeline of `pkg` over OpenSSL with the default lanes, its sink."""
    if pkg is port:
        service = BatchVerificationService(CpuBackend())
    else:
        service = RefService(backend=ref_backend.CpuBackend())
    sink = asyncio.Queue(1_000)
    return sink, pkg.IngressPipeline(service, sink, pkg.IngressConfig())


async def _serve(pkg) -> tuple[int, asyncio.Queue]:
    sink, pipe = _pipeline(pkg)
    addr = ("127.0.0.1", chip_smoke._free_ports(1)[0])
    pkg.IngressServer(addr, pipe)
    await _until_listening(addr)
    return addr, sink


async def _until_listening(addr) -> None:
    for _ in range(200):
        try:
            _, w = await asyncio.open_connection(*addr)
        except OSError:
            await asyncio.sleep(0.01)
            continue
        w.close()
        return
    raise TimeoutError(f"nothing listens on {addr}")


def test_ingress_server_over_real_tcp(run_async):
    async def body():
        addr, sink = await _serve(port)
        client = port.IngressClient()
        await client.connect(addr)
        good = [_tx(port, nonce=n + 1) for n in range(5)]
        bad = port.ClientTransaction(good[0].client, 99, 1, b"\x01" + bytes(31), Signature(bytes(64)))
        responses = await asyncio.gather(*(client.submit(tx) for tx in good), client.submit(bad))
        for tx, resp in zip(good, responses[:5]):
            assert resp.nonce == tx.nonce and resp.status == port.ACCEPTED
        assert responses[5].status == port.BAD_SIGNATURE
        for tx in good:
            assert await sink.get() == tx.body
        client.close()

    run_async(body(), timeout=30)


def test_loadgen_over_tcp_multiple_clients_share_connection(run_async):
    """Several signing identities pipeline through one `IngressClient`
    connection: every submission resolves, none is orphaned."""

    async def body():
        addr, sink = await _serve(port)
        client = port.IngressClient()
        await client.connect(addr)

        async def drain():
            while True:
                await sink.get()

        drainer = asyncio.ensure_future(drain())
        gen = port.OpenLoopLoadGen(client.submit, curve=port.ArrivalCurve(kind="sustained", rate=60), duration=1.0,
                                   clients=4, tx_bytes=16, rng=random.Random(5))
        summary = await gen.run()
        drainer.cancel()
        client.close()
        return summary

    summary = run_async(body(), timeout=40)
    assert summary["offered"] > 0
    assert summary["unresolved"] == 0 and summary["errors"] == 0
    assert summary["accepted"] == summary["offered"]


async def _raw_exchange(addr, frames: list[bytes], expect: int) -> list[bytes]:
    """Send `frames` (payloads, framed here) on one connection and read
    `expect` response frames back, raw, in arrival order."""
    reader, writer = await asyncio.open_connection(*addr)
    for data in frames:
        writer.write(struct.pack(">I", len(data)) + data)
    await writer.drain()
    out = []
    for _ in range(expect):
        n = struct.unpack(">I", await reader.readexactly(4))[0]
        out.append(await reader.readexactly(n))
    writer.close()
    return out


def test_clients_and_servers_of_both_packages_interoperate(run_async):
    """The port's client against the reference's server and the reference's
    client against the port's: the same responses; and the same request
    frames sent raw to both servers (one at a time, so the order is fixed)
    come back as the same response frames."""

    async def body():
        (port_addr, port_sink), (ref_addr, ref_sink) = await _serve(port), await _serve(ref)
        results = {}
        for client_pkg, server_pkg, addr in (("port", "ref", ref_addr), ("ref", "port", port_addr)):
            c = PKGS[client_pkg]
            client = c.IngressClient()
            await client.connect(addr)
            good = [_tx(c, nonce=n + 1, seed=bytes([len(results)]) * 32) for n in range(4)]
            bad = c.ClientTransaction(good[0].client, 99, 1, b"\x01" + bytes(31), type(good[0].signature)(bytes(64)))
            replay = good[1]
            responses = await asyncio.gather(*(client.submit(tx) for tx in (*good, bad)))
            responses.append(await client.submit(replay))
            results[(client_pkg, server_pkg)] = [(r.nonce, r.status_name, r.retry_after_ms) for r in responses]
            client.close()
        assert results[("port", "ref")] == results[("ref", "port")]
        assert [s for _, s, _ in results[("port", "ref")]] == ["accepted"] * 4 + ["bad_signature", "replay"]
        frames = {}
        for pkg, addr in (("port", port_addr), ("ref", ref_addr)):
            wire = [port.encode_ingress_message(_tx(port, nonce=n, seed=b"\x07" * 32)) for n in (1, 2)]
            got = []
            for data in (*wire, wire[0], b"\xffgarbage"):
                got += await _raw_exchange(addr, [data], 1)
            frames[pkg] = got
        assert frames["port"] == frames["ref"]
        assert [port.decode_ingress_message(f).status_name for f in frames["port"]] == [
            "accepted", "accepted", "replay", "malformed"]
        return port_sink.qsize(), ref_sink.qsize()

    assert run_async(body(), timeout=40) == (6, 6)


def test_ingress_garbage_frame_kept_and_oversized_frame_dropped(run_async):
    async def body():
        addr, sink = await _serve(port)
        before = metrics.REGISTRY.counter("ingress.malformed").value
        # garbage, then a good transaction on the SAME connection
        good = port.encode_ingress_message(_tx(port, nonce=1))
        resp = await _raw_exchange(addr, [b"\xffgarbage", good], 2)
        assert port.decode_ingress_message(resp[0]) == port.IngressResponse(0, port.MALFORMED)
        assert port.decode_ingress_message(resp[1]).status == port.ACCEPTED
        # a well-formed response (not a ClientTransaction) is malformed too
        resp = await _raw_exchange(addr, [port.encode_ingress_message(port.IngressResponse(3, port.ACCEPTED))], 1)
        assert port.decode_ingress_message(resp[0]) == port.IngressResponse(0, port.MALFORMED)
        assert metrics.REGISTRY.counter("ingress.malformed").value == before + 2
        # an oversized length prefix drops the connection...
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(b"\xff\xff\xff\xff" + b"x" * 16)
        await writer.drain()
        assert await asyncio.wait_for(reader.read(), 5) == b""
        writer.close()
        # ... and the server keeps serving new ones
        resp = await _raw_exchange(addr, [port.encode_ingress_message(_tx(port, nonce=2))], 1)
        assert port.decode_ingress_message(resp[0]).status == port.ACCEPTED

    run_async(body(), timeout=30)


def test_ingress_client_fails_every_waiter_on_disconnect(run_async):
    """A server that reads and never answers, then closes: every waiter of
    the port's client fails with ConnectionError."""

    async def body():
        async def mute(reader, writer):
            await reader.read(1 << 16)
            writer.close()

        server = await asyncio.start_server(mute, "127.0.0.1", 0)
        addr = server.sockets[0].getsockname()[:2]
        client = port.IngressClient()
        await client.connect(addr)
        outcomes = await asyncio.gather(*(client.submit(_tx(port, nonce=n)) for n in (1, 1, 2)),
                                        return_exceptions=True)
        server.close()
        return outcomes

    outcomes = run_async(body(), timeout=30)
    assert all(isinstance(o, ConnectionError) for o in outcomes)


# --- the proof port --------------------------------------------------------------


def _committed(pkg_msgs, D, P, S, author_bytes: bytes, n: int = 1):
    """One committed block carrying n payload digests, and its certificate."""
    author = P(author_bytes)
    payload = tuple(D.of(f"tx-{i}".encode()) for i in range(n))
    digest = pkg_msgs.Block.make_digest(author, 1, list(payload), pkg_msgs.QC.genesis())
    block = pkg_msgs.Block(pkg_msgs.QC.genesis(), None, author, 1, payload, S(bytes(64)))
    return block, pkg_msgs.QC(digest, 1, ())


async def _proof_server(pkg: str):
    """A proof server of `pkg` whose registry knows (client, 0) as
    committed and (client, 1) as pending; returns (address, registry,
    client key)."""
    import types

    if pkg == "port":
        mod, msgs, D, P, S = port_proofs, types.SimpleNamespace(Block=Block, QC=QC), Digest, PublicKey, Signature
    else:
        mod, msgs, D, P, S = ref_proofs, ref_msgs, ref_prim.Digest, ref_prim.PublicKey, ref_prim.Signature
    client = P(b"\x05" * 32)
    block, cert = _committed(msgs, D, P, S, b"\x09" * 32, 2)
    reg = mod.ProofRegistry()
    reg.note_tx(client, 0, block.payload[0])
    reg.note_tx(client, 1, D.of(b"pending"))
    await reg.note_commit(block, cert)
    addr = ("127.0.0.1", chip_smoke._free_ports(1)[0])
    mod.ProofServer(addr, mod.ProofService(reg))
    await _until_listening(addr)
    return addr, reg, client


def test_proof_clients_and_servers_of_both_packages_interoperate(run_async):
    async def body():
        # A fresh server for each pair: a served proof feeds the service's
        # rate estimate, and so the next retry hints.
        out = {}
        for client_pkg, server_pkg in (("port", "ref"), ("ref", "port"), ("port", "port")):
            mod = port_proofs if client_pkg == "port" else ref_proofs
            P = PublicKey if client_pkg == "port" else ref_prim.PublicKey
            addr, _, client_key = await _proof_server(server_pkg)
            client = mod.ProofClient()
            await client.connect(addr)
            replies = await asyncio.gather(*(client.query(mod.ProofQuery(P(client_key.data), n, mode))
                                             for n, mode in ((0, 0), (1, 0), (2, 0), (2, 1))))
            out[(client_pkg, server_pkg)] = [mod.encode_proof_message(r) for r in replies]
            client.close()
        assert out[("port", "ref")] == out[("ref", "port")] == out[("port", "port")]
        statuses = [port_proofs.decode_proof_message(f).status_name for f in out[("port", "port")]]
        assert statuses == ["ok", "pending", "unknown", "shed"]
        frames = {}
        for pkg in ("port", "ref"):
            addr, _, client_key = await _proof_server(pkg)
            q = port_proofs.encode_proof_message(port_proofs.ProofQuery(PublicKey(client_key.data), 0))
            frames[pkg] = [f for data in (q, b"\xfe junk") for f in await _raw_exchange(addr, [data], 1)]
        assert frames["port"] == frames["ref"]

    run_async(body(), timeout=30)


def test_proof_garbage_frame_kept_and_oversized_frame_dropped(run_async):
    async def body():
        addr, reg, client_key = await _proof_server("port")
        before = metrics.REGISTRY.counter("proofs.malformed").value
        good = port_proofs.encode_proof_message(port_proofs.ProofQuery(client_key, 0))
        resp = await _raw_exchange(addr, [b"\xfe junk", good], 2)
        assert port_proofs.decode_proof_message(resp[0]) == port_proofs.ProofReply(0, port_proofs.messages.PROOF_MALFORMED)
        assert port_proofs.decode_proof_message(resp[1]).status == port_proofs.PROOF_OK
        reply_frame = port_proofs.encode_proof_message(port_proofs.ProofReply(5, port_proofs.PROOF_OK))
        resp = await _raw_exchange(addr, [reply_frame], 1)
        assert port_proofs.decode_proof_message(resp[0]).status == port_proofs.messages.PROOF_MALFORMED
        assert metrics.REGISTRY.counter("proofs.malformed").value == before + 2
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(b"\xff\xff\xff\xff")
        await writer.drain()
        assert await asyncio.wait_for(reader.read(), 5) == b""
        writer.close()
        client = port_proofs.ProofClient()
        await client.connect(addr)
        assert (await client.query(port_proofs.ProofQuery(client_key, 0))).status == port_proofs.PROOF_OK
        client.close()

    run_async(body(), timeout=30)


@pytest.mark.parametrize("n_txs", [8, 40])
def test_pipeline_batches_in_flight(run_async, n_txs):
    """A backlog drains in full batches, up to `DRAIN_WIDTH` in verification
    at once (one batch of 8 alone; five of them four at a time), with the
    same response for every transaction: valid ones accepted and forwarded,
    a bad signature rejected."""
    from hotstuff_tpu_torch.ingress.pipeline import DRAIN_WIDTH

    class Service:
        def __init__(self):
            self.now = self.peak = 0

        async def verify_group(self, msgs, pairs, **kw):
            self.now += 1
            self.peak = max(self.peak, self.now)
            await asyncio.sleep(0.01)
            self.now -= 1
            return [sig.data != bytes(64) for _, sig in pairs]

    async def body():
        service, sink = Service(), asyncio.Queue()
        pipe = port.IngressPipeline(service, sink, port.IngressConfig(verify_batch=8))
        txs = [_tx(port, nonce=n + 1) for n in range(n_txs)]
        txs[5] = port.ClientTransaction(txs[5].client, txs[5].nonce, 1, txs[5].body, Signature(bytes(64)))
        responses = await asyncio.gather(*(pipe.submit(tx) for tx in txs))
        return service.peak, [r.status_name for r in responses], sink.qsize()

    peak, statuses, forwarded = run_async(body(), timeout=30)
    assert DRAIN_WIDTH == 4
    assert peak == min(n_txs // 8, DRAIN_WIDTH)
    assert statuses == ["accepted"] * 5 + ["bad_signature"] + ["accepted"] * (n_txs - 6)
    assert forwarded == n_txs - 1


def test_pipeline_gathers_a_sparse_stream_behind_the_batch_in_flight(run_async):
    """A batch that is not full goes only while none is in flight: one
    transaction goes alone, the three that arrive while it verifies go
    together after it, as with the reference's one-at-a-time drain."""

    class Service:
        def __init__(self):
            self.sizes, self.now, self.peak = [], 0, 0

        async def verify_group(self, msgs, pairs, **kw):
            self.sizes.append(len(msgs))
            self.now += 1
            self.peak = max(self.peak, self.now)
            await asyncio.sleep(0.05)
            self.now -= 1
            return [True] * len(msgs)

    async def body():
        service, sink = Service(), asyncio.Queue()
        pipe = port.IngressPipeline(service, sink, port.IngressConfig(verify_batch=8))
        txs = [_tx(port, nonce=n + 1) for n in range(4)]
        tasks = []
        for tx in txs:
            tasks.append(asyncio.ensure_future(pipe.submit(tx)))
            await asyncio.sleep(0.005)
        responses = await asyncio.gather(*tasks)
        return service, [r.status_name for r in responses], sink.qsize()

    service, statuses, forwarded = run_async(body(), timeout=30)
    assert service.sizes == [1, 3] and service.peak == 1
    assert statuses == ["accepted"] * 4 and forwarded == 4


def test_ingress_reader_yields_to_the_loop_under_a_flood(run_async):
    """A connection whose buffer holds a flood of frames (all shed: the
    lanes hold one transaction each) is answered in full, and the reader
    yields to the event loop every YIELD_EVERY frames, so another task
    (the node's consensus, in a node) keeps running meanwhile."""
    from hotstuff_tpu_torch.ingress import server as ingress_server

    n = 4_000

    async def body():
        sink = asyncio.Queue()
        lanes = tuple(port.LaneSpec(name, fee, 1) for name, fee in (("priority", 1_000), ("standard", 1),
                                                                   ("bulk", 0)))
        pipe = port.IngressPipeline(BatchVerificationService(CpuBackend()), sink, port.IngressConfig(lanes=lanes))
        addr = ("127.0.0.1", chip_smoke._free_ports(1)[0])
        port.IngressServer(addr, pipe)
        await _until_listening(addr)
        client = _tx(port).client  # unsigned: what the one-deep lanes admit fails verification
        wire = b"".join(struct.pack(">I", len(d)) + d for d in (
            port.encode_ingress_message(port.ClientTransaction(client, i + 1, 1, b"\x01" * 32, Signature(bytes(64))))
            for i in range(n)))
        seen = [0]  # frames the server had received at each tick
        done = asyncio.Event()

        async def ticker():
            while not done.is_set():
                seen.append(pipe.stats["received"])
                await asyncio.sleep(0)

        tick_task = asyncio.ensure_future(ticker())
        reader, writer = await asyncio.open_connection(*addr)
        writer.write(wire)
        await writer.drain()
        statuses = []
        for _ in range(n):
            size = struct.unpack(">I", await reader.readexactly(4))[0]
            statuses.append(port.decode_ingress_message(await reader.readexactly(size)).status_name)
        done.set()
        await tick_task
        writer.close()
        return statuses, max(b - a for a, b in zip(seen, seen[1:]))

    statuses, run = run_async(body(), timeout=60)
    assert len(statuses) == n and set(statuses) == {"shed", "bad_signature"} and statuses.count("shed") > n // 2
    # The most frames the reader handled between two turns of the ticker.
    assert run <= ingress_server.YIELD_EVERY <= 64
