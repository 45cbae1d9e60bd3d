"""The port's crypto sidecar (`hotstuff_tpu_torch.crypto.remote`) against
the reference's (`hotstuff_tpu.crypto.remote`), on the CPU.

The wire codec must match byte for byte; the reference `RemoteBackend`
client must get from the port's sidecar (`TorchBackend(device="cpu")`,
the kernels' plain versions) the masks the reference sidecar
(`CpuBackend`, OpenSSL) gives; the ingress caps drop a connection and
keep serving; the verified-signature cache answers repeats of valid
triples only; the CLI boots and prints the readiness line the benchmark
harness waits for. Batches stay at 16 lanes or fewer: the plain kernels
take about 1.5 s a batch on the CPU.
"""

from __future__ import annotations

import asyncio
import os
import random
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("cryptography")

import chip_smoke
from hotstuff_tpu.consensus.config import Committee as RefConsensusCommittee
from hotstuff_tpu.crypto import remote as ref_remote
from hotstuff_tpu.crypto.backend import CpuBackend
from hotstuff_tpu.crypto.primitives import PublicKey as RefPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RefSignature
from hotstuff_tpu.node.config import Committee as RefCommittee
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.crypto import remote
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.node.config import ConfigError, read_consensus_keys
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _listening(port: int, timeout: float = 30.0) -> None:
    """Return once something accepts connections on the port."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            _, writer = await asyncio.open_connection("127.0.0.1", port)
        except OSError:
            assert time.monotonic() < deadline, f"nothing listens on {port}"
            await asyncio.sleep(0.05)
            continue
        writer.close()
        return


def _cpu_backend() -> TorchBackend:
    """Every batch to the backend's verifier (crossover 1), whatever its size."""
    return TorchBackend(device="cpu", crossover=1, min_bucket=16, max_bucket=16)


def _signed(n: int, seed: int, mlen: int = 32) -> list[tuple[bytes, bytes, bytes]]:
    """n (message, key, signature) triples signed by pysigner."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        sk = rng.randbytes(32)
        msg = rng.randbytes(mlen)
        pk = pysigner.keypair_from_seed(sk)[0]
        out.append((msg, pk, pysigner.sign(sk, msg, public_key=pk)))
    return out


def _digest_batch() -> list[tuple[bytes, bytes, bytes]]:
    """16 lanes over 32-byte digests (the device-hash path): valid
    signatures, one lane of each corruption class of `chip_smoke._corrupt`,
    and identity-key forgeries that OpenSSL and the card accept."""
    t = _signed(10, 1)
    p = pysigner.P
    msg, pk, sig = t[0]
    t[0] = (msg, pk, sig[:5] + bytes([sig[5] ^ 0x40]) + sig[6:])  # flipped R byte
    msg, pk, sig = t[1]
    t[1] = (msg, pk, sig[:32] + (int.from_bytes(sig[32:], "little") + pysigner.L).to_bytes(32, "little"))  # s >= L
    msg, pk, sig = t[2]
    t[2] = (bytes([msg[0] ^ 0x80]) + msg[1:], pk, sig)  # wrong message
    msg, pk, sig = t[3]
    t[3] = (msg, pk, (p + 1).to_bytes(32, "little") + sig[32:])  # non-canonical R
    no_sqrt, y_ge_p, x0_sign = chip_smoke._committee_special_keys()
    msg, pk, sig = t[4]
    t[4] = (msg, no_sqrt, sig)  # a key without a square root
    rng = random.Random(2)
    for key in (y_ge_p, x0_sign, y_ge_p):
        t.append((rng.randbytes(32), key, chip_smoke._forged_identity_sig(rng.randrange(1, 2**62))))
    msg, pk, sig = t[5]
    t.append((msg, pk, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]))  # flipped S byte
    t.append(_signed(1, 3)[0])
    t.append(t[6])  # a repeat of a valid triple inside one request
    return t


def _host_hash_batch() -> list[tuple[bytes, bytes, bytes]]:
    """The RFC 8032 vectors (messages of 0, 1 and 2 bytes) and the same
    vectors over a message one byte longer, a 33-byte message and an empty
    one signed by pysigner: the host-hash path."""
    out = []
    for pk, msg, sig in chip_smoke.RFC8032_VECTORS:
        out.append((bytes.fromhex(msg), bytes.fromhex(pk), bytes.fromhex(sig)))
        out.append((bytes.fromhex(msg) + b"\x00", bytes.fromhex(pk), bytes.fromhex(sig)))
    return out + _signed(1, 4, mlen=33) + _signed(1, 5, mlen=0)


def _ref_args(triples):
    return ([m for m, _, _ in triples], [RefPublicKey(k) for _, k, _ in triples],
            [RefSignature(s) for _, _, s in triples])


# -- the wire codec -----------------------------------------------------------


@pytest.mark.parametrize("mlens", [(32,) * 5, (0, 1, 33, 32, 200), (0,), ()])
def test_encode_request_is_the_references(mlens):
    rng = random.Random(len(mlens))
    msgs = [rng.randbytes(n) for n in mlens]
    keys = [rng.randbytes(32) for _ in mlens]
    sigs = [rng.randbytes(64) for _ in mlens]
    got = remote._encode_request(msgs, [PublicKey(k) for k in keys], [Signature(s) for s in sigs])
    want = ref_remote._encode_request(msgs, [RefPublicKey(k) for k in keys], [RefSignature(s) for s in sigs])
    assert got == want
    assert remote._encode_request(msgs, keys, sigs) == want  # raw bytes encode the same


def _item(mlen: int, fill: int = 7) -> bytes:
    return struct.pack("<I", mlen) + bytes([fill]) * mlen + bytes(range(96))


_BODIES = {
    "valid": struct.pack("<I", 2) + _item(32) + _item(0),
    "empty": struct.pack("<I", 0),
    "truncated item header": struct.pack("<I", 2) + _item(32) + b"\x01\x00",
    "item past the body": struct.pack("<I", 1) + _item(32)[:-1],
    "message past the body": struct.pack("<I", 1) + struct.pack("<I", 0x7FFFFF),
    "trailing bytes": struct.pack("<I", 1) + _item(5) + b"\x00",
    "count under the items": struct.pack("<I", 1) + _item(3) + _item(3),
    "count over the cap": struct.pack("<I", remote.MAX_REQUEST_ITEMS + 1) + _item(1),
    "count at the cap": struct.pack("<I", remote.MAX_REQUEST_ITEMS) + _item(1),
    "mlen over the cap": struct.pack("<I", 1) + struct.pack("<I", remote.MAX_MESSAGE_LEN + 1) + bytes(200),
}


@pytest.mark.parametrize("case", sorted(_BODIES))
def test_parse_request_is_the_references(case):
    body = memoryview(_BODIES[case])

    def parse(fn):
        try:
            msgs, pairs = fn(body)
        except ValueError:
            return "ValueError"
        return msgs, [(k.data, s.data) for k, s in pairs]

    got, want = parse(remote._parse_request), parse(ref_remote._parse_request)
    assert got == want
    assert (want == "ValueError") == (case not in ("valid", "empty"))


def test_caps_are_the_references():
    for cap in ("MAX_REQUEST_ITEMS", "MAX_MESSAGE_LEN", "MAX_REQUEST_BYTES"):
        assert getattr(remote, cap) == getattr(ref_remote, cap)


# -- the sidecar over TCP -----------------------------------------------------


def test_round_trip_masks_equal_the_reference_sidecar(run_async):
    """The reference client, crossover 1, against both sidecars: equal
    masks on the device-hash batch and the host-hash batch, and the port's
    lanes all verified by its backend (none on the client's CPU)."""
    batches = [_digest_batch(), _host_hash_batch()]
    backend = _cpu_backend()

    async def body():
        server, _ = await remote.start(("127.0.0.1", 0), backend)
        port = server.sockets[0].getsockname()[1]
        ref_port = _free_port()
        ref_server = asyncio.create_task(ref_remote.serve(("127.0.0.1", ref_port), CpuBackend()))
        await _listening(ref_port)
        try:
            masks = {}
            for name, p in (("port", port), ("reference", ref_port)):
                client = ref_remote.RemoteBackend(("127.0.0.1", p), crossover=1)
                masks[name] = [await asyncio.to_thread(client.verify_batch_mask, *_ref_args(b)) for b in batches]
                client._flush_pool()  # the reference client has no close()
                assert client.stats["cpu_sigs"] == 0 and client.stats["remote_sigs"] == sum(map(len, batches))
            return masks
        finally:
            server.close()
            ref_server.cancel()

    masks = run_async(body())
    assert masks["port"] == masks["reference"]
    digest_mask, host_mask = masks["port"]
    assert digest_mask == [False] * 5 + [True] * 5 + [True] * 3 + [False, True, True]
    assert host_mask == [True, False] * 3 + [True, True]
    assert backend.stats["device_sigs"] == sum(map(len, batches)) and backend.stats["host_sigs"] == 0


def test_oversized_and_malformed_requests_drop_only_that_connection(run_async):
    """Each hostile request closes its own connection with no reply; the
    sidecar serves an honest client afterwards (tests/test_remote_backend.py
    holds the reference to the same)."""
    backend = _cpu_backend()

    async def body():
        server, _ = await remote.start(("127.0.0.1", 0), backend)
        port = server.sockets[0].getsockname()[1]

        def attack(payload: bytes) -> bytes:
            with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
                s.sendall(payload)
                s.settimeout(5)
                return s.recv(4)

        try:
            frames = [
                struct.pack("<I", remote.MAX_REQUEST_BYTES + 1),
                struct.pack("<I", 3) + b"\x00" * 3,  # runt
            ] + [struct.pack("<I", len(b)) + b for b in (
                _BODIES["count over the cap"], _BODIES["message past the body"], _BODIES["trailing bytes"])]
            for frame in frames:
                assert await asyncio.to_thread(attack, frame) == b""
            client = remote.RemoteBackend(("127.0.0.1", port), crossover=1)
            triples = _signed(2, 6)
            mask = await asyncio.to_thread(
                client.verify_batch_mask, [m for m, _, _ in triples],
                [PublicKey(k) for _, k, _ in triples], [Signature(s) for _, _, s in triples])
            client.close()
            return mask, client.stats
        finally:
            server.close()

    mask, stats = run_async(body())
    assert mask == [True, True] and stats["cpu_sigs"] == 0
    assert backend.stats["device_sigs"] == 2


def test_dedup_answers_valid_repeats_only(run_async):
    """A valid triple sent again is answered from the verified-signature
    cache and never reaches the backend; an invalid one is never cached
    and reaches the backend every time."""
    backend = _cpu_backend()
    good, bad = _signed(2, 7)
    bad = (bad[0], bad[1], bytes([bad[2][0] ^ 1]) + bad[2][1:])

    async def body():
        metrics.reset()
        server, service = await remote.start(("127.0.0.1", 0), backend)
        port = server.sockets[0].getsockname()[1]
        client = remote.RemoteBackend(("127.0.0.1", port), crossover=1)
        send = lambda t: asyncio.to_thread(client.verify_batch_mask, [t[0]], [PublicKey(t[1])], [Signature(t[2])])
        try:
            seen = []
            for t in (good, bad, good, bad):
                seen.append((await send(t), backend.stats["device_sigs"]))
            return seen, len(service.dedup)
        finally:
            client.close()
            server.close()

    seen, cached = run_async(body())
    assert seen == [([True], 1), ([False], 2), ([True], 2), ([False], 3)]
    assert cached == 1
    counters = metrics.dump()["counters"]
    assert counters["verifier.dedup_hits"] == 1 and counters["verifier.dedup_misses"] == 3
    assert counters["verifier.dedup_inserts"] == 1


# -- the CLI and the committee file --------------------------------------------


def _write_committee(path: Path, n: int = 4) -> list[RefPublicKey]:
    """A node committee file as the benchmark harness writes it
    (`benchmark/config.py` `LocalCommittee`), keys from the reference's
    `Secret`."""
    from benchmark.config import LocalCommittee
    from hotstuff_tpu.node.config import Secret

    secrets = [Secret.new() for _ in range(n)]
    LocalCommittee([s.name.encode_base64() for s in secrets], 9_000).write(str(path))
    return [s.name for s in secrets]


def test_read_consensus_keys_is_the_references_order(tmp_path):
    path = tmp_path / "committee.json"
    names = _write_committee(path, 7)
    want = RefCommittee.read(str(path)).consensus.sorted_keys()
    assert read_consensus_keys(str(path)) == [k.data for k in want]
    assert sorted(k.data for k in names) == [k.data for k in want]
    # The reference's own sort (PublicKey.__lt__) on a consensus section.
    ref = RefConsensusCommittee.from_json(__import__("json").loads(path.read_text())["consensus"])
    assert [k.data for k in ref.sorted_keys()] == read_consensus_keys(str(path))
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ConfigError):
        read_consensus_keys(str(tmp_path / "bad.json"))


def test_cli_boots_and_prints_the_readiness_line(tmp_path):
    """`python -m hotstuff_tpu_torch.crypto.remote --device cpu --no-warmup
    --committee PATH` registers the committee and prints the line the
    benchmark harness waits for."""
    path = tmp_path / "committee.json"
    _write_committee(path)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    log = tmp_path / "sidecar.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hotstuff_tpu_torch.crypto.remote", "-vv", "--port", "0",
             "--device", "cpu", "--no-warmup", "--committee", str(path)],
            cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=out, start_new_session=True,
        )
    try:
        deadline = time.monotonic() + 90
        while "successfully booted" not in log.read_text() and proc.poll() is None:
            assert time.monotonic() < deadline, log.read_text()
            time.sleep(0.2)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    text = log.read_text()
    assert "registered 4-key committee for device-resident verification" in text
    assert "Crypto sidecar (torch) successfully booted on 127.0.0.1:" in text


# -- concurrent callers: the sidecar dispatches each flush on its own thread ---


def _hammer(fn, threads: int = 16, calls: int = 500) -> None:
    """`fn()` `calls` times on each of `threads` threads at a 1 µs switch
    interval; every thread must finish."""
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [fn() for _ in range(calls)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)


def test_kernel_launch_counts_are_exact_under_threads(monkeypatch):
    """Kernel.launch from 16 threads at once: the launch count is exact
    (the CUDA launch replaced by a stub returning success)."""
    import contextlib
    import types

    import torch

    from hotstuff_tpu_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    kernel = _build.Kernel("stress", lib=Path("unused"))
    kernel._fn = lambda *args: 0
    t = torch.zeros(4, dtype=torch.uint8)
    _hammer(lambda: kernel.launch(t, 4))
    assert kernel.launches == 16 * 500


def test_backend_stats_are_exact_under_threads(monkeypatch):
    """TorchBackend's stats from 16 threads at once (the verifier replaced
    by a stub that accepts every lane)."""
    import numpy as np

    backend = _cpu_backend()
    monkeypatch.setattr(backend._verifier, "verify_batch_mask", lambda m, k, s: np.ones(len(m), bool))
    msgs, keys, sigs = [b"m" * 32] * 3, [PublicKey(bytes(32))] * 3, [Signature(bytes(64))] * 3
    _hammer(lambda: backend.verify_batch_mask(msgs, keys, sigs))
    assert backend.stats["device_batches"] == 16 * 500
    assert backend.stats["device_sigs"] == 3 * 16 * 500
