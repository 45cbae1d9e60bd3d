"""`python -m hotstuff_tpu_torch.loadgen`, the port's TCP load generator,
against an in-process port `IngressServer` over localhost TCP:

  * one run against a pipeline on a plain-kernel `TorchBackend(device=
    "cpu")`: exit 0, every transaction accepted, and a summary with the
    keys of the reference's `tools/loadgen.py` (run against the same
    server);
  * `--proofs --proofs-out` against a server whose registry an in-process
    committer feeds (bodies flushed into payloads, blocks certified by
    3-of-4 pysigner QCs): every accepted transaction proved, and each
    written certificate verifies fully under both packages;
  * `--procs 2`: a merged summary whose counts are the shards' sums;
  * `--selftest` refused with exit 2, a malformed `--target` exit 3.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

import pytest

import chip_smoke
from hotstuff_tpu import proofs as ref_proofs
from hotstuff_tpu.consensus.config import Committee as RefCommittee
from hotstuff_tpu.crypto import backend as ref_backend
from hotstuff_tpu.crypto import primitives as ref_prim
from hotstuff_tpu.utils import serde as ref_serde
from hotstuff_tpu_torch import ingress
from hotstuff_tpu_torch.consensus.config import Committee
from hotstuff_tpu_torch.consensus.messages import QC, Block, _vote_digest
from hotstuff_tpu_torch.crypto import Digest, PublicKey, Signature, pysigner
from hotstuff_tpu_torch.crypto import backend as port_backend
from hotstuff_tpu_torch.crypto.backend import CpuBackend
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.proofs import CommitProof, ProofRegistry, ProofServer, ProofService
from hotstuff_tpu_torch.utils.serde import Reader
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

pytest.importorskip("cryptography")

REPO = Path(__file__).resolve().parents[1]
# The reference tool's summary keys in TCP mode (its generator's summary,
# `mode` and `target`).
SUMMARY_KEYS = {"curve", "duration_s", "clients", "offered", "responded", "accepted", "shed", "retry_hints",
                "bad_signature", "replay", "malformed", "errors", "unresolved", "shed_rate", "latency_ms", "mode",
                "target"}


async def _run(*argv: str, module: str = "hotstuff_tpu_torch.loadgen") -> tuple[int, str, str]:
    """The tool as a process, awaited without blocking the server's loop."""
    cmd = [sys.executable, "-m", module] if module else [sys.executable]
    proc = await asyncio.create_subprocess_exec(*cmd, *argv, cwd=REPO, stdout=asyncio.subprocess.PIPE,
                                                stderr=asyncio.subprocess.PIPE)
    out, err = await proc.communicate()
    return proc.returncode, out.decode(), err.decode()


def _summary(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


async def _until_listening(port: int) -> None:
    for _ in range(200):
        try:
            _, w = await asyncio.open_connection("127.0.0.1", port)
        except OSError:
            await asyncio.sleep(0.01)
            continue
        w.close()
        return
    raise TimeoutError(f"nothing listens on {port}")


async def _ingress(backend, registry=None, sink_size: int = 10_000) -> tuple[int, asyncio.Queue]:
    port = chip_smoke.free_ports_with_offsets(1, offsets=(1_000,))[0]
    sink = asyncio.Queue(sink_size)
    pipe = ingress.IngressPipeline(BatchVerificationService(backend), sink, proof_registry=registry)
    ingress.IngressServer(("127.0.0.1", port), pipe)
    await _until_listening(port)
    return port, sink


def test_loadgen_against_a_port_server_on_the_plain_kernels(run_async):
    """Exit 0, nothing shed or lost, and the reference tool's summary keys;
    the reference tool against the same server gets the same answers."""

    async def body():
        backend = TorchBackend(device="cpu", crossover=1, min_bucket=8, max_bucket=8, chunk=8)
        port, sink = await _ingress(backend)
        common = ("--target", f"127.0.0.1:{port}", "--rate", "6", "--duration", "1", "--clients", "2",
                  "--tx-bytes", "32", "-v")
        ours = await _run(*common)
        theirs = await _run(str(REPO / "tools" / "loadgen.py"), *common, "--seed", "1", module="")
        return ours, theirs, sink.qsize()

    t_before = time.time()
    (rc, out, err), (ref_rc, ref_out, _), forwarded = run_async(body(), timeout=240)
    assert rc == 0, err
    summary = _summary(out)
    assert set(summary) == SUMMARY_KEYS | {"curve_t0_unix", "answer_tail_s"}
    assert set(_summary(ref_out)) == SUMMARY_KEYS
    assert 0.0 <= summary["answer_tail_s"] < 5.0 and t_before < summary["curve_t0_unix"] < time.time()
    assert summary["offered"] == summary["accepted"] > 0
    assert summary["unresolved"] == summary["errors"] == summary["shed"] == 0
    assert ref_rc == 0 and _summary(ref_out)["accepted"] == _summary(ref_out)["offered"] > 0
    assert forwarded == summary["accepted"] + _summary(ref_out)["accepted"]
    assert f"Ingress offered: {summary['offered']} transactions" in err
    assert f"Ingress accepted: {summary['accepted']} transactions" in err


def _committee_keys():
    pairs = sorted(pysigner.keypair_from_seed(bytes([i + 1]) * 32) for i in range(4))
    return [(PublicKey(pk), seed) for pk, seed in pairs]


async def _committer(sink: asyncio.Queue, registry: ProofRegistry, keys, interval: float = 0.05) -> None:
    """The node's flush and commit in miniature: drain the bodies the
    pipeline forwarded into a payload (`note_payload`), commit it in a
    block certified by a 3-of-4 QC (`note_commit`)."""
    qc, round_ = QC.genesis(), 0
    while True:
        await asyncio.sleep(interval)
        bodies = []
        while not sink.empty():
            bodies.append(sink.get_nowait())
        if not bodies:
            continue
        round_ += 1
        payload = Digest.of(b"".join(bodies))
        registry.note_payload(bodies, payload)
        author = keys[round_ % 4][0]
        digest = Block.make_digest(author, round_, [payload], qc)
        block = Block(qc, None, author, round_, (payload,), Signature(bytes(64)))
        msg = _vote_digest(digest, round_).data
        qc = QC(digest, round_, tuple((pk, Signature(pysigner.sign(seed, msg))) for pk, seed in keys[:3]))
        await registry.note_commit(block, qc)


def test_loadgen_proofs_over_tcp_every_accepted_transaction_proved(run_async, tmp_path):
    keys = _committee_keys()
    out_path = tmp_path / "certs.jsonl"

    async def body():
        registry = ProofRegistry()
        port, sink = await _ingress(CpuBackend(), registry)
        ProofServer(("127.0.0.1", port + 1_000), ProofService(registry))
        await _until_listening(port + 1_000)
        task = asyncio.ensure_future(_committer(sink, registry, keys))
        common = ("--target", f"127.0.0.1:{port}", "--rate", "40", "--duration", "1", "--clients", "4",
                  "--tx-bytes", "64", "--proofs")
        try:
            ours = await _run(*common, "--proofs-out", str(out_path))
            theirs = await _run(str(REPO / "tools" / "loadgen.py"), *common, "--seed", "1", module="")
            return ours, theirs
        finally:
            task.cancel()

    (rc, out, err), (_, ref_out, _) = run_async(body(), timeout=120)
    assert rc == 0, err
    # The reference's tracker also looks for the transaction's digest among
    # the payload digests, which name flushed batches here: it counts every
    # proof served as failed.
    ref_proofs_seen = _summary(ref_out)["proofs"]
    assert ref_proofs_seen["served"] == ref_proofs_seen["verify_failed"] > 0
    s = _summary(out)
    proofs = s["proofs"]
    assert s["accepted"] == s["offered"] > 0
    assert proofs["tracked"] == proofs["served"] == proofs["verified_ok"] == s["accepted"]
    assert proofs["verify_failed"] == proofs["errors"] == proofs["pending"] == 0
    assert proofs["verified"] == "binding-only" and proofs["proof_bytes_max"] > 0
    lines = [json.loads(line) for line in out_path.read_text().splitlines()]
    assert len(lines) == proofs["certificates"] > 0
    members = [(pk, 1, ("127.0.0.1", 1)) for pk, _ in keys]
    cmt = Committee.new(members)
    ref_cmt = RefCommittee.new([(ref_prim.PublicKey(pk.data), s_, a) for pk, s_, a in members])
    prev, ref_prev = port_backend.set_backend(CpuBackend()), ref_backend.set_backend(ref_backend.CpuBackend())
    try:
        for line in lines:
            wire = bytes.fromhex(line["proof"])
            CommitProof.decode(Reader(wire)).verify(cmt)
            ref_proofs.CommitProof.decode(ref_serde.Reader(wire)).verify(ref_cmt)
    finally:
        port_backend.set_backend(prev)
        ref_backend.set_backend(ref_prev)


def test_loadgen_procs_merges_its_shards(run_async, tmp_path):
    async def body():
        port, sink = await _ingress(CpuBackend())
        return await _run("--target", f"127.0.0.1:{port}", "--rate", "20", "--duration", "1", "--clients", "4",
                          "--procs", "2", "--json-out", str(tmp_path / "s.json")), sink.qsize()

    (rc, out, err), forwarded = run_async(body(), timeout=180)
    assert rc == 0, err
    merged = _summary(out)
    assert json.loads((tmp_path / "s.json").read_text()) == merged
    assert merged["mode"] == "sharded" and merged["procs"] == 2 and merged["shard_rcs"] == [0, 0]
    shards = merged["shards"]
    assert len(shards) == 2 and all(s["mode"] == "tcp" for s in shards)
    for key in ("offered", "accepted", "shed", "responded", "errors", "unresolved"):
        assert merged[key] == sum(s[key] for s in shards)
    assert merged["answer_tail_s"] == max(s["answer_tail_s"] for s in shards)
    assert merged["curve_t0_unix"] == min(s["curve_t0_unix"] for s in shards)
    assert [s["curve"]["rate"] for s in shards] == [10.0, 10.0]
    assert merged["accepted"] == merged["offered"] == forwarded > 0
    assert set(merged["latency_ms"]) == {"p50", "p99", "max"}


@pytest.mark.parametrize("argv, rc, said", [
    (["--selftest"], 2, "A.11.4"),
    (["--target", "no-port-here"], 3, "malformed target"),
    (["--target", "127.0.0.1:9", "--proofs-target", "x:y"], 3, "malformed target"),
])
def test_loadgen_refusals(argv, rc, said, capsys):
    from hotstuff_tpu_torch import loadgen

    try:
        code = loadgen.main(argv)
    except SystemExit as e:
        code = e.code
    assert code == rc and said in capsys.readouterr().err
