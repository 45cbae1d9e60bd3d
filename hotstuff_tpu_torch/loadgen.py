"""Open-loop signed-transaction load generator against a live node's ingress.

    # against a port node started with `node.main run --ingress`, whose
    # front port is 8100 (ingress on front + 1,000):
    python -m hotstuff_tpu_torch.loadgen --target 127.0.0.1:9100 --curve flash \\
        --rate 100 --duration 10 --tx-bytes 512 --proofs

    # four generator processes, rates split, merged summary:
    python -m hotstuff_tpu_torch.loadgen --target 127.0.0.1:9100 --rate 5000 --procs 4

    # self-contained mode: an in-process ingress pipeline (the port's
    # pure-Python verifier, inline, paced drain) on the chaos virtual-time
    # loop; no node, no card, no OpenSSL, deterministic per --seed:
    python -m hotstuff_tpu_torch.loadgen --selftest --curve flash --duration 20
    python -m hotstuff_tpu_torch.loadgen --selftest --proofs --rate 50 --duration 10
    python -m hotstuff_tpu_torch.loadgen --selftest --procs 4 --rate 400 --duration 10

The port's copy of the reference's `tools/loadgen.py`.
Traffic is OPEN loop (`ingress/loadgen.py`): arrivals follow the curve
whatever the node answers, which is what makes admission control
observable. Every transaction is ed25519-signed by one of `--clients`
identities (OpenSSL where `cryptography` imports, else the exact
`pysigner`; both give the same bytes) and submitted over one
`IngressClient` connection.

`--proofs` subscribes for a commit proof on the node's proof port (ingress
port + 1,000, the `proofs_port_offset - ingress_port_offset` gap, or
`--proofs-target`) for every ACCEPTED transaction and reports the
submit-to-proof latency percentiles. Each proof is checked for what a
client holding no committee file can check: the certificate binds the
recomputed block digest at the block's round. A node's block names
payload digests (mempool batches), not transaction digests, so that a
transaction rode the proved block is the serving node's pairing
(`ProofRegistry.note_payload`) and not checkable from the proof: the
reference's tracker also requires the transaction's digest among the
payload digests, which holds only where transaction digests ride blocks
directly, and so counts every proof a node serves as failed. The
selftest's tracker holds the committee and its blocks carry transaction
digests: it makes the reference's full check, the digest among the
payload and each distinct certificate verified once against the
committee. `--proofs-out PATH`
writes one JSON line a distinct certificate (the first proof that carried
it, hex, and the transaction it answered), for a full check elsewhere.

`--selftest` is the reference's design: `IngressPipeline` over a
`BatchVerificationService(PurePythonBackend(), inline=True)` with small
fee lanes and a drain paced to `--capacity` tx/s, so overload, shedding
and retry hints show without a node; with `--proofs` a synthetic 4-key
committee (`_SelftestCommitter`) certifies the admitted digests every
`--commit-interval` virtual seconds into real signed blocks and 3-of-4
QCs, and the tracker verifies every served proof statelessly. It runs on
the host by design and never reaches the card (ROADMAP §C, departure 9).

`--procs N` shards the curve over N subprocesses of this module: the rates
split evenly, the seeds disjoint (each shard's clients, and so their
(client, nonce) pairs, its own), the summaries merged (counts add,
latency percentiles pooled by `utils/telemetry.merge_lane_summaries`).

Prints ONE JSON summary line (offered/accepted/shed counts, shed rate,
client latency percentiles, the curve; beyond the reference's keys,
`curve_t0_unix`, the wall clock at the curve's start, and `answer_tail_s`,
how long after the curve's end the last answer came: the earliest and the
slowest shard's with `--procs`) to stdout; `--json-out` also writes
it to a file. The `Ingress offered/accepted/shed/...` log lines that
`benchmark/logs.py` scrapes land on stderr with -v.

Exit codes: 0 = ran (sheds are a measurement, not a failure); 2 =
transport errors (a refused connection included), unresolved
submissions, or bad flags (argparse); 3 = malformed --target or
--proofs-target.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import sys
import time
from pathlib import Path

from collections import deque

from .ingress import ArrivalCurve, IngressClient, IngressConfig, IngressPipeline, LaneSpec, OpenLoopLoadGen
from .ingress import messages as ingress_messages
from .proofs import MODE_SUBSCRIBE, PROOF_OK, ProofClient, ProofQuery
from .utils.actors import spawn
from .utils.metrics import percentile
from .utils.telemetry import merge_lane_summaries


def _curve_from_args(args) -> ArrivalCurve:
    return ArrivalCurve(
        kind=args.curve,
        rate=args.rate,
        peak=args.peak if args.peak else args.rate * 5.0,
        t_start=args.spike_start,
        t_end=args.spike_end,
        period=args.period,
    )


def _selftest_config(capacity: float) -> IngressConfig:
    """Small lanes + a paced drain (`capacity` tx/s) so overload, and
    therefore shedding and retry-after hints, shows without a real
    backend behind the pipeline."""
    batch = 8
    return IngressConfig(
        lanes=(
            LaneSpec("priority", min_fee=1_000, capacity=32),
            LaneSpec("standard", min_fee=1, capacity=64),
            LaneSpec("bulk", min_fee=0, capacity=64),
        ),
        verify_batch=batch,
        verify_interval=batch / max(capacity, 1.0),
    )


async def _drive(submit, args, rng) -> dict:
    """Run the curve; the summary adds `curve_t0_unix`, the wall clock at the
    curve's start (for matching node logs), and `answer_tail_s`, the seconds
    from the curve's end to the last answer received (0.0 with none after
    it): what the generator's wait for late answers (`OpenLoopLoadGen.run`,
    5 s) had to cover before `unresolved` would count one."""
    loop = asyncio.get_running_loop()
    last_answer = [0.0]

    async def stamped(tx):
        resp = await submit(tx)
        last_answer[0] = loop.time()
        return resp

    gen = OpenLoopLoadGen(
        stamped,
        curve=_curve_from_args(args),
        duration=args.duration,
        clients=args.clients,
        tx_bytes=args.tx_bytes,
        rng=rng,
    )
    curve_t0_unix = time.time()
    curve_end = loop.time() + args.duration
    await gen.run()
    summary = gen.log_summary()
    summary["curve_t0_unix"] = round(curve_t0_unix, 3)
    summary["answer_tail_s"] = round(max(0.0, last_answer[0] - curve_end), 3)
    return summary


class _ProofTracker:
    """--proofs client plane: wraps submit so every ACCEPTED transaction
    also subscribes for its commit proof, then checks what a client CAN
    check: without `committee` (TCP: the generator holds no committee
    file) the digest-binding subset (certificate hash == recomputed block
    digest, certificate round == block round; the tx digest is not looked
    for among the payload digests, since a node's payloads are batches);
    with it (the selftest, whose blocks carry tx digests) the reference's
    full check: the tx digest in the payload, and the certificate against
    the committee keys once per distinct certificate (proofs from one
    block share it)."""

    def __init__(self, subscribe, committee=None) -> None:
        self._subscribe = subscribe  # async ProofQuery -> ProofReply
        self.committee = committee
        self.stats = {
            "tracked": 0, "served": 0, "verified_ok": 0,
            "verify_failed": 0, "retries": 0, "errors": 0,
            "proof_bytes_max": 0,
        }
        self.latencies_s: list[float] = []
        self._verified_certs: set[tuple[bytes, int]] = set()
        # (cert hash, round) -> (first proof that carried it, its tx digest)
        self.certs: dict[tuple[bytes, int], tuple[object, object]] = {}

    def track(self, tx) -> None:
        """Start one subscribe-until-commit client for an ACCEPTED tx."""
        self.stats["tracked"] += 1
        spawn(
            self._track(tx.client, tx.nonce, tx.digest()),
            name=f"loadgen-proof-{self.stats['tracked']}",
        )

    async def _track(self, client, nonce, digest) -> None:
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        while True:
            try:
                reply = await self._subscribe(
                    ProofQuery(client, nonce, MODE_SUBSCRIBE)
                )
            except (ConnectionError, OSError):
                self.stats["errors"] += 1
                return
            if reply.status == PROOF_OK:
                break
            self.stats["retries"] += 1
            await asyncio.sleep(max(reply.retry_after_ms, 50) / 1000.0)
        proof = reply.proof
        self.stats["served"] += 1
        self.latencies_s.append(loop.time() - t0)
        self.stats["proof_bytes_max"] = max(
            self.stats["proof_bytes_max"], proof.encoded_size()
        )
        if self._verify(proof, digest):
            self.stats["verified_ok"] += 1
            self.certs.setdefault(
                (proof.cert.hash.data, proof.cert.round), (proof, digest)
            )
        else:
            self.stats["verify_failed"] += 1

    def _verify(self, proof, digest) -> bool:
        try:
            if proof.cert.hash != proof.block_digest():
                return False
            if proof.cert.round != proof.round:
                return False
            if self.committee is not None:
                if digest not in proof.payload:
                    return False
                key = (proof.cert.hash.data, proof.cert.round)
                if key not in self._verified_certs:
                    proof.cert.verify(self.committee)
                    self._verified_certs.add(key)
            return True
        except Exception:
            return False

    async def settle(self, grace_s: float = 10.0) -> None:
        """Give in-flight subscriptions past the load window a bounded
        chance to resolve (the commit tail is still draining)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + grace_s
        while (
            self.stats["served"] + self.stats["errors"]
            < self.stats["tracked"]
            and loop.time() < deadline
        ):
            await asyncio.sleep(0.2)

    def summary(self) -> dict:
        lat_ms = [s * 1000.0 for s in self.latencies_s]
        out = dict(self.stats)
        out["pending"] = self.stats["tracked"] - self.stats["served"]
        out["verified"] = "stateless" if self.committee else "binding-only"
        out["certificates"] = len(self.certs)
        out["latency_ms"] = {
            "count": len(lat_ms),
            "p50": round(percentile(lat_ms, 0.50), 3),
            "p99": round(percentile(lat_ms, 0.99), 3),
            "max": round(max(lat_ms), 3) if lat_ms else 0.0,
        }
        return out

    def write_certs(self, path: str) -> None:
        """One JSON line a distinct certificate: the first proof that
        carried it (hex of its encoding) and the tx digest it answered."""
        from .utils.serde import Writer

        with open(path, "w") as f:
            for proof, digest in self.certs.values():
                w = Writer()
                proof.encode(w)
                f.write(json.dumps({"proof": w.bytes().hex(), "tx": digest.data.hex()}) + "\n")


class _SelftestCommitter:
    """--selftest --proofs commit plane: a seeded 4-key pysigner
    committee whose synthetic leader drains admitted tx digests into REAL
    signed Blocks certified by REAL 3-of-4 QCs every `interval`, feeding
    ProofRegistry.note_commit, so the served proofs verify under the
    stateless check a client runs, with no consensus stack in the loop."""

    QUORUM = 3  # 2f+1 of 4

    def __init__(self, registry, rng, interval: float = 0.25) -> None:
        from .consensus.config import Committee
        from .consensus.messages import QC
        from .crypto import pysigner
        from .crypto.primitives import PublicKey

        self.registry = registry
        self.interval = interval
        pairs = sorted(pysigner.keypair_from_seed(rng.randbytes(32)) for _ in range(4))
        self._keys = [(PublicKey(pk), seed) for pk, seed in pairs]
        self.committee = Committee.new([(pk, 1, ("127.0.0.1", 0)) for pk, _ in self._keys])
        self.pending: deque = deque(maxlen=65_536)
        self._qc = QC.genesis()
        self._round = 0
        self.blocks = 0

    async def run(self) -> None:
        # Signing through pysigner, not OpenSSL: the selftest needs no
        # `cryptography`.
        from .consensus.messages import QC, Block
        from .crypto import pysigner
        from .crypto.primitives import Signature

        while True:
            await asyncio.sleep(self.interval)
            if not self.pending:
                continue
            payload = tuple(self.pending.popleft() for _ in range(min(len(self.pending), 8)))
            self._round += 1
            author_pk, author_seed = self._keys[self._round % len(self._keys)]
            digest = Block.make_digest(author_pk, self._round, list(payload), self._qc)
            block = Block(self._qc, None, author_pk, self._round, payload,
                          Signature(pysigner.sign(author_seed, digest.data)))
            vote_digest = QC(block.digest(), self._round, ()).signed_digest()
            qc = QC(block.digest(), self._round,
                    tuple((pk, Signature(pysigner.sign(seed, vote_digest.data)))
                          for pk, seed in self._keys[: self.QUORUM]))
            await self.registry.note_commit(block, qc)
            self._qc = qc
            self.blocks += 1


def _run_selftest(args) -> dict:
    """The in-process pipeline on the virtual-time loop (module docstring):
    the port's `PurePythonBackend`, inline, as the process's backend too
    (the proof tracker's certificate checks dispatch through it)."""
    import random

    from .chaos import vtime
    from .crypto.backend import set_backend
    from .crypto.batch_service import BatchVerificationService
    from .crypto.pysigner import PurePythonBackend

    async def body() -> dict:
        prev_backend = set_backend(PurePythonBackend())
        service = BatchVerificationService(backend=PurePythonBackend(), inline=True)
        sink: asyncio.Queue = asyncio.Queue(100_000)

        async def drain() -> None:
            while True:
                await sink.get()

        drainer = spawn(drain(), name="loadgen-selftest-drain")
        pipeline = IngressPipeline(service, sink, _selftest_config(args.capacity))
        submit = pipeline.submit
        tracker = committer_task = None
        if args.proofs:
            from .proofs import ProofRegistry, ProofService

            registry = ProofRegistry()
            proof_service = ProofService(registry)
            # Its own stream: the traffic's replay must not shift when
            # --proofs toggles.
            committer = _SelftestCommitter(registry, random.Random(args.seed ^ 0x5051),
                                           interval=args.commit_interval)
            loop = asyncio.get_running_loop()
            tracker = _ProofTracker(lambda q: proof_service.handle(q, loop.time()), committee=committer.committee)
            committer_task = spawn(committer.run(), name="loadgen-committer")
            base_submit = submit

            async def submit_with_proofs(tx):
                resp = await base_submit(tx)
                if resp.status == ingress_messages.ACCEPTED:
                    # The admitted digest rides the next synthetic block
                    # and a proof client subscribes for it.
                    registry.note_tx(tx.client, tx.nonce, tx.digest())
                    committer.pending.append(tx.digest())
                    tracker.track(tx)
                return resp

            submit = submit_with_proofs
        try:
            summary = await _drive(submit, args, random.Random(args.seed))
            if tracker is not None:
                await tracker.settle()
        finally:
            drainer.cancel()
            if committer_task is not None:
                committer_task.cancel()
            set_backend(prev_backend)
        summary["mode"] = "selftest"
        if tracker is not None:
            summary["proofs"] = tracker.summary()
            summary["proofs"]["blocks"] = committer.blocks
            if args.proofs_out:
                tracker.write_certs(args.proofs_out)
        return summary

    return vtime.run(body(), timeout=args.duration * 20 + 600, wall_timeout=600)


def _split_target(target: str) -> tuple[str, int] | None:
    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        return None
    return host, int(port)


def _run_tcp(args) -> dict:
    import random

    host, port = _split_target(args.target)

    async def body() -> dict:
        client = IngressClient()
        await client.connect((host, port))
        proof_client = tracker = None
        submit = client.submit
        if args.proofs:
            # The proof port rides the same host as ingress, offset by
            # (proofs_port_offset - ingress_port_offset); --proofs-target
            # overrides when the node was configured differently.
            if args.proofs_target:
                phost, pport = _split_target(args.proofs_target)
            else:
                phost, pport = host, port + 1_000
            proof_client = ProofClient()
            await proof_client.connect((phost, pport))
            tracker = _ProofTracker(proof_client.query)
            base_submit = submit

            async def submit_with_proofs(tx):
                resp = await base_submit(tx)
                if resp.status == ingress_messages.ACCEPTED:
                    tracker.track(tx)
                return resp

            submit = submit_with_proofs
        try:
            summary = await _drive(submit, args, random.Random(args.seed))
            if tracker is not None:
                await tracker.settle()
        finally:
            client.close()
            if proof_client is not None:
                proof_client.close()
        summary["mode"] = "tcp"
        summary["target"] = args.target
        if tracker is not None:
            summary["proofs"] = tracker.summary()
            if args.proofs_out:
                tracker.write_certs(args.proofs_out)
        return summary

    return asyncio.run(body())


def _shard_argv(args, index: int, procs: int, json_path: str, proofs_path: str | None) -> list[str]:
    """Per-shard CLI: the curve is split 1/procs per process (open-loop
    rates add), seeds are disjoint (so each shard signs with clients of its
    own), summaries land in per-shard files."""
    argv = ["--selftest"] if args.selftest else ["--target", args.target]
    argv += [
        "--curve", args.curve,
        "--rate", str(args.rate / procs),
        "--peak", str(args.peak / procs if args.peak else 0.0),
        "--spike-start", str(args.spike_start),
        "--spike-end", str(args.spike_end),
        "--period", str(args.period),
        "--duration", str(args.duration),
        "--clients", str(max(1, args.clients // procs)),
        "--tx-bytes", str(args.tx_bytes),
        "--seed", str(args.seed + index),
        "--capacity", str(args.capacity / procs),
        "--commit-interval", str(args.commit_interval),
        "--json-out", json_path,
    ]
    if args.proofs:
        argv.append("--proofs")
    if args.proofs_target:
        argv += ["--proofs-target", args.proofs_target]
    if proofs_path:
        argv += ["--proofs-out", proofs_path]
    if args.verbose:
        argv.append("-v")
    return argv


def _merge_shards(summaries: list[dict], procs: int) -> dict:
    """Pool per-shard summaries into one fleet view: counts add, latency
    percentiles merge through telemetry.merge_lane_summaries (the same
    count-weighted pooling the fleet rollup uses)."""
    counts = (
        "offered", "responded", "accepted", "shed", "retry_hints",
        "bad_signature", "replay", "malformed", "errors", "unresolved",
    )
    merged: dict = {"mode": "sharded", "procs": procs, "shards": summaries}
    for k in counts:
        merged[k] = sum(s.get(k, 0) for s in summaries)
    merged["shed_rate"] = (
        merged["shed"] / merged["responded"] if merged["responded"] else 0.0
    )
    merged["curve_t0_unix"] = min(s.get("curve_t0_unix", 0.0) for s in summaries)
    merged["answer_tail_s"] = max(s.get("answer_tail_s", 0.0) for s in summaries)
    lanes = {
        f"shard-{i}": {
            "client": {
                "count": s.get("responded", 0),
                "p50_ms": s.get("latency_ms", {}).get("p50", 0.0),
                "p99_ms": s.get("latency_ms", {}).get("p99", 0.0),
                "max_ms": s.get("latency_ms", {}).get("max", 0.0),
            }
        }
        for i, s in enumerate(summaries)
    }
    pooled = merge_lane_summaries(lanes).get("client")
    if pooled:
        merged["latency_ms"] = {
            "p50": pooled["p50_ms"], "p99": pooled["p99_ms"],
            "max": pooled["max_ms"],
        }
    if any("proofs" in s for s in summaries):
        pcounts = (
            "tracked", "served", "verified_ok", "verify_failed",
            "retries", "errors", "pending",
        )
        proofs: dict = {
            k: sum(s.get("proofs", {}).get(k, 0) for s in summaries)
            for k in pcounts
        }
        proofs["proof_bytes_max"] = max(
            s.get("proofs", {}).get("proof_bytes_max", 0) for s in summaries
        )
        plat = merge_lane_summaries(
            {
                f"shard-{i}": {
                    "proof": {
                        "count": s["proofs"]["latency_ms"].get("count", 0),
                        "p50_ms": s["proofs"]["latency_ms"].get("p50", 0.0),
                        "p99_ms": s["proofs"]["latency_ms"].get("p99", 0.0),
                        "max_ms": s["proofs"]["latency_ms"].get("max", 0.0),
                    }
                }
                for i, s in enumerate(summaries)
                if "proofs" in s
            }
        ).get("proof")
        if plat:
            proofs["latency_ms"] = {
                "count": plat["count"], "p50": plat["p50_ms"],
                "p99": plat["p99_ms"], "max": plat["max_ms"],
            }
        merged["proofs"] = proofs
    return merged


def _run_procs(args) -> tuple[dict, int]:
    """--procs N: N loadgen subprocesses with split rates and disjoint
    seeds, merged into one summary. One generator process tops
    out around a few thousand signed tx/s; sharding is how the tool offers
    more."""
    import subprocess
    import tempfile

    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs: list[subprocess.Popen] = []
    paths: list[str] = []
    proof_paths: list[str] = []
    with tempfile.TemporaryDirectory(prefix="loadgen-shards-") as tmp:
        for i in range(args.procs):
            path = os.path.join(tmp, f"shard-{i}.json")
            proofs_path = os.path.join(tmp, f"proofs-{i}.jsonl") if args.proofs_out else None
            paths.append(path)
            if proofs_path:
                proof_paths.append(proofs_path)
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "hotstuff_tpu_torch.loadgen"]
                    + _shard_argv(args, i, args.procs, path, proofs_path),
                    env=env,
                )
            )
        rcs = [p.wait() for p in procs]
        summaries = []
        for path in paths:
            try:
                with open(path) as f:
                    summaries.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                pass
        if args.proofs_out:
            with open(args.proofs_out, "w") as out:
                for path in proof_paths:
                    if os.path.exists(path):
                        out.write(Path(path).read_text())
    merged = _merge_shards(summaries, args.procs)
    merged["shard_rcs"] = rcs
    rc = 2 if (any(rcs) or len(summaries) != args.procs) else 0
    return merged, rc


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.loadgen", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--target", default=None, help="ingress address host:port of a live node")
    mode.add_argument("--selftest", action="store_true",
                      help="drive an in-process ingress pipeline on the virtual-time loop")
    ap.add_argument("--curve", default="sustained", choices=["sustained", "diurnal", "flash"])
    ap.add_argument("--rate", type=float, default=100.0, help="base tx/s")
    ap.add_argument("--peak", type=float, default=0.0, help="spike/ramp peak tx/s (default 5x rate)")
    ap.add_argument("--spike-start", type=float, default=0.0)
    ap.add_argument("--spike-end", type=float, default=0.0)
    ap.add_argument("--period", type=float, default=60.0, help="diurnal period (s)")
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--clients", type=int, default=8, help="signing identities")
    ap.add_argument("--tx-bytes", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=float, default=80.0,
                    help="selftest drain capacity (tx/s) the curve runs against")
    ap.add_argument("--json-out", default=None, help="also write the summary here")
    ap.add_argument("--proofs", action="store_true",
                    help="subscribe for a commit proof on every ACCEPTED tx and report submit-to-proof "
                    "latency percentiles (selftest: a synthetic 4-key committer certifies admitted digests "
                    "with real QCs and proofs verify statelessly; tcp: queries the node's proof port)")
    ap.add_argument("--proofs-target", default=None,
                    help="proof port host:port (default: ingress port + 1000, the "
                    "proofs_port_offset - ingress_port_offset gap)")
    ap.add_argument("--proofs-out", default=None,
                    help="with --proofs: write one JSON line a distinct certificate received "
                    "(its first proof, hex, and that proof's tx digest) to this path")
    ap.add_argument("--commit-interval", type=float, default=0.25,
                    help="selftest --proofs: synthetic commit tick (virtual seconds)")
    ap.add_argument("--procs", type=int, default=1,
                    help="shard the curve across N loadgen subprocesses (rates split evenly, seeds "
                    "disjoint) and merge the summaries")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.procs < 1:
        ap.error("--procs must be >= 1")
    if args.proofs_out and not args.proofs:
        ap.error("--proofs-out needs --proofs")
    if args.curve == "flash" and args.spike_end <= args.spike_start:
        # A flash curve without a window is just `sustained`; default the
        # spike to the middle third of the run.
        args.spike_start = args.duration / 3.0
        args.spike_end = 2.0 * args.duration / 3.0
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    for target in (args.target, args.proofs_target):
        if target is not None and _split_target(target) is None:
            print(f"malformed target {target!r}: need host:port", file=sys.stderr)
            return 3  # argparse owns flag errors (rc 2)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
    )
    if args.procs > 1:
        summary, rc = _run_procs(args)
    elif args.selftest:
        summary = _run_selftest(args)
        rc = 2 if summary.get("errors") or summary.get("unresolved") else 0
    else:
        try:
            summary = _run_tcp(args)
        except OSError as e:  # the node's port refused or dropped the connection
            print(f"loadgen: {args.target}: {e!r}", file=sys.stderr)
            return 2
        rc = 2 if summary.get("errors") or summary.get("unresolved") else 0
    line = json.dumps(summary, sort_keys=True)
    print(line)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
