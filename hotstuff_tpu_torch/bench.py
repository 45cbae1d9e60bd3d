"""The port's benchmark: votes verified per second on the card against
OpenSSL on the host.

    python -m hotstuff_tpu_torch.bench [--committee-cache on|off] [--kernel w4|bits|pallas]
        [--mesh [N]] [--pipeline-ab] [--committee-scale] [--ingress] [--scheduler-ab]
        [--aggregate-ab [--agg-sizes 4,16,64]] [--metrics-out PATH] [--trace-out PATH]
        [--device cuda|cpu]

A port of the device legs of the root `bench.py` (`bench.py:36-311`,
`:803-1266`), with the same flags and defaults except where a departure
below says otherwise. It prints one JSON line last:
  * `value`: the kernel-only rate on resident tensors (`bench_device`:
    K3, K1 or K7, K4 through `ops/ladder.py` `verify_args`);
  * `e2e_value`: the verifier's rate (`bench_e2e`: native staging, the
    dispatch pipeline, K2, K3, K1, K4, one mask readback a chunk);
  * `vs_baseline` / `e2e_vs_baseline`: each over OpenSSL's single-thread
    rate on the host (`bench_cpu`); `cpu_multicore` is OpenSSL on every
    host thread;
  * with `--committee-cache on|off`, `committee_value`: a QC-shaped
    workload (64 validators, 2N/3 + 1 votes a QC) through the committee
    path (K2g, K5, K4 over registered tables) or the generic kernels;
  * with `--mesh`, `mesh_devices`; the device timeline's `occupancy`,
    `overlap_headroom` and `device_timeline` (`ops/timeline.py`);
  * `backend` (`cuda`, or `cpu` when asked for), `device` (the card's
    name) and `power_limit_w` (`nvidia-smi`'s power.limit), so that every
    number on the line is read beside the card it was taken on.
`--metrics-out PATH` writes the metrics registry (`utils/metrics.py`, the
reference's layout): the verifier's spans and counters and `TorchBackend`'s
routing counters. `--trace-out PATH` writes the flight recorder
(`utils/tracing.py`, the reference's layout) after any leg.

Legs that print their own payload instead of the default line, with the
reference's keys:
  * `--pipeline-ab`: depth 1 against depth 2 on `pipeline_workload`, three
    attempts a leg, no early stop, masks bit-identical;
  * `--ingress` (`bench.py:416-499`): open-loop flash-crowd signed client
    traffic (`--ingress-rate` tx/s, x5 in the middle third of
    `--ingress-duration` s, `--ingress-clients` identities) through an
    `IngressPipeline` (batches of `--ingress-batch`) and a
    `BatchVerificationService` over `TorchBackend`: offered against
    committed tx/s, shed, client latency percentiles. The port adds the
    committed count, the signer (`signer`, `signer_sigs_per_s`), the
    pipeline's counts and the backend's routes (`routes`: host and card
    batches and lanes);
  * `--scheduler-ab` (`bench.py:502-655`): the legacy single-queue flush
    loop against the device scheduler, each for `--sched-duration` s, on
    `--sched-feeders` closed-loop bulk feeders of `--sched-bulk` and one
    consensus feeder of `--sched-critical` every `--sched-interval` s:
    each lane's queueing delay, verified/s, `p99_improvement`,
    `verified_ratio`. The port adds each leg's `flush_loop` (the service
    task's coroutine) and `masks_all_true`, and the backend's `routes`;
  * `--aggregate-ab` (`bench.py:658-800`): per committee size of
    `--agg-sizes`, the wire bytes of an encoded n-vote `QC` against an
    `AggQC`, and the verify wall of each form (n exact ed25519 checks on
    the host against one `ops/bls.py` `CommitteeTable.verify_aggregate`:
    K6's affine entry on `--device`, then one pairing on the host).

Deliberate departures from the reference:
  * `--device {cuda,cpu}`, default `cuda`. Without a card and without
    `--device cpu` the bench raises; it never moves to the CPU on its own.
    The reference's relay probe, its CPU downscaling, its junk-batch
    metrics and its rc-0 error payload are not carried over: a failing leg
    raises, and the process exits non-zero. Small runs pass small sizes
    (`--batch`, `--device-batch`, `--chunk`) explicitly.
  * `--kernel` defaults to `w4`, what `TorchBackend` runs. `pallas` runs
    the same K3, K1 and K4, with buckets rounded to 256 lanes.
  * `--committee-scale` verifies each QC as its own batch through
    `TorchBackend` at its default crossovers, with the committee
    registered, as a node checks a QC; the reference verifies all of a
    committee's QCs as one batch on the verifier. So quorums under
    `committee_crossover` (3 and 7 at committees of 4 and 10 on the OpenSSL
    route) take the host route, which the table's `route` column names.
    It ends with a JSON line too (`value`: the committee of 64's rate),
    where the reference prints only the table.
  * `--ingress` and `--scheduler-ab` run `TorchBackend` on `--device` at
    its default crossovers. The reference's probe that degrades to its
    pure-Python verifier is not carried over, and `--ingress-backend pure`
    and `--sched-backend pure` are refused. The scheduler A/B's downscale
    (bulk 8, critical 3, 3 feeders) applies only under `--device cpu`.
  * The ingress load generator signs through OpenSSL where `cryptography`
    imports (`ingress/loadgen.py` `make_signer`), else the port's exact
    signer; the reference signs with its exact pure-Python signer, which
    caps the offered rate. The signatures are the same bytes. A leg whose
    pipeline rejected a signature raises: every offered one is valid, so
    a rejection is a failed dispatch.
  * `--aggregate-ab` builds its `CommitteeTable` on `--device`; the
    reference's substitution of the exact host scheme when its kernel is
    absent is not carried over.
  * Not ported, and refused with an error: `--telemetry-port` (it needs
    `utils/telemetry`, the scrape endpoint).
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import random
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import resolve_device
from .consensus.messages import QC, AggQC
from .crypto import aggsig, pysigner
from .crypto.batch_service import BatchVerificationService
from .crypto.primitives import Digest, PublicKey, Signature
from .crypto.torch_backend import TorchBackend
from .ingress import ArrivalCurve, IngressConfig, IngressPipeline, OpenLoopLoadGen
from .ops import bls
from .ops import ed25519 as ed
from .ops import ladder, timeline
from .ops.verifier import Ed25519TorchVerifier
from .parallel.mesh import ShardedEd25519TorchVerifier, default_mesh
from .utils import metrics, tracing
from .utils.serde import Writer

# What the port does not carry of the reference's flags: each flag's dest, the
# flag, the value refused (None: any value) and what it would need.
REFUSED = {
    "telemetry_port": ("--telemetry-port", None, "utils/telemetry"),
    "ingress_backend": ("--ingress-backend", "pure", "the reference's pure-Python verifier"),
    "sched_backend": ("--sched-backend", "pure", "the reference's pure-Python verifier"),
}
ROUTE_KEYS = ("host_batches", "host_sigs", "device_batches", "device_sigs")
COMMITTEE_SIZES = (4, 10, 16, 64, 100)
AB_ATTEMPTS = 3  # fixed, no early stop (`bench.py:885-896`)


# --- workloads: byte for byte the reference's triples ---------------------------


def signed_batch(n: int, msg_len: int = 32, seed: int = 1):
    """n (message, key, signature) triples signed by OpenSSL, keys and
    messages from `random.Random(seed)` (`__graft_entry__.py:16-32`)."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    rng = random.Random(seed)
    msgs, pks, sigs = [], [], []
    for _ in range(n):
        sk = Ed25519PrivateKey.from_private_bytes(rng.randbytes(32))
        m = rng.randbytes(msg_len)
        msgs.append(m)
        pks.append(sk.public_key().public_bytes_raw())
        sigs.append(sk.sign(m))
    return msgs, pks, sigs


def qc_batch(committee: int, total: int, seed: int = 7):
    """QC-shaped workload (`bench.py:146-172`): `total // q` QCs of q =
    2N/3 + 1 votes over one shared digest each, signed by OpenSSL. Returns
    (msgs, pks, sigs, q, n_qc)."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey

    q = 2 * committee // 3 + 1
    n_qc = max(1, total // q)
    rng = random.Random(seed)
    keys = [Ed25519PrivateKey.from_private_bytes(rng.randbytes(32)) for _ in range(committee)]
    pks = [k.public_key().public_bytes_raw() for k in keys]
    msgs, batch_pks, sigs = [], [], []
    for _ in range(n_qc):
        digest = rng.randbytes(32)
        for v in rng.sample(range(committee), q):
            msgs.append(digest)
            batch_pks.append(pks[v])
            sigs.append(keys[v].sign(digest))
    return msgs, batch_pks, sigs, q, n_qc


def pipeline_workload(n: int):
    """The pipeline A/B's workload (`bench.py:803-822`): 8 exact RFC 8032
    identities (`pysigner`, no wheel) tiled to n lanes over 32-byte
    messages, every lane valid."""
    pool = []
    for i in range(8):
        seed = bytes([i + 1]) * 32
        pk, _ = pysigner.keypair_from_seed(seed)
        m = (b"pipe-ab-%d" % i).ljust(32, b"\0")
        pool.append((m, pk, pysigner.sign(seed, m, public_key=pk)))
    msgs, pks, sigs = [], [], []
    for i in range(n):
        m, pk, s = pool[i % len(pool)]
        msgs.append(m)
        pks.append(pk)
        sigs.append(s)
    return msgs, pks, sigs


# --- host baselines ------------------------------------------------------------


def bench_cpu(msgs, pks, sigs, budget_s: float = 3.0) -> float:
    """OpenSSL's single-thread verify rate on the host (sigs/s)."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    keys = [Ed25519PublicKey.from_public_bytes(pk) for pk in pks]
    n, done = len(msgs), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < budget_s:
        i = done % n
        keys[i].verify(sigs[i], msgs[i])
        done += 1
    return done / (time.perf_counter() - t0)


def bench_cpu_multicore(msgs, pks, sigs, budget_s: float = 2.0) -> float:
    """OpenSSL on every host thread at once (it releases the interpreter
    lock), sigs/s."""
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PublicKey

    keys = [Ed25519PublicKey.from_public_bytes(pk) for pk in pks]
    n = len(msgs)
    nthreads = os.cpu_count() or 1

    def worker(tid: int) -> int:
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < budget_s:
            i = (tid + done) % n
            keys[i].verify(sigs[i], msgs[i])
            done += 1
        return done

    t0 = time.perf_counter()
    with ThreadPoolExecutor(nthreads) as ex:
        total = sum(ex.map(worker, range(nthreads)))
    return total / (time.perf_counter() - t0)


# --- device legs ---------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_device(msgs, pks, sigs, iters: int, kernel: str, device: torch.device) -> float:
    """Kernel-only rate on resident tensors (sigs/s): the f32-form
    arguments (`ed.prepare_batch`, `ed.kernel_args`) uploaded once, then
    `iters` runs of `ladder.verify_args` (K3, K1 or K7, K4), timed to one
    synchronisation after the last. The mask must be all True."""
    n = len(msgs)
    staged = ed.prepare_batch(msgs, pks, sigs, want_bits=kernel == "bits")
    args = [torch.from_numpy(a).to(device) for a in ed.kernel_args(staged, n, kernel)]
    if not bool(ladder.verify_args(*args, kernel=kernel).all()):
        raise RuntimeError("benchmark batch must fully verify")
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        ladder.verify_args(*args, kernel=kernel)
    _sync(device)
    return n * iters / (time.perf_counter() - t0)


def make_verifier(kernel: str, chunk: int, mesh: int | None, device: torch.device, **kw) -> Ed25519TorchVerifier:
    """The e2e and committee legs' verifier (`bench.py:109-124`): `mesh`
    None for one device, 0 for a mesh of every visible GPU, N for the first
    N (on the CPU: a virtual mesh of N shards, one when 0)."""
    if mesh is None:
        return Ed25519TorchVerifier(device=device, max_bucket=8192, kernel=kernel, chunk=chunk, **kw)
    return ShardedEd25519TorchVerifier(mesh=bench_mesh(mesh, device), max_bucket=8192, kernel=kernel, chunk=chunk,
                                       **kw)


def bench_mesh(mesh: int, device: torch.device):
    """The `--mesh N` mesh: the first N visible GPUs (every one when 0), or
    on the CPU a virtual mesh of N shards (one when 0)."""
    return default_mesh(mesh or None) if device.type == "cuda" else default_mesh(mesh or 1, device=device)


def bench_e2e(msgs, pks, sigs, kernel: str, chunk: int, iters: int, device: torch.device,
              mesh: int | None = None) -> float:
    """The verifier's rate (sigs/s): staging, the dispatch pipeline, the
    kernels and the readback of every chunk, on the host clock."""
    verifier = make_verifier(kernel, chunk, mesh, device)
    try:
        if not verifier.verify_batch_mask(msgs, pks, sigs).all():
            raise RuntimeError("benchmark batch must fully verify")
        t0 = time.perf_counter()
        for _ in range(iters):
            verifier.verify_batch_mask(msgs, pks, sigs)
        return len(msgs) * iters / (time.perf_counter() - t0)
    finally:
        verifier.close()


def bench_committee_cache(mode: str, kernel: str, chunk: int, committee: int, total: int, iters: int,
                          device: torch.device, mesh: int | None = None) -> float:
    """The `--committee-cache` leg (`bench.py:175-221`): `qc_batch` through
    the committee path (`on`: the keys registered once, lanes carry
    validator indices) or the generic kernels (`off`). Prints the
    `verifier.table_builds` and `verifier.decompressions` deltas of the
    timed loop on stderr (0 and 0 with `on`)."""
    msgs, pks, sigs, _q, _n_qc = qc_batch(committee, total)
    verifier = make_verifier(kernel, chunk, mesh, device)
    try:
        if mode == "on":
            table = verifier.set_committee(sorted(set(pks)))
            idx = [table.index[k] for k in pks]
            run = lambda: verifier.verify_batch_mask_committee(msgs, idx, sigs)
        else:
            run = lambda: verifier.verify_batch_mask(msgs, pks, sigs)
        if not run().all():
            raise RuntimeError("committee benchmark batch must fully verify")
        builds, decomp = metrics.counter("verifier.table_builds"), metrics.counter("verifier.decompressions")
        b0, d0 = builds.value, decomp.value
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        dt = time.perf_counter() - t0
    finally:
        verifier.close()
    print(f"# committee-cache={mode}: {iters} x {len(msgs)} sigs -> table_builds +{builds.value - b0}, "
          f"decompressions +{decomp.value - d0}", file=sys.stderr)
    return len(msgs) * iters / dt


def _route(stats: dict, host_route: str) -> str:
    if stats["host_sigs"] and stats["device_sigs"]:
        return "mixed"
    return host_route if stats["host_sigs"] else "card"


def bench_committee_scale(chunk: int, cpu_budget: float, total: int, iters: int, device: torch.device) -> list[dict]:
    """Votes/s at QC-shaped batches, committees of 4 to 100
    (`bench.py:224-246`), each QC one `TorchBackend.verify_batch_mask(...,
    committee=True)` call at the backend's default crossovers with the
    committee registered. Prints the table with the route each committee's
    QCs took, and returns its rows."""
    print("committee  quorum   QCs  votes    cpu_sigs/s  torch_e2e_sigs/s  speedup  route")
    rows = []
    for committee in COMMITTEE_SIZES:
        msgs, pks, sigs, q, n_qc = qc_batch(committee, total)
        keys, sgs = [PublicKey(k) for k in pks], [Signature(s) for s in sigs]
        backend = TorchBackend(device=device, max_bucket=8192, chunk=chunk)
        try:
            backend.register_committee(sorted(set(pks)))
            backend.verify_batch_mask(msgs[:q], keys[:q], sgs[:q], committee=True)  # first launch
            base = dict(backend.stats)
            masks = []
            t0 = time.perf_counter()
            for _ in range(iters):
                for lo in range(0, n_qc * q, q):
                    masks.append(backend.verify_batch_mask(msgs[lo:lo + q], keys[lo:lo + q], sgs[lo:lo + q],
                                                           committee=True))
            rate = n_qc * q * iters / (time.perf_counter() - t0)
            stats = {k: v - base[k] for k, v in backend.stats.items()}
        finally:
            backend.close()
        if not all(all(m) for m in masks):
            raise RuntimeError(f"committee of {committee}: a QC did not fully verify")
        cpu_rate = bench_cpu(msgs, pks, sigs, cpu_budget)
        row = dict(committee=committee, quorum=q, qcs=n_qc, votes=n_qc * q, cpu_sigs_per_s=round(cpu_rate, 1),
                   e2e_sigs_per_s=round(rate, 1), speedup=round(rate / cpu_rate, 3),
                   route=_route(stats, backend.host_route), crossover=backend.crossover,
                   committee_crossover=backend.committee_crossover)
        rows.append(row)
        print(f"{committee:>9}  {q:>6}  {n_qc:>4}  {n_qc * q:>5}  {cpu_rate:>10,.0f}  {rate:>16,.0f}  "
              f"{rate / cpu_rate:>6.1f}x  {row['route']}")
    target = next(r["speedup"] for r in rows if r["committee"] == 64)
    print(f"# north-star check: committee-64 e2e {target:.1f}x (target >= 10x) -> "
          f"{'MET' if target >= 10 else 'NOT MET'}")
    return rows


def _pipeline_leg(v, msgs, pks, sigs, iters: int) -> dict:
    """One timed A/B leg over a warmed verifier (`bench.py:825-850`): the
    device timeline reset, `iters` batches, the leg's occupancy, headroom,
    rate and pipeline stalls."""
    stalls0 = v.pipeline.stats["stalls"]
    timeline.reset()
    t0 = time.perf_counter()
    for _ in range(iters):
        mask = v.verify_batch_mask(msgs, pks, sigs)
    dt = time.perf_counter() - t0
    summary = timeline.summary()
    return {
        "mask": np.asarray(mask),
        "occupancy": summary["occupancy"],
        "overlap_headroom": summary["overlap_headroom"],
        "chunks": summary["chunks"],
        "verified_per_sec": round(len(msgs) * iters / max(dt, 1e-9), 1),
        "stalls": v.pipeline.stats["stalls"] - stalls0,
    }


def bench_pipeline_ab(args, device: torch.device) -> dict:
    """`--pipeline-ab` (`bench.py:853-964`): depth 1 against depth 2 on
    `pipeline_workload` (at least 6 chunks a batch), `AB_ATTEMPTS` attempts
    a leg in turns with no early stop, each leg's best occupancy kept. The
    masks must be bit-identical and all True. Returns the reference's
    payload."""
    depth = 2
    n = max(args.batch, 6 * args.chunk)
    iters = max(1, args.e2e_iters)
    msgs, pks, sigs = pipeline_workload(n)
    kw = dict(max_bucket=8192, kernel=args.kernel, chunk=args.chunk)
    vs = Ed25519TorchVerifier(device=device, pipeline_depth=1, **kw)
    vp = Ed25519TorchVerifier(device=device, pipeline_depth=depth, **kw)
    serial = piped = None
    try:
        vs.verify_batch_mask(msgs, pks, sigs)
        vp.verify_batch_mask(msgs, pks, sigs)
        for _ in range(AB_ATTEMPTS):
            s = _pipeline_leg(vs, msgs, pks, sigs, iters)
            p = _pipeline_leg(vp, msgs, pks, sigs, iters)
            if serial is None or s["occupancy"] > serial["occupancy"]:
                serial = s
            if piped is None or p["occupancy"] > piped["occupancy"]:
                piped = p
    finally:
        vs.close()
        vp.close()
    if not serial["mask"].all():
        raise RuntimeError("pipeline A/B batch must fully verify")
    identical = bool(np.array_equal(serial["mask"], piped["mask"]))
    if not identical:
        raise RuntimeError("pipeline A/B legs gave different masks")
    vps_s, vps_p = serial["verified_per_sec"], piped["verified_per_sec"]
    print(f"# pipeline A/B: occupancy {serial['occupancy']:.4f} (serial) -> {piped['occupancy']:.4f} "
          f"(depth={depth}), {vps_s:,.0f} -> {vps_p:,.0f} sigs/s, masks identical: {identical}", file=sys.stderr)
    return {
        "metric": "pipeline_occupancy",
        "value": piped["occupancy"],
        "unit": "fraction",
        "pipeline_depth": depth,
        "occupancy_serial": serial["occupancy"],
        "occupancy_pipelined": piped["occupancy"],
        "overlap_headroom_serial": serial["overlap_headroom"],
        "overlap_headroom_pipelined": piped["overlap_headroom"],
        "verified_per_sec_serial": vps_s,
        "verified_per_sec_pipelined": vps_p,
        "pipeline_speedup": round(vps_p / vps_s, 4) if vps_s else None,
        "masks_identical": identical,
        "chunks_per_leg": piped["chunks"],
        "stalls_pipelined": piped["stalls"],
        "ab_attempts": AB_ATTEMPTS,
    }


# --- the client plane, the scheduler A/B and the AggQC A/B ------------------------


def _routes(backend: TorchBackend) -> dict:
    """The backend's host and card batches and lanes, and its host route."""
    return {**{k: backend.stats[k] for k in ROUTE_KEYS}, "host_route": backend.host_route}


def bench_ingress(args, device: torch.device) -> dict:
    """`--ingress` (`bench.py:416-499`): the open-loop flash curve of
    signed client transactions (`random.Random(7)`) through an
    `IngressPipeline` and a `BatchVerificationService` over `TorchBackend`
    on `device`, the committed transactions counted off the sink. Prints
    the signer and its rate on a line of its own. Raises if the pipeline
    rejected a signature. Returns the reference's payload."""
    duration = args.ingress_duration
    curve = ArrivalCurve(kind="flash", rate=args.ingress_rate, peak=args.ingress_rate * 5.0,
                         t_start=duration / 3.0, t_end=2.0 * duration / 3.0)
    backend = TorchBackend(device=device)
    rejected0 = metrics.counter("ingress.rejected_sigs").value

    async def drive():
        service = BatchVerificationService(backend)
        sink: asyncio.Queue = asyncio.Queue(1_000_000)
        committed = {"n": 0}

        async def drain() -> None:
            while True:
                await sink.get()
                committed["n"] += 1

        drainer = asyncio.ensure_future(drain())
        pipeline = IngressPipeline(service, sink, IngressConfig(verify_batch=args.ingress_batch))
        gen = OpenLoopLoadGen(pipeline.submit, curve=curve, duration=duration, clients=args.ingress_clients,
                              tx_bytes=64, rng=random.Random(7))
        summary = await gen.run()
        drainer.cancel()
        # Forwarded = counted off the sink + still in it; read with the
        # pipeline's counts, with no await between.
        return summary, committed["n"] + sink.qsize(), gen, dict(pipeline.stats)

    try:
        summary, committed, gen, stats = asyncio.run(drive())
    finally:
        backend.close()
    rejected = metrics.counter("ingress.rejected_sigs").value - rejected0
    sign_rate = gen.signed / gen.sign_s if gen.sign_s > 0 else None
    print(f"# ingress signer: {gen.signer}, {gen.signed} signatures in {gen.sign_s:.3f} s"
          f"{f' ({sign_rate:,.0f} sigs/s)' if sign_rate else ''}", flush=True)
    if rejected:
        raise RuntimeError(f"ingress: {rejected} valid signatures rejected (a verification dispatch failed)")
    return {
        "metric": "ingress_committed_tx_per_sec",
        "value": round(committed / duration, 1),
        "unit": "tx/s",
        "offered_tps": round(summary["offered"] / duration, 1),
        "committed_tps": round(committed / duration, 1),
        "committed": committed,
        "offered": summary["offered"],
        "accepted": summary["accepted"],
        "shed": summary["shed"],
        "retry_hints": summary["retry_hints"],
        "shed_rate": round(summary["shed_rate"], 4),
        "latency_ms": summary["latency_ms"],
        "curve": summary["curve"],
        "clients": args.ingress_clients,
        "signer": gen.signer,
        "signer_sigs_per_s": round(sign_rate, 1) if sign_rate else None,
        "pipeline": stats,
        "routes": _routes(backend),
    }


async def _sched_leg(backend, use_scheduler: bool, duration: float, bulk_size: int, bulk_feeders: int,
                     critical_size: int, critical_interval: float) -> dict:
    """One A/B leg (`bench.py:509-582`): closed-loop bulk feeders (mempool
    source) flood the service while a paced feeder (consensus source)
    submits quorum-sized groups, every group `dedup=False`. Returns each
    lane's queueing delay, verified/s and the flush loop that ran."""
    svc = BatchVerificationService(backend, use_scheduler=use_scheduler)
    # Four exact RFC 8032 triples tiled to each group's size; dedup=False
    # sends every repeat to the backend.
    pool = []
    for i in range(4):
        seed = bytes([i]) * 32
        pk, _ = pysigner.keypair_from_seed(seed)
        msg = (b"sched-ab-%d" % i).ljust(32, b"\0")
        pool.append((msg, PublicKey(pk), Signature(pysigner.sign(seed, msg, public_key=pk))))

    def batch(n: int):
        msgs = [pool[i % len(pool)][0] for i in range(n)]
        pairs = [(pool[i % len(pool)][1], pool[i % len(pool)][2]) for i in range(n)]
        return msgs, pairs

    loop = asyncio.get_running_loop()
    end = loop.time() + duration
    done = {"bulk_groups": 0, "critical_groups": 0, "sigs": 0}
    masks_ok = [True]

    async def bulk_feeder():
        msgs, pairs = batch(bulk_size)
        while loop.time() < end:
            mask = await svc.verify_group(msgs, pairs, source="mempool", dedup=False)
            done["bulk_groups"] += 1
            done["sigs"] += len(mask)
            masks_ok[0] &= all(mask)

    async def critical_feeder():
        msgs, pairs = batch(critical_size)
        while loop.time() < end:
            mask = await svc.verify_group(msgs, pairs, source="consensus", dedup=False)
            done["critical_groups"] += 1
            done["sigs"] += len(mask)
            masks_ok[0] &= all(mask)
            await asyncio.sleep(critical_interval)

    t0 = loop.time()
    await asyncio.gather(critical_feeder(), *[bulk_feeder() for _ in range(bulk_feeders)])
    elapsed = loop.time() - t0
    lanes = svc.lane_stats.summary()
    return {
        "mode": "scheduler" if use_scheduler else "legacy",
        "critical_queue_ms": lanes.get("consensus", {}),
        "bulk_queue_ms": lanes.get("mempool", {}),
        "verified_per_sec": round(done["sigs"] / max(elapsed, 1e-9), 1),
        "bulk_groups": done["bulk_groups"],
        "critical_groups": done["critical_groups"],
        "flushes": svc.stats["flushes"],
        "flush_loop": svc._task.get_coro().__qualname__,
        "masks_all_true": masks_ok[0],
    }


def bench_scheduler_ab(args, device: torch.device) -> dict:
    """`--scheduler-ab` (`bench.py:585-655`): the legacy leg, then the
    scheduler leg, on one `TorchBackend`; downscaled only under `--device
    cpu`. Raises unless every mask was all True. Returns the reference's
    payload."""
    bulk, critical = args.sched_bulk, args.sched_critical
    feeders, interval = args.sched_feeders, args.sched_interval
    duration = args.sched_duration
    if device.type == "cpu":
        # The plain versions and the host route: shrink the groups so each
        # leg still turns over dozens of flushes in seconds.
        bulk, critical, feeders = min(bulk, 8), min(critical, 3), min(feeders, 3)
    backend = TorchBackend(device=device)

    async def drive():
        legacy = await _sched_leg(backend, False, duration, bulk, feeders, critical, interval)
        sched = await _sched_leg(backend, True, duration, bulk, feeders, critical, interval)
        return legacy, sched

    try:
        legacy, sched = asyncio.run(drive())
    finally:
        backend.close()
    if not (legacy["masks_all_true"] and sched["masks_all_true"]):
        raise RuntimeError("scheduler A/B: a mask of the valid pool was not all True")
    p99_sched = sched["critical_queue_ms"].get("p99_ms", 0.0)
    p99_legacy = legacy["critical_queue_ms"].get("p99_ms", 0.0)
    vps_sched, vps_legacy = sched["verified_per_sec"], legacy["verified_per_sec"]
    return {
        "metric": "critical_lane_p99_queue_ms",
        "value": p99_sched,
        "unit": "ms",
        "legacy": legacy,
        "scheduler": sched,
        # > 1: the scheduler cut the consensus lane's p99.
        "p99_improvement": round(p99_legacy / p99_sched, 3) if p99_sched > 0 else None,
        "verified_ratio": round(vps_sched / vps_legacy, 4) if vps_legacy > 0 else None,
        "workload": {"duration_s": duration, "bulk_size": bulk, "bulk_feeders": feeders,
                     "critical_size": critical, "critical_interval_s": interval},
        "routes": _routes(backend),
    }


def _encoded_len(cert) -> int:
    w = Writer()
    cert.encode(w)
    return len(w.bytes())


def bench_aggregate_ab(args, device: torch.device) -> dict:
    """`--aggregate-ab` (`bench.py:658-800`): per committee size n, a real
    n-vote `QC` (exact ed25519 votes) and an n-member `AggQC` (the
    signature under the summed secret scalar, which equals the aggregate
    of n partials over one message), their encoded bytes, and the verify
    wall of each form: n exact checks on the host, against one
    `CommitteeTable(keys, device).verify_aggregate` (K6's affine entry,
    then the pairing on the host). Returns the reference's payload."""
    scheme = aggsig.ExactBlsScheme()
    rows = []
    for n in [int(x) for x in args.agg_sizes.split(",") if x.strip()]:
        digest = Digest(hashlib.sha512(b"agg-ab:%d" % n).digest()[:32])
        round_ = 7
        seeds = [hashlib.sha512(b"ed:%d:%d" % (n, i)).digest()[:32] for i in range(n)]
        ed_pks = [pysigner.keypair_from_seed(sd)[0] for sd in seeds]
        msg = QC(digest, round_, ()).signed_digest().data
        votes = tuple((PublicKey(pk), Signature(pysigner.sign(sd, msg, public_key=pk)))
                      for pk, sd in zip(ed_pks, seeds))
        qc = QC(digest, round_, votes)
        entry_bytes = _encoded_len(qc)
        t0 = time.perf_counter()
        entry_ok = all(pysigner.verify(pk.data, msg, sig.data) for pk, sig in qc.votes)
        entry_wall = time.perf_counter() - t0

        pairs = [scheme.keypair_from_seed(sd) for sd in seeds]
        sk_sum = sum(sk for _pk, sk in pairs) % aggsig.R_ORDER
        bitmap = (1 << n) - 1
        agg_sig = scheme.sign(sk_sum, msg)
        agg_bytes = _encoded_len(AggQC(digest, round_, bitmap, agg_sig))
        t0 = time.perf_counter()
        table = bls.CommitteeTable([pk for pk, _sk in pairs], device=device)
        table_build_s = round(time.perf_counter() - t0, 4)
        t0 = time.perf_counter()
        agg_ok = table.verify_aggregate(bitmap, msg, agg_sig)
        agg_wall = time.perf_counter() - t0
        rows.append({
            "n": n,
            "entry_list": {"cert_bytes": entry_bytes, "verify_ok": bool(entry_ok),
                           "verify_wall_s": round(entry_wall, 4),
                           "certs_per_s": round(1.0 / entry_wall, 3) if entry_wall > 0 else None},
            "aggregate": {"cert_bytes": agg_bytes, "verify_ok": bool(agg_ok), "verify_wall_s": round(agg_wall, 4),
                          "certs_per_s": round(1.0 / agg_wall, 3) if agg_wall > 0 else None,
                          "table_build_s": table_build_s},
            "bytes_ratio": round(entry_bytes / agg_bytes, 3),
        })
    agg_sizes_seen = [r["aggregate"]["cert_bytes"] for r in rows]
    return {
        "metric": "aggregate_cert_bytes",
        "value": float(agg_sizes_seen[-1]),
        "unit": "bytes",
        "sizes": rows,
        # The aggregate's byte spread over the sizes (1.0 = flat).
        "agg_bytes_spread": round(max(agg_sizes_seen) / min(agg_sizes_seen), 4),
        "all_verified": all(r["entry_list"]["verify_ok"] and r["aggregate"]["verify_ok"] for r in rows),
    }


# --- the JSON line ----------------------------------------------------------------


def attach_timeline(payload: dict) -> None:
    """The device timeline's gap attribution (`bench.py:269-292`):
    occupancy, overlap headroom and the summary's counts and spans."""
    s = timeline.summary()
    payload["occupancy"] = s["occupancy"]
    payload["overlap_headroom"] = s["overlap_headroom"]
    payload["device_timeline"] = {k: s[k] for k in ("batches", "chunks", "span_s", "phase_s", "idle")}


def card(device: torch.device) -> dict:
    """`backend`, `device` and `power_limit_w` of the JSON line: the card's
    name and power limit (`nvidia-smi --query-gpu=name,power.limit`), or
    `cpu` and None."""
    if device.type != "cuda":
        return {"backend": "cpu", "device": "cpu", "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits", "-i", str(device.index)],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"backend": "cuda", "device": torch.cuda.get_device_name(device),
            "power_limit_w": float(out.rsplit(",", 1)[1])}


def write_metrics(path: str | None) -> None:
    """`--metrics-out`: the registry's dump (`bench.py:249-265`)."""
    if path:
        metrics.write_json(path)


def write_trace(path: str | None) -> None:
    """`--trace-out`: the flight recorder's dump (`bench.py:275-286`)."""
    if path:
        tracing.write_json(path)


def emit(payload: dict, metrics_out: str | None, trace_out: str | None = None) -> dict:
    write_metrics(metrics_out)
    write_trace(trace_out)
    print(json.dumps(payload), flush=True)
    return payload


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the verifiers run (cpu: the kernels' plain versions); no card raises")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--device-batch", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--e2e-iters", type=int, default=3)
    ap.add_argument("--cpu-budget", type=float, default=3.0)
    ap.add_argument("--kernel", default="w4", choices=list(ladder.KERNEL_FLAVOURS))
    ap.add_argument("--metrics-out", default=None, help="write the metrics registry's dump here")
    ap.add_argument("--committee-cache", choices=["on", "off"], default=None,
                    help="add the QC-shaped committee leg: 'on' through the registered tables, "
                    "'off' through the generic kernels (committee_value on the JSON line)")
    ap.add_argument("--committee-scale", action="store_true",
                    help="votes/s and route per committee size through TorchBackend, QC by QC")
    ap.add_argument("--pipeline-ab", action="store_true",
                    help="depth 1 against depth 2 of the dispatch pipeline on one workload")
    ap.add_argument("--mesh", type=int, nargs="?", const=0, default=None, metavar="N",
                    help="shard the e2e and committee legs over the first N GPUs (bare: every GPU)")
    ap.add_argument("--trace-out", default=None, help="write the flight recorder's dump here")
    ap.add_argument("--ingress", action="store_true",
                    help="open-loop flash-crowd signed client traffic through an IngressPipeline: "
                    "offered against committed tx/s, shed, client latency")
    ap.add_argument("--ingress-backend", choices=["auto", "pure"], default="auto",
                    help="auto: TorchBackend on --device ('pure' is the reference's and refused)")
    ap.add_argument("--ingress-rate", type=float, default=100.0)
    ap.add_argument("--ingress-duration", type=float, default=10.0)
    ap.add_argument("--ingress-clients", type=int, default=8)
    ap.add_argument("--ingress-batch", type=int, default=64)
    ap.add_argument("--scheduler-ab", action="store_true",
                    help="the legacy flush loop against the device scheduler on bulk + consensus groups")
    ap.add_argument("--sched-backend", choices=["auto", "pure"], default="auto",
                    help="auto: TorchBackend on --device ('pure' is the reference's and refused)")
    ap.add_argument("--sched-duration", type=float, default=6.0)
    ap.add_argument("--sched-bulk", type=int, default=512)
    ap.add_argument("--sched-critical", type=int, default=44)
    ap.add_argument("--sched-feeders", type=int, default=3)
    ap.add_argument("--sched-interval", type=float, default=0.02)
    ap.add_argument("--aggregate-ab", action="store_true",
                    help="entry-list QC against AggQC per committee size: wire bytes and verify wall")
    ap.add_argument("--agg-sizes", default="4,16,64", help="comma-separated committee sizes for --aggregate-ab")
    for dest, (flag, value, needs) in REFUSED.items():
        if value is None:
            ap.add_argument(flag, dest=dest, default=None, help=f"not ported (needs {needs})")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the legs `argv` asks for, print the JSON line and return it."""
    ap = parser()
    args = ap.parse_args(argv)
    for dest, (flag, value, needs) in REFUSED.items():
        given = getattr(args, dest)
        if given is not None and value in (None, given):
            ap.error(f"{flag if value is None else f'{flag} {value}'} is not ported: it needs {needs}")
    device = resolve_device(args.device)
    info = card(device)

    for wanted, leg in ((args.ingress, bench_ingress), (args.scheduler_ab, bench_scheduler_ab),
                        (args.aggregate_ab, bench_aggregate_ab)):
        if wanted:
            return emit({**leg(args, device), **info}, args.metrics_out, args.trace_out)

    if args.pipeline_ab:
        payload = bench_pipeline_ab(args, device)
        payload.update(info)
        attach_timeline(payload)  # the depth 2 leg ran last
        return emit(payload, args.metrics_out, args.trace_out)

    if args.committee_scale:
        rows = bench_committee_scale(args.chunk, args.cpu_budget, args.batch, args.e2e_iters, device)
        c64 = next(r for r in rows if r["committee"] == 64)
        payload = {"metric": "votes_verified_per_sec", "value": c64["e2e_sigs_per_s"], "unit": "sigs/s",
                   "vs_baseline": c64["speedup"], **info, "committee_scale": rows}
        attach_timeline(payload)
        return emit(payload, args.metrics_out, args.trace_out)

    msgs, pks, sigs = signed_batch(args.batch)
    dn = min(args.device_batch, args.batch)
    cpu_rate = bench_cpu(msgs[:dn], pks[:dn], sigs[:dn], args.cpu_budget)
    cpu_multi = bench_cpu_multicore(msgs[:dn], pks[:dn], sigs[:dn])
    print(f"# cpu ed25519 baseline: {cpu_rate:,.0f} sigs/s single-thread, "
          f"{cpu_multi:,.0f} sigs/s all {os.cpu_count()} threads", file=sys.stderr)
    device_rate = bench_device(msgs[:dn], pks[:dn], sigs[:dn], args.iters, args.kernel, device)
    e2e_rate = bench_e2e(msgs, pks, sigs, args.kernel, args.chunk, args.e2e_iters, device, mesh=args.mesh)
    committee_rate = None
    if args.committee_cache is not None:
        # The committee path has one kernel family; 'off' measures the
        # generic kernels of --kernel, as the reference does.
        committee_rate = bench_committee_cache(
            args.committee_cache, "w4" if args.committee_cache == "on" else args.kernel,
            args.chunk, 64, args.batch, args.e2e_iters, device, mesh=args.mesh)
    mesh_devices = None if args.mesh is None else bench_mesh(args.mesh, device).size
    print(f"# {info['device']}: {device_rate:,.0f} sigs/s device (batch={dn}), {e2e_rate:,.0f} sigs/s "
          f"end-to-end (batch={args.batch}, pipelined chunk={args.chunk}"
          f"{f', mesh={mesh_devices}dev' if mesh_devices else ''})", file=sys.stderr)
    out = {
        "metric": "votes_verified_per_sec",
        "value": round(device_rate, 1),
        "unit": "sigs/s",
        "vs_baseline": round(device_rate / cpu_rate, 3),
        "e2e_value": round(e2e_rate, 1),
        "e2e_vs_baseline": round(e2e_rate / cpu_rate, 3),
        "cpu_multicore": round(cpu_multi, 1),
        **info,
    }
    if mesh_devices is not None:
        out["mesh_devices"] = mesh_devices
    if committee_rate is not None:
        out["committee_cache"] = args.committee_cache
        out["committee_value"] = round(committee_rate, 1)
    attach_timeline(out)
    return emit(out, args.metrics_out, args.trace_out)


if __name__ == "__main__":
    main()
