"""The port's benchmark: votes verified per second on the card against
OpenSSL on the host.

    python -m hotstuff_tpu_torch.bench [--committee-cache on|off] [--kernel w4|bits|pallas]
        [--mesh [N]] [--pipeline-ab] [--committee-scale] [--metrics-out PATH] [--device cuda|cpu]

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
routing counters. `--pipeline-ab` prints the reference's A/B payload
instead (depth 1 against depth 2 on `pipeline_workload`, three attempts
a leg, no early stop, masks bit-identical).

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
  * Not ported, and refused with an error: `--aggregate-ab` (it needs the
    QC and AggQC wire encoding of `consensus.messages`), `--scheduler-ab`
    (the legacy flush loop), `--ingress`, `--trace-out` and
    `--telemetry-port` (the ingress package, `utils/tracing`,
    `utils/telemetry`).
"""

from __future__ import annotations

import argparse
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
from .crypto import pysigner
from .crypto.primitives import PublicKey, Signature
from .crypto.torch_backend import TorchBackend
from .ops import ed25519 as ed
from .ops import ladder, timeline
from .ops.verifier import Ed25519TorchVerifier
from .parallel.mesh import ShardedEd25519TorchVerifier, default_mesh
from .utils import metrics

# Flags of the reference's legs that the port does not carry, and what each needs.
REFUSED = {
    "aggregate_ab": ("--aggregate-ab", "the QC and AggQC wire encoding of consensus.messages"),
    "scheduler_ab": ("--scheduler-ab", "the reference's legacy flush loop"),
    "ingress": ("--ingress", "the ingress package"),
    "trace_out": ("--trace-out", "utils/tracing"),
    "telemetry_port": ("--telemetry-port", "utils/telemetry"),
}
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


def emit(payload: dict, metrics_out: str | None) -> dict:
    write_metrics(metrics_out)
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
    for dest, (flag, needs) in REFUSED.items():
        takes_value = dest in ("trace_out", "telemetry_port")
        ap.add_argument(flag, dest=dest, default=None, action=None if takes_value else "store_true",
                        help=f"not ported (needs {needs})")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the legs `argv` asks for, print the JSON line and return it."""
    ap = parser()
    args = ap.parse_args(argv)
    for dest, (flag, needs) in REFUSED.items():
        if getattr(args, dest):
            ap.error(f"{flag} is not ported: it needs {needs}")
    device = resolve_device(args.device)
    info = card(device)

    if args.pipeline_ab:
        payload = bench_pipeline_ab(args, device)
        payload.update(info)
        attach_timeline(payload)  # the depth 2 leg ran last
        return emit(payload, args.metrics_out)

    if args.committee_scale:
        rows = bench_committee_scale(args.chunk, args.cpu_budget, args.batch, args.e2e_iters, device)
        c64 = next(r for r in rows if r["committee"] == 64)
        payload = {"metric": "votes_verified_per_sec", "value": c64["e2e_sigs_per_s"], "unit": "sigs/s",
                   "vs_baseline": c64["speedup"], **info, "committee_scale": rows}
        attach_timeline(payload)
        return emit(payload, args.metrics_out)

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
    return emit(out, args.metrics_out)


if __name__ == "__main__":
    main()
