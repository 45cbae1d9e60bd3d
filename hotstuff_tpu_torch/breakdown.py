"""Where a verification batch spends its time on the card.

    python -m hotstuff_tpu_torch.breakdown [--batch 16384] [--chunk 4096] [--iters 5] [--committee]

Times `TorchBackend`'s verifier end to end on one batch of seeded random
wire bytes (the cost does not depend on validity: no step has
data-dependent control flow), then each layer of one chunk in the order
the verifier runs them: host staging, upload, the wire unpack, kernels K2,
K3, K1, K4, and the mask readback. With `--committee` the batch is a
committee batch (64 validators, `bench.py --committee-cache`'s size, random
validator indices) through `verify_batch_mask_committee`, and the layers
are staging, upload (wire rows and indices), unpack, K2g, K5, K4 and
readback. A kernel's time is its device time with launches queued behind
a spin kernel (`queued_ms`); upload and unpack are CUDA events around
calls as the host issues them (`events_ms`), staging and readback host
clock. Finally `torch.profiler` over one batch gives the device's busy
share (device time / wall time of the batch). Prints one JSON line. Needs a
CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .ops import committee as cm
from .ops import ed25519 as ed
from .ops import ladder, sha512
from .ops.verifier import Ed25519TorchVerifier, pad


def events_ms(fn, reps: int = 10) -> float:
    """Mean device ms per call of `fn` over `reps` calls (CUDA events on the
    current stream), after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call of `fn` with the host's launch time taken
    out: a spin kernel (`torch.cuda._sleep`, about 5 ms) holds the stream
    while the host queues the `reps` calls, so the events see the calls run
    back to back. `events_ms` reads the host's launch interval instead
    whenever a call is shorter than it."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--committee", action="store_true",
                    help="a committee batch over 64 validators (K2g, K5, K4)")
    args = ap.parse_args()
    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    wire = rng.integers(0, 256, (args.batch, 128), np.uint8)
    msgs = [bytes(r[96:]) for r in wire]
    keys = [bytes(r[:32]) for r in wire]
    sigs = [bytes(r[32:96]) for r in wire]
    v = Ed25519TorchVerifier(device=dev, max_bucket=max(args.chunk, 8192), chunk=args.chunk)
    if args.committee:
        table = v.set_committee(keys[:64])
        indices = rng.integers(0, 64, args.batch).tolist()
        run = lambda: v.verify_batch_mask_committee(msgs, indices, sigs)
    else:
        run = lambda: v.verify_batch_mask(msgs, keys, sigs)

    run()  # builds and binds the kernels
    e2e = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        e2e.append((time.perf_counter() - t0) * 1e3)

    n = args.chunk
    if args.committee:
        layers = _committee_layers(v, table, msgs, indices, sigs, n)
    else:
        layers = _generic_layers(v, msgs, keys, sigs, n)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us = 0.0
    by_kernel = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t:
            device_us += t
            by_kernel[evt.key] = t
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": "committee" if args.committee else "generic",
        "batch": args.batch, "chunk": n, "chunks": -(-args.batch // n),
        "e2e_ms": e2e, "e2e_ms_median": statistics.median(e2e),
        "sigs_per_s": args.batch / statistics.median(e2e) * 1e3,
        "chunk_layers": layers,
        "profiled_wall_ms": wall_us / 1e3,
        "device_busy_share": (device_us / wall_us) if device_us else "not measured",
        "device_ms_by_op": {k: t / 1e3 for k, t in top},
    }))
    return 0


def _generic_layers(v, msgs, keys, sigs, n) -> dict:
    dev = v.device
    staged = {}

    def stage():
        st = ed.prepare_batch_packed_dh(msgs[:n], keys[:n], sigs[:n])
        staged["packed"] = pad(st["packed"], v._bucket(n))

    stage_ms = _host_ms(stage)
    host = torch.from_numpy(staged["packed"])
    upload_ms = events_ms(lambda: host.to(dev))
    packed = host.to(dev)
    a, r, s, m = ed.split_packed128(packed)
    unpack_ms = events_ms(lambda: sha512.nibble_rows(s))
    sd = sha512.nibble_rows(s)
    hd = sha512.h_digits(r, a, m)
    table, valid = ed.decompress_table(a)
    point = ladder.ladder(sd, hd, table)
    mask = ed.compress_eq(point, r, valid)
    return {
        "stage_ms": stage_ms,
        "upload_ms": upload_ms,
        "unpack_ms": unpack_ms,
        "h_digits_ms": queued_ms(lambda: sha512.h_digits(r, a, m)),
        "decompress_table_ms": queued_ms(lambda: ed.decompress_table(a)),
        "ladder_ms": queued_ms(lambda: ladder.ladder(sd, hd, table)),
        "compress_eq_ms": queued_ms(lambda: ed.compress_eq(point, r, valid)),
        "readback_ms": _host_ms(lambda: mask.cpu()),
    }


def _committee_layers(v, table, msgs, indices, sigs, n) -> dict:
    dev = v.device
    staged = {}

    def stage():
        st = ed.prepare_batch_committee_dh(msgs[:n], indices[:n], sigs[:n])
        staged["packed"] = pad(st["packed"], v._bucket(n))
        staged["idx"] = pad(st["idx"], v._bucket(n))

    stage_ms = _host_ms(stage)
    host_p, host_i = torch.from_numpy(staged["packed"]), torch.from_numpy(staged["idx"])
    upload_ms = events_ms(lambda: (host_p.to(dev), host_i.to(dev)))
    packed, idx = host_p.to(dev), host_i.to(dev)
    r, s, m = cm.split_packed96(packed)
    unpack_ms = events_ms(lambda: sha512.nibble_rows(s))
    sd = sha512.nibble_rows(s)
    hd = sha512.h_digits_gather(r, table.keys_u8, idx, m)
    point, lane_valid = cm.committee_ladder(sd, hd, table, idx)
    mask = ed.compress_eq(point, r, lane_valid)
    return {
        "stage_ms": stage_ms,
        "upload_ms": upload_ms,
        "unpack_ms": unpack_ms,
        "h_digits_idx_ms": queued_ms(lambda: sha512.h_digits_gather(r, table.keys_u8, idx, m)),
        "committee_ladder_ms": queued_ms(lambda: cm.committee_ladder(sd, hd, table, idx)),
        "compress_eq_ms": queued_ms(lambda: ed.compress_eq(point, r, lane_valid)),
        "readback_ms": _host_ms(lambda: mask.cpu()),
    }


if __name__ == "__main__":
    sys.exit(main())
