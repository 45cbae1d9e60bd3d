"""Where a verification batch spends its time on the card.

    python -m hotstuff_tpu_torch.breakdown [--batch 16384] [--chunk 4096] [--iters 5] [--committee]
                                           [--depth N] [--staging native|numpy] [--trace PATH]

Times `TorchBackend`'s verifier end to end on one batch of seeded random
wire bytes (the cost does not depend on validity: no step has
data-dependent control flow) through its dispatch pipeline at `--depth`
(default: `HOTSTUFF_PIPELINE_DEPTH`, else 2) with the verifier's host
staging `--staging` (default native), with the device timeline's
occupancy and overlap headroom over those batches (`ops/timeline.py`).
Then each layer of one chunk in the order the verifier runs them: host
staging into a pooled (page-locked) shard-major buffer, by the verifier's
own `stage_wire`, upload, the wire unpack,
kernels K2, K3, K1, K4, and the mask readback. With `--committee` the batch
is a committee batch (64 validators, `bench.py --committee-cache`'s size,
random validator indices) through `verify_batch_mask_committee`, and the
layers are staging, upload (wire rows and indices), unpack, K2g, K5, K4 and
readback. A kernel's time is its device time with launches queued behind a
spin kernel (`queued_ms`); upload and unpack are CUDA events around calls
as the host issues them (`events_ms`), staging and readback host clock.
Finally `torch.profiler` over one batch gives the device's busy share: the
union of its kernel and copy intervals in the profiler's trace (written to
`--trace`) over the batch's wall time, and the streams they ran on. Prints
one JSON line. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import resolve_device
from .ops import committee as cm
from .ops import ed25519 as ed
from .ops import ladder, sha512, timeline
from .ops.verifier import STAGINGS, Ed25519TorchVerifier, pad_shards

# Device-side events of a torch.profiler Chrome trace.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_DIR = Path(__file__).resolve().parents[1] / ".chip_smoke"


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
    ap.add_argument("--depth", type=int, default=None,
                    help="dispatch pipeline depth (default HOTSTUFF_PIPELINE_DEPTH, else 2; 1 = inline)")
    ap.add_argument("--staging", choices=STAGINGS, default="native",
                    help="the verifier's host staging (the native plane, or the plain numpy staging)")
    ap.add_argument("--trace", default=str(TRACE_DIR / "breakdown_trace.json"),
                    help="where the profiled batch's Chrome trace is written")
    args = ap.parse_args()
    dev = resolve_device("cuda")
    rng = np.random.default_rng(args.seed)
    wire = rng.integers(0, 256, (args.batch, 128), np.uint8)
    msgs = [bytes(r[96:]) for r in wire]
    keys = [bytes(r[:32]) for r in wire]
    sigs = [bytes(r[32:96]) for r in wire]
    v = Ed25519TorchVerifier(device=dev, max_bucket=max(args.chunk, 8192), chunk=args.chunk,
                             pipeline_depth=args.depth, staging=args.staging)
    if args.committee:
        table = v.set_committee(keys[:64])
        indices = rng.integers(0, 64, args.batch).tolist()
        run = lambda: v.verify_batch_mask_committee(msgs, indices, sigs)
    else:
        run = lambda: v.verify_batch_mask(msgs, keys, sigs)

    run()  # builds and binds the kernels
    timeline.reset()
    stalls0 = v.pipeline.stats["stalls"]
    e2e = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        run()
        e2e.append((time.perf_counter() - t0) * 1e3)
    tl = timeline.summary()

    n = args.chunk
    if args.committee:
        layers = _committee_layers(v, table, msgs, indices, sigs, n)
    else:
        layers = _generic_layers(v, msgs, keys, sigs, n)

    trace = device_trace(run, Path(args.trace))
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "path": "committee" if args.committee else "generic",
        "batch": args.batch, "chunk": n, "chunks": -(-args.batch // n),
        "pipeline_depth": v.pipeline.depth, "staging": v.staging,
        "e2e_ms": e2e, "e2e_ms_median": statistics.median(e2e),
        "sigs_per_s": args.batch / statistics.median(e2e) * 1e3,
        "occupancy": tl["occupancy"], "overlap_headroom": tl["overlap_headroom"],
        "stalls": v.pipeline.stats["stalls"] - stalls0,
        "chunk_layers": layers,
        "profiled_wall_ms": trace["wall_ms"],
        "device_busy_share": trace["busy_share"] if trace["device_ms"] else "not measured",
        "device_ms": trace["device_ms"], "streams": trace["streams"],
        "default_stream_events": trace["on_default_stream"],
        "device_ms_by_op": trace["device_ms_by_name"],
    }))
    v.close()
    return 0


class TraceIncomplete(RuntimeError):
    """A profiler trace without `device_trace`'s default-stream markers."""


TRACE_TRIES = 3


def device_trace(run, trace_path: Path, tries: int = TRACE_TRIES) -> dict:
    """Run `run()` under `torch.profiler` (CPU and CUDA activity), write its
    Chrome trace to `trace_path` and read the device's work from it
    (`read_device_trace`). A spin kernel queued on the default stream just
    before `run()` and another just after it mark that stream's id in the
    trace; they stay outside the timed wall. The profiler now and then loses
    events on the card, the markers too (PERF.md section 7): a trace without
    them is taken again, `run()` with it, up to `tries` times in all."""
    for attempt in range(1, tries + 1):
        try:
            return _trace_once(run, trace_path)
        except TraceIncomplete:
            if attempt == tries:
                raise


def _trace_once(run, trace_path: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    return read_device_trace(json.loads(trace_path.read_text()), wall_s)


def read_device_trace(trace: dict, wall_s: float) -> dict:
    """The device's kernels and copies in a Chrome trace: the union of their
    intervals (`device_ms`) over `wall_s` (`busy_share`), their summed
    durations (`device_ms_sum`, larger than the union where streams
    overlap), the count of events per stream id and of kernels per name
    (`kernel_counts`), and the events on the
    default stream, whose id is the spin kernels' (`device_trace`'s
    markers, left out of every other number). Raises when no marker is
    there."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    stream = lambda e: e.get("args", {}).get("stream", e.get("tid"))
    marker = [e for e in events if "spin" in e.get("name", "")]
    if not marker:
        names = sorted({e.get("name", "") for e in events})[:8]
        raise TraceIncomplete(f"no default-stream marker kernel in the profiler trace "
                           f"({len(events)} device events, e.g. {names})")
    default = stream(marker[0])
    work = [e for e in events if "spin" not in e.get("name", "")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in work)
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    streams: dict[str, int] = {}
    by_name: dict[str, float] = {}
    counts: dict[str, int] = {}
    for e in work:
        streams[str(stream(e))] = streams.get(str(stream(e)), 0) + 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e3
        if e["cat"] == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    on_default = sorted({e["name"] for e in work if stream(e) == default})
    return {
        "wall_ms": wall_s * 1e3,
        "device_ms": busy_us / 1e3,
        "device_ms_sum": sum(t1 - t0 for t0, t1 in spans) / 1e3,
        "busy_share": busy_us / (wall_s * 1e6) if wall_s > 0 else 0.0,
        "kernels": sum(e["cat"] == "kernel" for e in work),
        "streams": streams,
        "default_stream": str(default),
        "on_default_stream": sum(stream(e) == default for e in work),
        "on_default_names": on_default[:8],
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
        "kernel_counts": counts,
    }


def _readback_ms(mask: torch.Tensor) -> float:
    """Host ms of the mask's copy into page-locked memory, as the chunk
    loop reads it back."""
    host = torch.empty(mask.shape, dtype=mask.dtype, pin_memory=True)
    return _host_ms(lambda: host.copy_(mask, non_blocking=True))


def _stage(v, path: str, args: tuple, n: int, rows: int, staged: dict) -> None:
    """Stage `args` (n lanes, device hash) into the verifier's pooled
    shard-major buffers as its chunk loop does (`stage_wire`, and the
    committee index vector by `pad_shards`), one shard here; the previous
    call's buffers go back to the pool first (`_give_back` returns the
    last ones). Leaves the (rows, W) wire array and the (W,) indices in
    `staged`."""
    pool, width = v.pipeline.pool, v._bucket(n)
    _give_back(v, staged)
    out = pool.take((1, rows, width), np.uint8)
    st = v.stage_wire(path, True, args, out)
    staged["bufs"] = [out]
    staged["packed"] = out[0]
    if "idx" in st:
        staged["bufs"].append(pad_shards(pool, st["idx"], width, 1))
        staged["idx"] = staged["bufs"][-1][0]


def _give_back(v, staged: dict) -> None:
    for buf in staged.pop("bufs", ()):
        v.pipeline.pool.give(buf)


def _generic_layers(v, msgs, keys, sigs, n) -> dict:
    dev = v.device
    staged = {}
    stage_ms = _host_ms(lambda: _stage(v, "generic", (msgs[:n], keys[:n], sigs[:n]), n, 128, staged))
    host = torch.from_numpy(staged["packed"])
    upload_ms = events_ms(lambda: host.to(dev, non_blocking=True))
    packed = host.to(dev)
    a, r, s, m = ed.split_packed128(packed)
    unpack_ms = events_ms(lambda: sha512.nibble_rows(s))
    sd = sha512.nibble_rows(s)
    hd = sha512.h_digits(r, a, m)
    table, valid = ed.decompress_table(a)
    point = ladder.ladder(sd, hd, table)
    mask = ed.compress_eq(point, r, valid)
    _give_back(v, staged)  # the chunk loop's pool keeps its count of buffers
    return {
        "stage_ms": stage_ms,
        "upload_ms": upload_ms,
        "unpack_ms": unpack_ms,
        "h_digits_ms": queued_ms(lambda: sha512.h_digits(r, a, m)),
        "decompress_table_ms": queued_ms(lambda: ed.decompress_table(a)),
        "ladder_ms": queued_ms(lambda: ladder.ladder(sd, hd, table)),
        "compress_eq_ms": queued_ms(lambda: ed.compress_eq(point, r, valid)),
        "readback_ms": _readback_ms(mask),
    }


def _committee_layers(v, table, msgs, indices, sigs, n) -> dict:
    dev = v.device
    staged = {}
    stage_ms = _host_ms(lambda: _stage(v, "committee", (msgs[:n], indices[:n], sigs[:n]), n, 96, staged))
    host_p, host_i = torch.from_numpy(staged["packed"]), torch.from_numpy(staged["idx"])
    upload_ms = events_ms(lambda: (host_p.to(dev, non_blocking=True), host_i.to(dev, non_blocking=True)))
    packed, idx = host_p.to(dev), host_i.to(dev)
    r, s, m = cm.split_packed96(packed)
    unpack_ms = events_ms(lambda: sha512.nibble_rows(s))
    sd = sha512.nibble_rows(s)
    hd = sha512.h_digits_gather(r, table.keys_u8, idx, m)
    point, lane_valid = cm.committee_ladder(sd, hd, table, idx)
    mask = ed.compress_eq(point, r, lane_valid)
    _give_back(v, staged)
    return {
        "stage_ms": stage_ms,
        "upload_ms": upload_ms,
        "unpack_ms": unpack_ms,
        "h_digits_idx_ms": queued_ms(lambda: sha512.h_digits_gather(r, table.keys_u8, idx, m)),
        "committee_ladder_ms": queued_ms(lambda: cm.committee_ladder(sd, hd, table, idx)),
        "compress_eq_ms": queued_ms(lambda: ed.compress_eq(point, r, lane_valid)),
        "readback_ms": _readback_ms(mask),
    }


if __name__ == "__main__":
    sys.exit(main())
