"""A traced run of one cell with the program's own ranges on every thread.

    python3 -m portbench.program_trace --workload <cell> --seed <n> --seconds <s> [--out <file>]
    python3 -m portbench.program_trace --span-cost

The first form runs the cell as `run.py --trace 1` does, with two
differences kept inside this module: the traced stretch's profiler records
every thread (`profile_all_threads`), since `hotstuff_tpu_torch`'s
`metrics.span` ranges lie on the service's worker threads and the
pipeline's two workers, which a profiler started on the event loop's
thread does not see; and the stretch's whole Chrome trace is read, not
only the harness's `portbench.` spans. It prints one JSON line: the run's
result, whose `breakdown` idle gaps keep their names and add the program
ranges open at their middles (`name_gaps`), and beside it

  * `cycle`: each span's and wait's milliseconds a bulk bucket over the
    run's unprofiled window (the registry's deltas over
    `scheduler.bucket_size`'s count), with the window's milliseconds a
    bucket;
  * `traced`: the program's ranges a bulk bucket in the traced stretch,
    the card's idle seconds there and the part of them inside a backend
    call on any thread, the collections there and the longest, and the
    service's signatures a second there and in the window.

`--out` writes the traced stretch's program ranges there as JSON.

`--span-cost` times 100,000 entries and exits of one `metrics.span` with
no profiler, under a profiler of the host and the card on every thread,
and under one of the card alone (the window of a `--trace 0` run), and
says whether torch's flags read true there. Both forms need a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from . import harness, yardstick  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Histograms of the bulk bucket's cycle, in the order a bucket meets them.
CYCLE = ("service.submit_s", "service.assemble_s", "service.handoff_bulk_s", "backend.generic_s",
         "verifier.e2e_s", "verifier.stage_s", "verifier.upload_s", "verifier.dispatch_s",
         "verifier.readback_s", "pipeline.wait_s", "pipeline.stall_s", "service.resolve_s",
         "service.handoff_critical_s", "backend.committee_s", "backend.host_s", "runtime.gc_s")


def program_ranges(trace: dict) -> list[tuple[str, int, float, float]]:
    """Every `record_function` range of a Chrome trace that is not one of
    the harness's spans, as (name, thread id, start, duration) in
    microseconds."""
    return [(e["name"], e["tid"], float(e["ts"]), float(e.get("dur", 0.0))) for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and not e.get("name", "").startswith(harness.SPAN_PREFIX)]


def open_at(ranges, t: float) -> list[str]:
    """The innermost range open at `t` on each thread (the latest started),
    their names sorted."""
    inner: dict = {}
    for name, tid, ts, dur in ranges:
        if ts <= t <= ts + dur and (tid not in inner or ts >= inner[tid][0]):
            inner[tid] = (ts, name)
    return sorted(name for _, name in inner.values())


def idle_gaps(tr: dict) -> list[tuple[float, float]]:
    """Every interval of a traced window (`harness.read_trace`) in which the
    card ran nothing, in order, in microseconds."""
    gaps, at = [], tr["lo_us"]
    for b0, b1 in tr["busy"] + [(tr["hi_us"], tr["hi_us"])]:
        if b0 > at:
            gaps.append((at, b0))
        at = max(at, b1)
    return gaps


def overlap_s(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """Seconds two lists of sorted disjoint intervals (microseconds) share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


def name_gaps(tr: dict, ranges) -> list[list]:
    """The ten longest idle gaps of a traced window (`harness.read_trace`),
    longest first, as [name, seconds]: each named as `harness.breakdown`
    names it, then " | " and the program ranges open at its middle
    (`open_at`) joined by " + ", or "-" where none is."""
    named = []
    for g0, g1 in sorted(idle_gaps(tr), key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        spans = sorted({n[len(harness.SPAN_PREFIX):] for n, t, d in tr["host"] if t <= mid <= t + d})
        prefix = " + ".join(spans) or "no backend call"
        named.append([f"{prefix} | {' + '.join(open_at(ranges, mid)) or '-'}", (g1 - g0) / 1e6])
    return named


def cycle(window: dict, seconds: float) -> dict:
    """Each of CYCLE's histograms in milliseconds a bulk bucket of the
    window (its delta's sum over the delta of `scheduler.bucket_size`'s
    count), with its samples a bucket, and the window's milliseconds a
    bucket."""
    h = window["histograms"]
    buckets = h.get("scheduler.bucket_size", {"count": 0})["count"]
    if buckets <= 0:
        return {}
    out = {"buckets": buckets, "window_ms": 1e3 * seconds / buckets}
    for name in CYCLE:
        if name in h:
            out[name] = {"ms": 1e3 * h[name]["sum"] / buckets, "samples": h[name]["count"] / buckets}
    return out


@contextlib.contextmanager
def _every_thread(traces: list):
    """While open: a torch profiler that records the host records every
    thread, and each Chrome trace the harness exports is also put in
    `traces`."""
    import torch
    import torch.profiler

    plain, export = torch.profiler.profile, harness._export

    def profile(*args, activities=(), **kw):
        if torch.profiler.ProfilerActivity.CPU in activities:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return plain(*args, activities=activities, **kw)

    def keep(prof):
        trace = export(prof)
        traces.append(trace)
        return trace

    torch.profiler.profile, harness._export = profile, keep
    try:
        yield
    finally:
        torch.profiler.profile, harness._export = plain, export


def traced_run(cell: harness.Cell, seed: int, seconds: float) -> tuple[dict, list]:
    """One traced run of `cell` with every thread recorded: (its result with
    `cycle`, `traced` and the renamed gaps, the stretch's program ranges)."""
    seen: list = []
    cell.per_layer = cell.per_layer + [{"name": "_readings", "unit": "-"}]
    cell.readers = dict(cell.readers, _readings=lambda r: seen.append(r))
    traces: list = []
    with _every_thread(traces):
        result = harness.run(cell, seed, seconds, True, T_START)
    r = seen[0]
    out = dict(result, cycle=cycle(r.window, r.seconds))
    if r.trace is None:
        return out, []
    ranges = [x for x in program_ranges(traces[-1]) if r.trace["lo_us"] <= x[2] < r.trace["hi_us"]]
    out["breakdown"] = dict(result["breakdown"], idle_gaps=name_gaps(r.trace, ranges))
    traced_s = (r.trace["hi_us"] - r.trace["lo_us"]) / 1e6
    traced_buckets = r.traced["histograms"].get("scheduler.bucket_size", {"count": 0})["count"]
    sigs = {k: d["counters"].get("crypto.tpu_sigs", 0) + d["counters"].get("crypto.cpu_sigs", 0)
            for k, d in (("window", r.window), ("traced", r.traced))}
    idle = idle_gaps(r.trace)
    calls = yardstick.device_intervals(((ts, ts + d) for n, _, ts, d in ranges if n.startswith("backend.")),
                                       r.trace["lo_us"], r.trace["hi_us"])
    gc_pauses = [d / 1e3 for n, _, _, d in ranges if n == "runtime.gc_s"]
    out["traced"] = {"seconds": traced_s, "ranges": len(ranges), "buckets": traced_buckets,
                     "idle_s": sum(b - a for a, b in idle) / 1e6, "idle_in_backend_calls_s": overlap_s(idle, calls),
                     "gc_pauses": len(gc_pauses), "gc_max_ms": max(gc_pauses, default=0.0),
                     "ranges_per_bucket": len(ranges) / traced_buckets if traced_buckets else None,
                     "sigs_per_s": sigs["traced"] / traced_s, "window_sigs_per_s": sigs["window"] / r.seconds}
    return out, ranges


def span_cost(n: int = 100_000) -> dict:
    """Microseconds a `metrics.span` entry and exit, with no profiler, under
    one of the host and the card on every thread, and under one of the
    card alone; torch's two profiler flags under each."""
    import torch
    import torch.autograd.profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    from hotstuff_tpu_torch.utils import metrics

    h = metrics.histogram("portbench.span_cost_s")
    every = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    settings = {"off": None,
                "host_and_card": lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                                 experimental_config=every),
                "card_alone": lambda: profile(activities=[ProfilerActivity.CUDA])}
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for name, make in settings.items():
        prof = make() if make else None
        if prof is not None:
            prof.start()
        try:
            flags = {"_profiler_enabled": torch.autograd._profiler_enabled(),
                     "_is_profiler_enabled": autograd_profiler._is_profiler_enabled}
            t0 = time.perf_counter()
            for _ in range(n):
                with metrics.span(h):
                    pass
            us = 1e6 * (time.perf_counter() - t0) / n
        finally:
            if prof is not None:
                prof.stop()
        out[name] = dict(flags, us_per_span=us)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.program_trace", description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out")
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.program_trace: needs a CUDA card", file=sys.stderr)
        return 3
    if args.span_cost:
        print(json.dumps(span_cost()))
        return 0
    if args.workload is None or args.seed is None or args.seconds is None:
        ap.error("--workload, --seed and --seconds are required without --span-cost")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out, ranges = traced_run(harness.load_cell(bench, args.workload), args.seed, args.seconds)
    # The spawned pools' semaphore tracker ends with this process; wait for it here (as run.py).
    from multiprocessing import resource_tracker

    getattr(resource_tracker._resource_tracker, "_stop", lambda: None)()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(ranges))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
