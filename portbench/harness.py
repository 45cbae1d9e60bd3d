"""One run of one cell: set-up, the measured window, the check.

Set-up makes the cell's groups from the seed (`generator.py`), builds one
`TorchBackend` at its defaults, registers the configuration's committee,
runs the verifier once at every bucket width the flood can cut and each
committee lane's first group through the backend, and then sends the
mix's own flood through the service for the mix's `warmup_s`. The window
then sends the same flood through
`BatchVerificationService.verify_group` (the service at its defaults) for
`seconds`: closed lanes keep `in_flight` groups outstanding, open lanes
submit each group when it is due. Each group's answer is timed on the
host clock (the event loop's) from its due time, or its submission on a
closed lane, to its mask.

Where the cell has an end-to-end metric read from the device's trace, a
run with `trace=False` keeps `torch.profiler` (the card's activity
alone) on from just before the window opens until its last group is
answered, so that such a metric takes all of the window's kernels over
all of its work.

A traced run (`trace=True`) wraps the backend in `Spans` (a
`record_function` span around each backend call, named by its route) and,
after the window, keeps the flood going while `torch.profiler` records
`TRACE_S` seconds, between two spin kernels on the default stream that
mark the traced window in the device's clock; a trace that lost either
marker is taken once more. The per-layer readers see the registry's
deltas over the window, and the registry's deltas and the trace over the
traced seconds.

Set-up ends with a full collection, and what it leaves is frozen
(`gc.freeze`) until the window and the traced stretch are over.

Once the window's last group is answered (or `grace_s` has passed), the
device's peak memory is read and the program is closed; then the plain
reference (`reference.py`) verifies every pool triple and every triple
of each committee group due in the window, and each mask of the window
is compared with it lane by lane.
"""

from __future__ import annotations

import asyncio
import gc
import importlib.util
import json
import math
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

from . import generator, reference, yardstick

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent
# The profiled stretch after the window, the pause before it, and how
# often it is taken when the profiler lost a marker.
TRACE_S = 2.0
TRACE_GAP_S = 0.5
TRACE_TRIES = 2
# How long a group may take past the window's close before it counts as
# never answered.
GRACE_S = 60.0
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict[str, Callable]


def _reader(root: Path, name: str) -> Callable:
    path = root / PKG.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of a BENCHMARK.json, with its configuration (its
    entry's `file`), its mix (`portbench/traffic/<traffic>.json`) and a
    reader for each metric it reports (`portbench/metrics/<metric>.py`),
    each found by name under `root`."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(work)}")
    w = work[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((root / config["file"]).read_text())
    traffic = json.loads((root / PKG.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: _reader(root, m["name"]) for m in e2e + layer}
    return Cell(name, int(w["chips"]), cfg, traffic, e2e, layer, readers)


@dataclass
class Rec:
    """One group: its lane, its index in the lane, when it was due (open
    lanes) or submitted (closed lanes), when its answer came, and the
    answer (None: an error or no answer)."""

    lane: str
    index: int
    t_due: float
    t_done: float = math.nan
    mask: bytes | None = None
    error: str | None = None


@dataclass
class Readings:
    """What a metric reader reads. Times are seconds, relative to the
    window's start; `window` and `traced` are registry deltas
    ({"counters": {name: n}, "histograms": {name: {"count", "sum"}}});
    `window_device` is the card's work over the profiled window
    (`device_events`), None where the window was not profiled."""

    seconds: float
    setup_s: float
    lanes: dict
    records: list[Rec]
    window: dict
    committee_size: int
    traced: dict | None = None
    trace: dict | None = None
    window_device: list | None = None


class Spans:
    """The traced run's backend: each call inside a `record_function`
    span named by what it was asked (`portbench.backend.committee` or
    `.generic`); everything else is the wrapped backend's."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_batch_mask(self, messages, keys, signatures, committee: bool = False):
        from torch.autograd.profiler import record_function

        with record_function(SPAN_PREFIX + ("backend.committee" if committee else "backend.generic")):
            return self._inner.verify_batch_mask(messages, keys, signatures, committee=committee)


def _delta(before: dict, after: dict) -> dict:
    counters = {k: v - before["counters"].get(k, 0) for k, v in after["counters"].items()}
    hists = {}
    for k, h in after["histograms"].items():
        b = before["histograms"].get(k, {"count": 0, "sum": 0.0})
        hists[k] = {"count": h["count"] - b["count"], "sum": h["sum"] - b["sum"]}
    return {"counters": counters, "histograms": hists}


class Flood:
    """Sends a workload's lanes through the service, phase by phase; each
    lane's groups continue from where the last phase left off."""

    def __init__(self, svc, wl: generator.Workload, wire) -> None:
        self.svc, self.wl, self.wire = svc, wl, wire
        self.next = {lane.name: 0 for lane in wl.lanes}

    def _group(self, lane, g: int):
        if lane.signers == "pool":
            start = g * lane.size % len(self.wl.pool)
            msgs, pairs = self.wire["pool"]
            return msgs[start : start + lane.size], pairs[start : start + lane.size]
        groups = self.wire[lane.name]
        return groups[g % len(groups)]

    async def _one(self, lane, rec: Rec) -> None:
        msgs, pairs = self._group(lane, rec.index)
        try:
            # Kept as bytes: no object for the collector to walk.
            rec.mask = bytes(await self.svc.verify_group(msgs, pairs, **lane.call))
        except Exception as exc:  # counted as unanswered; the run goes on
            rec.error = repr(exc)
        rec.t_done = asyncio.get_running_loop().time()

    async def phase(self, stop: asyncio.Event, t_end: float | None, grace_s: float) -> tuple[float, list[Rec]]:
        """Send until `stop` is set (open lanes submit nothing due at or
        after `t_end`), then wait up to `grace_s` for what is out. Returns
        the phase's start on the loop clock and its groups."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        recs: list[Rec] = []
        tasks: list[asyncio.Task] = []

        async def closed(lane):
            while not stop.is_set():
                g = self.next[lane.name]
                self.next[lane.name] += 1
                rec = Rec(lane.name, g, loop.time())
                recs.append(rec)
                await self._one(lane, rec)

        async def ticker(lane):
            k = 0
            while True:
                due = t0 + k * lane.interval_s
                if t_end is not None and due >= t_end:
                    return
                if due > loop.time():
                    try:
                        await asyncio.wait_for(stop.wait(), due - loop.time())
                    except asyncio.TimeoutError:
                        pass
                if stop.is_set():
                    return
                g = self.next[lane.name]
                self.next[lane.name] += 1
                rec = Rec(lane.name, g, due)
                recs.append(rec)
                tasks.append(loop.create_task(self._one(lane, rec)))
                k += 1

        drivers = [loop.create_task(closed(lane)) for lane in self.wl.lanes if lane.loop == "closed"
                   for _ in range(lane.in_flight)]
        drivers += [loop.create_task(ticker(lane)) for lane in self.wl.lanes if lane.loop == "open"]
        await stop.wait()
        pending = drivers + tasks
        done, left = await asyncio.wait(pending, timeout=grace_s)
        for t in left:
            t.cancel()
        await asyncio.gather(*left, return_exceptions=True)
        for t in done:
            t.result()
        for rec in recs:
            if rec.mask is None and rec.error is None:
                rec.error = "no answer within the grace"
                rec.t_done = loop.time()
        return t0, recs


def _warm(program, wl: generator.Workload, wire) -> None:
    """The verifier at every bucket width the flood can cut (the pool's
    triples, straight into the backend), and each committee lane's first
    group as the service would send it."""
    msgs, pairs = wire["pool"]
    most = max((lane.size * lane.in_flight for lane in wl.lanes if lane.loop == "closed"), default=0)
    width = program.bucket_alignment
    while msgs and most:
        n = min(width, len(wl.pool))
        program.verify_batch_mask(msgs[:n], [k for k, _ in pairs[:n]], [s for _, s in pairs[:n]])
        if width >= most:
            break
        width *= 2
    for lane in wl.lanes:
        if lane.signers == "committee":
            m, p = wire[lane.name][0]
            kw = {"committee": True} if lane.call.get("committee") else {}
            program.verify_batch_mask(m, [k for k, _ in p], [s for _, s in p], **kw)


def _export(prof) -> dict:
    """A stopped profiler's Chrome trace, through a file in TMPDIR."""
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return json.loads(Path(path).read_text())
    finally:
        os.unlink(path)


def device_events(trace: dict) -> list[tuple[str, str, float, float]]:
    """Every kernel, copy and set of a Chrome trace, as (name, category,
    start, duration), in microseconds."""
    return [(e["name"], e["cat"], float(e["ts"]), float(e.get("dur", 0.0))) for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def read_trace(trace: dict) -> dict | None:
    """The device's work between the two marker spin kernels of a Chrome
    trace, and the harness's host spans: None when a marker is missing
    (the profiler lost events)."""
    device = device_events(trace)
    markers = sorted((e for e in device if "spin" in e[0]), key=lambda e: e[2])
    if len(markers) < 2:
        return None
    lo = markers[0][2] + markers[0][3]
    hi = markers[-1][2]
    work = [e for e in device if "spin" not in e[0] and lo <= e[2] < hi]
    host = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)]
    busy = yardstick.device_intervals(((t, t + d) for _, _, t, d in work), lo, hi)
    return {"lo_us": lo, "hi_us": hi, "device": work, "host": host, "busy": busy}


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the traced window, each named by the harness's host
    spans that covered its middle."""
    by_name: dict[str, float] = {}
    for name, _, _, dur in tr["device"]:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, at = [], tr["lo_us"]
    for b0, b1 in tr["busy"] + [(tr["hi_us"], tr["hi_us"])]:
        if b0 > at:
            gaps.append((at, b0))
        at = max(at, b1)
    named = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (g0 + g1) / 2
        spans = sorted({n[len(SPAN_PREFIX):] for n, t, d in tr["host"] if t <= mid <= t + d})
        named.append([" + ".join(spans) or "no backend call", (g1 - g0) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
        wrap: Callable | None = None, grace_s: float = GRACE_S, workers: int | None = None) -> dict:
    """One run of `cell`; returns the result line's object, with the
    compared numbers under `checks`. `t_start` is the process's start on
    `time.perf_counter`; `wrap` puts a fault or the control around the
    backend (`faults.py`)."""
    import torch

    from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.utils import metrics

    if trace and device != "cuda":
        raise ValueError("a traced run reads the card's profiler trace: it needs device='cuda'")
    profile_window = not trace and device == "cuda" and any(m["source"] == "device_trace" for m in cell.end_to_end)
    workers = workers or min(8, os.cpu_count() or 1)
    # The traced stretches, each with a second's slack for the profiler's
    # start and stop.
    extra_s = TRACE_TRIES * (TRACE_GAP_S + TRACE_S + 1.0) if trace else 0.0
    wl = generator.build(cell.config, cell.traffic, seed, seconds, extra_s, workers)

    wire = {"pool": ([m for m, _, _ in wl.pool] * 2, [(PublicKey(k), Signature(s)) for _, k, s in wl.pool] * 2)}
    for lane in wl.lanes:
        if lane.signers == "committee":
            wire[lane.name] = [(m, [(PublicKey(k), Signature(s)) for k, s in zip(ks, ss)]) for m, ks, ss in lane.groups]

    backend = TorchBackend(device=device)
    faulty = wrap(backend) if wrap else None
    program = faulty or backend
    if trace:
        program = Spans(program)
    backend.register_committee(wl.committee_keys)
    _warm(program, wl, wire)

    out: dict = {}

    async def drive() -> None:
        loop = asyncio.get_running_loop()
        svc = BatchVerificationService(program)
        flood = Flood(svc, wl, wire)
        stop = asyncio.Event()
        loop.call_later(wl.warmup_s, stop.set)
        _, warm_recs = await flood.phase(stop, None, GRACE_S)
        failed = [r for r in warm_recs if r.mask is None]
        if failed:
            raise RuntimeError(f"warm-up group failed: {failed[0].error}")

        # Set-up's objects, the signed pool above all, live to the end of
        # the run; frozen, the collector does not walk them in the window
        # (a full collection over them took 150-190 ms on the H100's host).
        gc.collect()
        gc.freeze()
        before = metrics.REGISTRY.dump(include_buckets=False)
        if faulty is not None:
            faulty.armed = True
        prof = None
        if profile_window:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        stop = asyncio.Event()
        out["setup_s"] = time.perf_counter() - t_start
        t_end = loop.time() + seconds
        loop.call_at(t_end, stop.set)
        t0, recs = await flood.phase(stop, t_end, grace_s)
        after = metrics.REGISTRY.dump(include_buckets=False)
        if prof is not None:
            torch.cuda.synchronize()
            prof.stop()
            out["window_device"] = device_events(_export(prof))
            del prof
        out["window"] = _delta(before, after)
        for r in recs:
            r.t_due -= t0
            r.t_done -= t0
        out["records"] = recs
        if backend.device.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(backend.device)
        if trace:
            out["traced"], out["trace"] = await _traced(flood, loop, metrics, torch)

    async def _traced(flood, loop, metrics, torch):
        from torch.profiler import ProfilerActivity, profile

        for _ in range(TRACE_TRIES):
            stop = asyncio.Event()
            task = loop.create_task(flood.phase(stop, None, grace_s))
            await asyncio.sleep(TRACE_GAP_S)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            before = metrics.REGISTRY.dump(include_buckets=False)
            prof.start()
            torch.cuda._sleep(100_000)
            await asyncio.sleep(TRACE_S)
            torch.cuda._sleep(100_000)
            after = metrics.REGISTRY.dump(include_buckets=False)
            stop.set()
            await task
            torch.cuda.synchronize()
            prof.stop()
            tr = read_trace(_export(prof))
            if tr is not None:
                return _delta(before, after), tr
        return None, None

    try:
        asyncio.run(drive())
    finally:
        gc.unfreeze()
        backend.close()
    del program, backend
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # The check, with the program's state gone.
    t_ref = time.perf_counter()
    recs: list[Rec] = out["records"]
    lanes = {lane.name: lane for lane in wl.lanes}
    want: dict[tuple, tuple[int, int]] = {}
    triples: list = []
    if any(lanes[r.lane].signers == "pool" for r in recs):
        triples.extend(wl.pool)
    for r in recs:
        if lanes[r.lane].signers == "committee":
            m, k, s = lanes[r.lane].groups[r.index]
            want[(r.lane, r.index)] = (len(triples), len(m))
            triples.extend(zip(m, k, s))
    verdict = bytes(reference.verdicts(triples, workers))
    pool2 = verdict[: len(wl.pool)] * 2
    mismatches = unanswered = failed = compared = 0
    for r in recs:
        lane = lanes[r.lane]
        if lane.signers == "pool":
            start = r.index * lane.size % len(wl.pool)
            ref = pool2[start : start + lane.size]
        else:
            at, n = want[(r.lane, r.index)]
            ref = verdict[at : at + n]
        if r.mask is None:
            unanswered += 1
            failed += 1
            continue
        compared += len(ref)
        if r.mask == ref:
            continue
        bad = len(ref) if len(r.mask) != len(ref) else sum(a != b for a, b in zip(r.mask, ref))
        mismatches += bad
        failed += bad > 0
    checks = {"lane_mismatches": {"value": mismatches, "limit": 0},
              "unanswered_groups": {"value": unanswered, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    readings = Readings(seconds, out["setup_s"], lanes, recs, out["window"],
                        len(wl.committee_keys), out.get("traced"), out.get("trace"), out.get("window_device"))
    wanted = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in wanted:
        v = cell.readers[m["name"]](readings)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips if device == "cuda" else 0,
           "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    result = {"correct": correct, "attempted": len(recs), "failed": failed, "metrics": values, "device": dev}
    tr = out.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = sum(b - a for a, b in tr["busy"]) / 1e6
        dev["window_s"] = (tr["hi_us"] - tr["lo_us"]) / 1e6
        result["breakdown"] = breakdown(tr)
    result["window_sigs"] = sum(len(r.mask) for r in recs if r.mask is not None and r.t_done <= seconds)
    result["lanes_compared"] = compared
    result["reference_s"] = time.perf_counter() - t_ref
    result["pool_corrupted"] = len(wl.corrupted)
    result["checks"] = checks
    return result
