"""Chaos scenario runner: the port's `tools/chaos_run.py`.

    python -m hotstuff_tpu_torch.chaos_run --scenario forged_signatures \
        --seed 7 --report out.json

Runs one named scenario (or `--scenario all` for the short library) from
`hotstuff_tpu_torch.chaos.scenarios` on the deterministic virtual-time
loop and writes the JSON report the reference tool writes: fault trace,
per-node commit sequences, invariant violations, chaos.* metric deltas,
per-node flight-recorder dumps (`flight_recorders`), any anomaly-watchdog
triggers and dumps, and an overall `ok` flag. The same --seed replays the
identical fault trace and honest commit sequence. The reference's
`tools/trace_report.py` and `tools/metrics_report.py` read the report.

Scenario-matrix mode (the fleet observatory's regression harness):

    python -m hotstuff_tpu_torch.chaos_run --matrix --report m.json
    python -m hotstuff_tpu_torch.chaos_run --matrix \
        --matrix-scenarios baseline,lossy_links \
        --matrix-seeds 1,2 --matrix-sizes 4,64 --jobs 2 --report m.json

sweeps scenarios x seeds x committee sizes (cells at/above 16 nodes run
the trusted-crypto stub, `chaos/trusted_crypto.py`, and every cell gets
the seeded WAN latency matrix plus per-node telemetry planes), distils
each cell with `utils/telemetry.fleet_rollup` and writes ONE
`chaos_matrix` artifact in the reference's layout, which the reference's
`tools/telemetry_dash.py --matrix` renders. Without `--report` it is
auto-numbered `CHAOS_MATRIX_rNN.json` in the working directory, one past
the newest there. Against a previous artifact (`--baseline`, or the newest
`CHAOS_MATRIX_r*.json` in the working directory) the run also emits
regression deltas: cells that flipped green->red, cells of the baseline
missing from this grid, and the per-cell commit-rate deltas.

The chaos plane runs on the host (see `hotstuff_tpu_torch/chaos/`): no
scenario and no cell reaches the card, and the runner needs none.

Exit codes: 0 = every invariant and expectation held; 2 = violations /
red cells (report still written); 3 = usage error. Matrix mode adds
rc 1 = a previously-green cell went RED against the baseline artifact,
ranked above plain red cells.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import sys
import time

from .chaos.scenarios import (
    MATRIX_SCENARIOS,
    MATRIX_SEEDS,
    MATRIX_SIZES,
    SCENARIOS,
    SHORT_SCENARIOS,
    run_matrix_cell,
    run_scenario,
)
from .utils import metrics

_M_CELLS = metrics.counter("matrix.cells")
_M_GREEN = metrics.counter("matrix.cells_green")
_M_RED = metrics.counter("matrix.cells_red")
_M_REGRESSIONS = metrics.counter("matrix.regressions")


def _run_cell(spec: dict) -> dict:
    """Top-level worker for --jobs process pools (must be picklable)."""
    return run_matrix_cell(**spec)


def _matrix_revisions(directory: str) -> list[tuple[int, str]]:
    """The CHAOS_MATRIX_r<NN>.json artifacts in `directory` as sorted
    (revision, path) pairs: the one scan both the auto-numberer and the
    baseline picker fold over."""
    out = []
    for path in glob.glob(os.path.join(directory, "CHAOS_MATRIX_r*.json")):
        m = re.fullmatch(r"CHAOS_MATRIX_r(\d+)\.json", os.path.basename(path))
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out)


def _next_matrix_path(directory: str) -> str:
    """Auto-numbering: one past the highest revision."""
    revs = _matrix_revisions(directory)
    best = revs[-1][0] if revs else 0
    return os.path.join(directory, f"CHAOS_MATRIX_r{best + 1:02d}.json")


def _latest_matrix_baseline(directory: str, exclude: str) -> str | None:
    """Newest CHAOS_MATRIX_r*.json by revision number, skipping the file
    this run is about to write."""
    for _rev, path in reversed(_matrix_revisions(directory)):
        if os.path.abspath(path) != os.path.abspath(exclude):
            return path
    return None


def _regression_deltas(cells: list[dict], baseline: dict) -> dict:
    """Per-cell deltas against a previous matrix artifact, joined on the
    stable cell key. Verdict flips are the hard signal (rc 1 for
    green->red); commit-rate deltas are the soft trend (deterministic per
    cell config, so a nonzero delta means the code changed the run).
    Baseline cells absent from this run's grid are listed in
    `missing_from_run`."""
    prev = {c["cell"]: c for c in baseline.get("cells", ())}
    now_keys = {c["cell"] for c in cells}
    newly_red, newly_green, rate_deltas = [], [], {}
    for cell in cells:
        p = prev.get(cell["cell"])
        if p is None:
            continue
        if p.get("green") and not cell["green"]:
            newly_red.append(cell["cell"])
        elif not p.get("green") and cell["green"]:
            newly_green.append(cell["cell"])
        prev_rate = (p.get("rollup") or {}).get("commits", {}).get("rate_per_s")
        now_rate = cell["rollup"]["commits"]["rate_per_s"]
        if prev_rate:
            rate_deltas[cell["cell"]] = round(100.0 * (now_rate - prev_rate) / prev_rate, 2)
    worst = min(rate_deltas.items(), key=lambda kv: kv[1]) if rate_deltas else None
    return {
        "newly_red": newly_red,
        "newly_green": newly_green,
        "commit_rate_deltas": rate_deltas,
        "worst_commit_rate_delta": {"cell": worst[0], "pct": worst[1]} if worst else None,
        "missing_from_run": sorted(set(prev) - now_keys),
    }


def _csv(value: str, cast=str) -> list:
    return [cast(s.strip()) for s in value.split(",") if s.strip()]


def run_matrix(args) -> int:
    names = _csv(args.matrix_scenarios) if args.matrix_scenarios else list(MATRIX_SCENARIOS)
    unknown = [s for s in names if s not in SCENARIOS]
    if unknown:
        print(f"unknown matrix scenario(s) {unknown}; --list shows the library", file=sys.stderr)
        return 3
    seeds = _csv(args.matrix_seeds, int) if args.matrix_seeds else list(MATRIX_SEEDS)
    sizes = _csv(args.matrix_sizes, int) if args.matrix_sizes else list(MATRIX_SIZES)

    def _sizes_for(name: str) -> list[int]:
        # A scenario may pin its own size grid (Scenario.matrix_sizes:
        # agg_certs sweeps {4, 64, 128}); an explicit --matrix-sizes wins.
        if args.matrix_sizes:
            return sizes
        return list(SCENARIOS[name].matrix_sizes or sizes)

    specs = [{"scenario": s, "seed": seed, "n": n, "trusted": args.trusted}
             for s in names for seed in seeds for n in _sizes_for(s)]
    out_path = args.report or _next_matrix_path(os.getcwd())
    # Resolve and load the baseline BEFORE the sweep: a typoed --baseline
    # must fail in milliseconds, not after minutes of cells.
    baseline_path = args.baseline or _latest_matrix_baseline(os.getcwd(), exclude=out_path)
    baseline_data = None
    if baseline_path:
        try:
            with open(baseline_path) as f:
                baseline_data = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"baseline {baseline_path}: {e}", file=sys.stderr)
            return 3
    t0 = time.perf_counter()
    if args.jobs > 1:
        # Process workers double as per-cell isolation (a fresh metrics
        # registry each); serial cells share one process and rely on
        # run_scenario's delta accounting.
        import concurrent.futures as cf

        with cf.ProcessPoolExecutor(max_workers=args.jobs) as pool:
            cells = list(pool.map(_run_cell, specs))
    else:
        cells = [_run_cell(spec) for spec in specs]
    wall = time.perf_counter() - t0

    green = sum(1 for c in cells if c["green"])
    red = len(cells) - green
    _M_CELLS.inc(len(cells))
    _M_GREEN.inc(green)
    _M_RED.inc(red)

    regression = {"baseline": baseline_path}
    if baseline_data is not None:
        regression.update(_regression_deltas(cells, baseline_data))
    newly_red = regression.get("newly_red", [])
    _M_REGRESSIONS.inc(len(newly_red))

    for c in cells:
        rollup = c["rollup"]
        bpr = rollup["commits"].get("bytes_per_committed_round")
        print(f"MATRIX cell {c['cell']} {'green' if c['green'] else 'red'} "
              f"crypto={c['crypto_mode']} commits={rollup['commits']['total']} "
              f"rate={rollup['commits']['rate_per_s']}/s "
              f"cert_B/round={bpr if bpr is not None else '-'} "
              f"wall={c['wall_seconds']}s")
    print(f"MATRIX result: {green} green / {red} red of {len(cells)} cells")
    for cell in newly_red:
        print(f"MATRIX regression: {cell} went red (was green)")
    missing = regression.get("missing_from_run", [])
    if missing:
        print(f"MATRIX warning: {len(missing)} baseline cell(s) not in this run's grid "
              f"(their green guarantees are untracked here): " + ", ".join(missing))
    worst = regression.get("worst_commit_rate_delta")
    if baseline_path:
        print("MATRIX worst regression: "
              + (f"{worst['cell']} commit rate {worst['pct']:+.2f}%" if worst else "none"))

    artifact = {
        "v": 1,
        "kind": "chaos_matrix",
        "generated_wall": time.time(),
        "grid": {"scenarios": names, "seeds": seeds, "sizes": sizes, "trusted": args.trusted},
        "cells": cells,
        "summary": {"cells": len(cells), "green": green, "red": red, "wall_seconds": round(wall, 3)},
        "regression": regression,
    }
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"MATRIX artifact written to {out_path}")
    if newly_red:
        return 1
    return 2 if red else 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.chaos_run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--scenario", default="all",
                        help=f"scenario name, or 'all' for the short library ({', '.join(sorted(SCENARIOS))})")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None, help="write the JSON report (or the matrix artifact) here")
    parser.add_argument("--duration", type=float, default=None, help="override virtual seconds")
    parser.add_argument("--list", action="store_true", help="list scenarios and exit")
    parser.add_argument("--matrix", action="store_true",
                        help="scenario-matrix mode: sweep scenarios x seeds x committee sizes and write one "
                        "consolidated artifact with fleet rollups + regression deltas")
    parser.add_argument("--matrix-scenarios", default=None,
                        help=f"comma-separated grid scenarios (default {','.join(MATRIX_SCENARIOS)})")
    parser.add_argument("--matrix-seeds", default=None,
                        help=f"comma-separated seeds (default {','.join(map(str, MATRIX_SEEDS))})")
    parser.add_argument("--matrix-sizes", default=None,
                        help=f"comma-separated committee sizes (default {','.join(map(str, MATRIX_SIZES))})")
    parser.add_argument("--trusted", choices=("auto", "on", "off"), default="auto",
                        help="matrix trusted-crypto mode: auto stubs signatures from 16 nodes up "
                        "(chaos/trusted_crypto.py trust model applies)")
    parser.add_argument("--jobs", type=int, default=1,
                        help="matrix worker processes (default 1 = serial)")
    parser.add_argument("--baseline", default=None,
                        help="previous matrix artifact for regression deltas (default: newest "
                        "CHAOS_MATRIX_r*.json in the working directory)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    if args.matrix:
        if args.jobs < 1:
            print("--jobs must be >= 1", file=sys.stderr)
            return 3
        return run_matrix(args)

    if args.list:
        for name in sorted(SCENARIOS):
            s = SCENARIOS[name]
            tag = " [slow]" if s.slow else ""
            print(f"{name}{tag}: {s.description}")
        return 0

    if args.scenario == "all":
        names = list(SHORT_SCENARIOS)
    elif args.scenario in SCENARIOS:
        names = [args.scenario]
    else:
        print(f"unknown scenario {args.scenario!r}; --list shows the library", file=sys.stderr)
        return 3

    reports = []
    all_ok = True
    for name in names:
        report = run_scenario(name, args.seed, duration=args.duration)
        reports.append(report)
        all_ok &= report["ok"]
        commits = {n: len(c) for n, c in report["commits"].items()}
        print(f"{name}: {'OK' if report['ok'] else 'FAIL'} "
              f"(seed {args.seed}, {report['virtual_seconds']:.1f} virtual s, commits {commits})")
        for v in report["safety_violations"]:
            print(f"  SAFETY: {v}")
        for v in report["liveness_violations"]:
            print(f"  LIVENESS: {v}")
        for v in report.get("expectation_failures", ()):
            print(f"  EXPECT: {v}")
        for t in report.get("watchdog_triggers", ()):
            print(f"  WATCHDOG: {t['reason']} at t={t['t']}")

    out = reports[0] if len(reports) == 1 else {"seed": args.seed, "ok": all_ok, "scenarios": reports}
    if args.report:
        with open(args.report, "w") as f:
            json.dump(out, f, indent=2, sort_keys=True)
            f.write("\n")
    return 0 if all_ok else 2


if __name__ == "__main__":
    sys.exit(main())
