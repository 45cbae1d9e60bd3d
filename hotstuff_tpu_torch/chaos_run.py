"""Chaos scenario runner: the port's `tools/chaos_run.py`, single-scenario
mode.

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

The chaos plane runs on the host (see `hotstuff_tpu_torch/chaos/`): no
scenario reaches the card, and the runner needs none.

Exit codes: 0 = every invariant and expectation held; 2 = violations
(report still written) or a refused flag; 3 = usage error.

Not ported yet, and refused (exit 2): the scenario matrix (`--matrix`,
`--matrix-scenarios`, `--matrix-seeds`, `--matrix-sizes`, `--trusted`,
`--jobs`, `--baseline`), ROADMAP A.11.4b.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from .chaos.scenarios import SCENARIOS, SHORT_SCENARIOS, run_scenario

# The reference tool's matrix flags: each takes a value but `--matrix`.
MATRIX_FLAGS = ("--matrix", "--matrix-scenarios", "--matrix-seeds", "--matrix-sizes", "--trusted",
                "--jobs", "--baseline")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.chaos_run", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--scenario", default="all",
                        help=f"scenario name, or 'all' for the short library ({', '.join(sorted(SCENARIOS))})")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--report", default=None, help="write the JSON report here")
    parser.add_argument("--duration", type=float, default=None, help="override virtual seconds")
    parser.add_argument("--list", action="store_true", help="list scenarios and exit")
    parser.add_argument("--matrix", action="store_true", help="not ported yet: refused")
    for flag in MATRIX_FLAGS[1:]:
        parser.add_argument(flag, default=None, help="not ported yet: refused")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    given = [f for f in MATRIX_FLAGS if getattr(args, f[2:].replace("-", "_")) not in (None, False)]
    if given:
        parser.error(f"{', '.join(given)}: the scenario matrix is not ported yet (ROADMAP A.11.4b); "
                     "run one scenario with --scenario")
    return args


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")

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
