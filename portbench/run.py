"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are read from `BENCHMARK.json` and found by name under
`portbench/` (`harness.py`). The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, and with
`--trace 1` `breakdown`; the numbers compared with the plain reference,
each beside its limit, come last, under `checks`, and as the last lines
of standard error.

`--fault NAME` (`faults.py`) puts the control or a planted fault under
the service, for the tests that show the comparison fails; the
benchmark's own runs never pass it.

Exits non-zero, printing no result, without a CUDA device or with fewer
than the cell asks for, without the program (`hotstuff_tpu_torch`), or
when the process holds `jax`, `jaxlib`, `flax` or `hotstuff_tpu` once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "hotstuff_tpu")


def forbidden_modules() -> list[str]:
    """Modules in this process whose top-level name is one of FORBIDDEN,
    compared whole (`hotstuff_tpu_torch` is not `hotstuff_tpu`)."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def parser() -> argparse.ArgumentParser:
    from .faults import FAULTS

    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    from . import harness
    from .faults import FAULTS

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), this machine has {have}",
              file=sys.stderr)
        return 3
    try:
        import hotstuff_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not here ({exc})", file=sys.stderr)
        return 4

    wrap = FAULTS[args.fault] if args.fault else None
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START, wrap=wrap)
    # The spawned pools' semaphore tracker ends with this process; wait for it here.
    from multiprocessing import resource_tracker

    getattr(resource_tracker._resource_tracker, "_stop", lambda: None)()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
