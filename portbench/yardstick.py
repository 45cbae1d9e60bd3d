"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move the yardstick.

  * `percentile` and `rate`: the nearest-rank percentile over every
    sample (a copy of `hotstuff_tpu_torch.utils.metrics.percentile`) and
    a count over a window's seconds;
  * the H100's published peaks and, for each kernel of the two
    verification paths, the INT32 operations and bytes a signature needs
    (copied from `hotstuff_tpu_torch.roofline` as it counts them: a field
    product is one 32x32->64 multiply, each input byte read once, each
    output byte written once), and `kernel_bound_s`, the least time the
    card could take for a set of verified lanes;
  * `device_intervals`, the union of a profiler trace's kernel and copy
    intervals (the interval arithmetic of
    `hotstuff_tpu_torch.breakdown.read_device_trace`).

`portbench/tests/test_portbench_yardstick.py` holds the operation and byte counts
equal to the program's model at the commit that froze them.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

# NVIDIA H100 SXM (data sheet, Hopper white paper), at the 700 W limit:
# HBM3 3.35 TB/s; INT32 issue 64 lanes a clock an SM x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# Field elements are 10 limbs of 4 bytes (`ops/field.py`).
_LIMBS = 10
# INT32 operations a lane: K2 / K2g's SHA-512 and mod-L count, the other
# kernels' field products as their plain versions issue them.
OPS_PER_LANE = {
    "h_digits": 6784,
    "h_digits_idx": 6784,
    "decompress_table": 27625,
    "ladder": 229120,
    "compress_eq": 15270,
    "committee_ladder": 222720,
}
# Each path's kernels, in the order a chunk runs them.
PATHS = {
    "generic": ("h_digits", "decompress_table", "ladder", "compress_eq"),
    "committee": ("h_digits_idx", "committee_ladder", "compress_eq"),
}


def kernel_bytes(name: str, lanes: int, committee: int) -> int:
    """The bytes one call of kernel `name` on `lanes` lanes must move, with
    the rows of a `committee`-key table that K5 and K2g read."""
    nl = _LIMBS
    if name == "h_digits":  # R, A, M in; 64 digits out
        return lanes * (96 + 64)
    if name == "decompress_table":  # key in; the (4, 16, NL) table and valid out
        return lanes * (32 + 4 * 16 * nl * 4 + 1)
    if name == "ladder":  # digits and table in, the point out; B's table
        return lanes * (2 * 64 + 4 * 16 * nl * 4 + 4 * nl * 4) + 3 * 16 * nl * 4
    if name == "compress_eq":  # X, Y, Z, R and valid in; the mask out
        return lanes * (3 * nl * 4 + 32 + 1 + 1)
    if name == "committee_ladder":  # digits, index in; point, valid out; the tables
        return lanes * (2 * 64 + 4 + 4 * nl * 4 + 1) + committee * (16 * 3 * nl * 4 + 1) + 3 * 16 * nl * 4
    if name == "h_digits_idx":  # R, M, index in; digits out; the committee's keys
        return lanes * (32 + 32 + 4 + 64) + 32 * committee
    raise KeyError(name)


def kernel_bound_s(path: str, lanes: int, calls: int, committee: int = 0) -> float:
    """The least seconds the card needs for `lanes` verified lanes of
    `path` run in `calls` chunks: for each kernel the larger of its
    operations over the INT32 issue rate and its bytes over HBM's rate,
    summed over the path's kernels."""
    total = 0.0
    for name in PATHS[path]:
        per_call = kernel_bytes(name, 0, committee)
        moved = kernel_bytes(name, lanes, committee) - per_call + per_call * calls
        total += max(lanes * OPS_PER_LANE[name] / INT32_OPS_PER_S, moved / HBM_BYTES_PER_S)
    return total


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (ceil rank) over every sample; NaN on none."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(0, min(len(ordered) - 1, math.ceil(q * len(ordered)) - 1))]


def rate(count: float, seconds: float) -> float:
    """`count` over `seconds`, all of a window's work over all its time."""
    return count / seconds


def device_intervals(spans: Iterable[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for t0, t1 in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]
