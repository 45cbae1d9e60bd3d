"""Cost model and roofline of the port's verification kernels on an H100.

    python -m hotstuff_tpu_torch.roofline [--rate SIGS_PER_S] [--committee N]

The port's counterpart of `tools/roofline.py`. The reference counts f32
VPU operations of its jnp kernels against TPU ceilings; that model does
not carry over. This one is the model of `chip_smoke.py`'s `bound_ms`
column, and the single source of its constants:

  * a field product (one 32x32->64 `IMAD.WIDE`) is one INT32 operation,
    the least issue work, so a bound is a floor. Each kernel's products a
    lane are counted by `field.PRODUCTS` while its plain version runs at a
    small width on the CPU (`count_products`); the count does not depend
    on the width or the data. K2 / K2g count `H_DIGITS_OPS_PER_LANE`;
  * the bytes a call must move: each input read once, each output written
    once (`kernel_bytes`), with the committee table's rows for K5 / K2g;
  * `bound_ms` is the larger of bytes over `HBM_BYTES_PER_S` and
    operations over `INT32_OPS_PER_S`.

It prints, for each kernel of both paths (generic: K2, K3, K1, K4;
committee: K2g, K5, K4), the INT32 operations and bytes per signature and
the bound of one 4,096-lane call; with `--rate`, the INT32 operation
throughput that rate implies on each path and its share of the issue
ceiling. The last line is one JSON object with the same numbers.

The constants of the off-path kernels' bounds live here too: K6's
Montgomery products (`BLS_*`) and K7's (`BIT_*_PRODUCTS`), whose bounds
depend on the data of a call (`chip_smoke.bls_bound`,
`chip_smoke.bit_ladder_bound`).
"""

from __future__ import annotations

import argparse
import functools
import json

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# INT32 issue 64 lanes/clk/SM x 132 SMs x 1.98 GHz boost. A field product
# is one 32x32->64 IMAD.WIDE, counted as one INT32 operation: the least
# issue work, so `bound_ms` is a floor.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# K2's integer operations per lane as first counted: 64 schedule words x 13
# 64-bit ops and 80 rounds x 24 64-bit ops, two INT32 operations per 64-bit
# op; TweetNaCl's byte modL, 32 x 20 64-bit multiply-adds. Kept as it is so
# that K2's and K2g's bound reads the same work whatever implements it; the
# radix-2^28 kernel issues fewer instructions than this (PERF.md, section 6).
H_DIGITS_OPS_PER_LANE = 2 * (64 * 13 + 80 * 24) + 2 * 32 * 20
# csrc/h_digits.cu reduce_mod_l, run alone by the test entry: 50 + 25 + 5
# limb products (one IMAD.WIDE each) and 13 + 9 + 9 + 9 carry steps, each
# counted as one operation, the least issue work.
REDUCE_OPS_PER_LANE = (50 + 25 + 5) + (13 + 9 + 9 + 9)
# K6 (csrc/g1_aggregate.cu): a Montgomery product on 12 x 32-bit limbs is
# 12 x 12 products of a x b, 12 x 12 of m x p and 12 digit factors, 300
# IMAD.WIDE; a squaring needs only the 12 x 13 / 2 distinct products of
# a x a (234); a product by the integer 1, which leaves Montgomery form, only
# the reduction (156). Each member of a row beyond its first costs one mixed
# add, 7M + 4S. Counted from the mask, whatever the kernel issues, so a
# redesign is read against the same work. The affine entry adds, at its
# least, a batch inversion over the rows whose sum is not the identity:
# 3 products a row (Montgomery's trick) and one chain Z^(p - 2) a launch,
# the ops/bls.py INV_WINDOWS chain (its odd powers, 1 squaring and 15
# products; 377 squarings and 67 products); then a row's zi^2, zi^3,
# x zi^2, y zi^3 and two products by 1. The kernel runs the chain on every
# row instead (466 products a row), more work than this count.
BLS_OPS_PER_PRODUCT = 12 * 12 + 12 * 12 + 12
BLS_OPS_PER_SQUARE = 12 * 13 // 2 + 12 * 12 + 12
BLS_OPS_PER_REDUCTION = 12 * 12 + 12
BLS_OPS_PER_MEMBER = 7 * BLS_OPS_PER_PRODUCT + 4 * BLS_OPS_PER_SQUARE
BLS_CHAIN_SQUARES, BLS_CHAIN_PRODUCTS = 1 + 377, 15 + 67
BLS_OPS_PER_CHAIN = BLS_CHAIN_SQUARES * BLS_OPS_PER_SQUARE + BLS_CHAIN_PRODUCTS * BLS_OPS_PER_PRODUCT
BLS_OPS_PER_AFFINE = (3 + 3) * BLS_OPS_PER_PRODUCT + BLS_OPS_PER_SQUARE + 2 * BLS_OPS_PER_REDUCTION
# K7's limb products (csrc/bit_ladder.cu), one IMAD.WIDE each: a doubling
# is 4 squares (55 products) and 4 products (100); a mixed add 7 products.
# Every lane doubles 253 times; the function adds B or -A only where a bit
# is set, so the bound counts a call's set bits (the kernel runs both adds
# on every step and selects, as the reference does).
BIT_DBL_PRODUCTS = 4 * 55 + 4 * 100
BIT_MADD_PRODUCTS = 7 * 100

LANES = 4096  # one chunk of the verifier (`TorchBackend`'s chunk)
COMMITTEE = 64  # validators (the bench's --committee-cache leg)

# (path, kernel id, wrapper name) in the order a batch runs them.
PATHS = (
    ("generic", "K2", "h_digits"),
    ("generic", "K3", "decompress_table"),
    ("generic", "K1", "ladder"),
    ("generic", "K4", "compress_eq"),
    ("committee", "K2g", "h_digits_idx"),
    ("committee", "K5", "committee_ladder"),
    ("committee", "K4", "compress_eq"),
)


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least ms the card could take to move `bytes_moved` and issue
    `ops` INT32 operations, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def kernel_bytes(name: str, lanes: int, committee: int = COMMITTEE) -> int:
    """The bytes one call of kernel `name` on `lanes` lanes must move, each
    input read once and each output written once (`committee`: the rows
    of the committee table that K5 and K2g read)."""
    nl = 10  # limbs of a field element (ops/field.py NL)
    if name == "h_digits":  # R, A, M rows in; 64 digits out
        return lanes * (96 + 64)
    if name == "decompress_table":  # key in; the (4, 16, NL) table and valid out
        return lanes * (32 + 4 * 16 * nl * 4 + 1)
    if name == "ladder":  # digits and the table in, the point out; B's table
        return lanes * (2 * 64 + 4 * 16 * nl * 4 + 4 * nl * 4) + 3 * 16 * nl * 4
    if name == "compress_eq":  # X, Y, Z, R and valid in; the mask out
        return lanes * (3 * nl * 4 + 32 + 1 + 1)
    if name == "committee_ladder":  # digits and index in, point and valid out; the table and B's
        return lanes * (2 * 64 + 4 + 4 * nl * 4 + 1) + committee * (16 * 3 * nl * 4 + 1) + 3 * 16 * nl * 4
    if name == "h_digits_idx":  # R, M and the index in, digits out; the committee's keys
        return lanes * (32 + 32 + 4 + 64) + 32 * committee
    if name == "reduce_mod_l":  # 64-byte values in, 32-byte residues out
        return lanes * (64 + 32)
    raise KeyError(name)


def count_products() -> dict[str, int]:
    """Field products a lane of K3, K1, K4 and K5, counted by
    `field.PRODUCTS` while their plain versions run on two random lanes on
    the CPU (a 3-key committee table for K5); counted once a process."""
    return dict(_count_products())


@functools.cache
def _count_products() -> dict[str, int]:
    import numpy as np
    import torch

    from .ops import committee, field, ladder
    from .ops import ed25519 as ed

    width = 2
    rng = np.random.default_rng(0)
    u8 = lambda hi, rows: torch.from_numpy(rng.integers(0, hi, (rows, width), np.uint8))  # noqa: E731

    def count(fn):
        field.PRODUCTS.n = 0
        out = fn()
        return field.PRODUCTS.n, out

    keys, sd, hd, r = u8(256, 32), u8(16, 64), u8(16, 64), u8(256, 32)
    ct = ed.CommitteeTable([rng.bytes(32) for _ in range(3)], "cpu")
    idx = torch.from_numpy(rng.integers(0, 3, width).astype(np.int32))
    out = {}
    out["decompress_table"], (table, valid) = count(lambda: ed.decompress_table_plain(keys))
    out["ladder"], point = count(lambda: ladder.ladder_plain(sd, hd, table))
    out["compress_eq"], _ = count(lambda: ed.compress_eq_plain(point, r, valid))
    out["committee_ladder"], _ = count(lambda: committee.committee_ladder_plain(sd, hd, ct.entries, ct.valid, idx))
    return out


def kernel_rows(committee: int = COMMITTEE) -> dict[str, dict]:
    """Each kernel of both paths: INT32 operations and bytes a lane (a
    signature) and the bound of one LANES-lane call."""
    ops_per_lane = {**count_products(), "h_digits": H_DIGITS_OPS_PER_LANE, "h_digits_idx": H_DIGITS_OPS_PER_LANE}
    rows = {}
    for _path, kid, name in PATHS:
        moved, ops = kernel_bytes(name, LANES, committee), LANES * ops_per_lane[name]
        ms, by = bound_ms(moved, ops)
        rows[name] = dict(kernel=kid, ops_per_sig=ops_per_lane[name], bytes_per_sig=moved / LANES,
                          bytes=moved, ops=ops, bound_ms=ms, bound_by=by)
    return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.roofline", description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=None, help="measured sigs/s to set against the model")
    ap.add_argument("--committee", type=int, default=COMMITTEE, help="validators in the committee table")
    args = ap.parse_args(argv)

    rows = kernel_rows(args.committee)
    print(f"H100 SXM ceilings: HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, INT32 issue "
          f"{INT32_OPS_PER_S / 1e12:.2f} T op/s; committee of {args.committee}")
    print(f"{'path':<10}{'kernel':<22}{'INT32 ops/sig':>14}{'bytes/sig':>11}"
          f"{f'bound ms/{LANES}':>18}  bound by")
    paths: dict[str, int] = {}
    for path, kid, name in PATHS:
        r = rows[name]
        paths[path] = paths.get(path, 0) + r["ops_per_sig"]
        print(f"{path:<10}{kid + ' ' + name:<22}{r['ops_per_sig']:>14,}{r['bytes_per_sig']:>11.1f}"
              f"{r['bound_ms']:>18.4f}  {r['bound_by']}")
    out = {"lanes": LANES, "committee": args.committee, "kernels": rows, "ops_per_sig": paths}
    for path, ops in paths.items():
        print(f"{path} path: {ops:,} INT32 ops/sig")
    if args.rate is not None:
        out["rate"] = args.rate
        out["implied_ops_per_s"] = {path: args.rate * ops for path, ops in paths.items()}
        for path, tput in out["implied_ops_per_s"].items():
            print(f"at {args.rate:,.0f} sigs/s the {path} path issues {tput / 1e12:.3f} T INT32 op/s, "
                  f"{tput / INT32_OPS_PER_S:.2%} of the issue ceiling")
    print(json.dumps(out, sort_keys=True))
    return out


if __name__ == "__main__":
    main()
