"""The ladder kernels (K1 `ladder`, K5 `committee_ladder`, K7
`bit_ladder`), K3 `decompress_table`, K4 `compress_eq`, K2 `h_digits`,
K2g `h_digits_idx`, K6 `g1_aggregate` and K8 `field12` of this checkout
beside the same kernels of other checkouts, on one card.

    python3 -m hotstuff_tpu_torch.ladder_ab [--csrc NAME=DIR ...] [--reps 3] [--kernels K ...]

`--csrc NAME=DIR` names another checkout's `hotstuff_tpu_torch/ops/csrc/`
(e.g. an earlier commit unpacked with `git archive`, or a copy with an
edit), built with the flags of `ops/_build.py`. For each build, per
kernel: ptxas' registers, spills and stack frame, and SASS instructions by
opcode (`cuobjdump -sass`): for the ladders, K3 and K4 those of the
kernel's longest loop body (its longest backward branch; the 64-group loop
of K1 and K5, K7's 253-step loop, the `split_sq_n` / `fe_sq_n` squaring
loop of K4, so one squaring per thread, K3's loop over table entries); for
K2 and K2g, which have no loop once unrolled, the whole kernel function.
Then every build's output must equal this checkout's (ladders: raw limbs
and `lane_valid`; K3: raw limbs and valid; K4: the mask; K2 / K2g: the
digits), and the builds are timed in turns at 128 and 4,096 lanes (K7 at
8,192 too, the f32 path's piece): CUDA events over several launches as
the host issues them (`events_ms`), and over launches queued behind a spin
kernel, which leaves the host's launch time out (`queued_ms`). The last
line is one JSON object with all of it, beside the card's name and power
limit.

K6 (`bls_ab`) runs on `chip_smoke.py` phase 8's largest corpus
(`bls_corpus`: BLS_KEYS keys, BLS_ROWS bitmap rows; keys from a spawn
pool): `hs_g1_aggregate` (the fold alone, the entry every build has) must
give every build's limbs at all rows and at 1 row, and is timed in turns
(`queued_ms`); SASS is counted over the fold's function and over
`hs_bls_mont_mul`'s (one product). Then `aggregate_masks`' wall as each
build serves it, in turns (upload, launch, readback, ints): a build with
`hs_g1_aggregate_affine` runs it and `affine_of_limbs`, one without runs
the fold and the host's `affine_points`; every build's points must agree.

K8's leg (`field12`, `field12_ab`) runs the tuning tool's chain,
`hs_field12` with F12_CHAIN squarings a launch, on seeded normalized
elements (the first lanes 0, 1, p - 1, 2^255 - 20): every build's limbs
must equal this checkout's at every width of F12_WIDTHS, and
`hs_field12_mul`'s at F12_MUL_WIDTH; then the builds are timed in turns
(`queued_ms`) at F12_TIMED, with this checkout's `hs_field_sqr_n` (the
production field's chain, the tool's other `--field` row) beside them at
the same widths: the field ratio. SASS is counted over the squaring loop
in `hs_field12`'s function (the longest backward branch: the busiest
warp's loop where a lane's products are split over warps).

The carry-overlap leg (`mont_chain`, `chain_ab`) asks whether the card
overlaps two independent carry chains in one thread: CHAIN_SOURCE,
compiled against each build's `g1_aggregate.cu`, runs CHAIN_STEPS
dependent K6 products (`mont_mul`) a thread in one chain and in two
independent chains side by side, and the same for a control without
carries (CONTROL_OPS dependent 32-bit multiply-adds a step), one warp an
SM. Each build's results must equal the shipped build's and Python's
ints; the leg reports ns a step and the two chains' time over one
chain's (2: the chains run one after the other; 1: they overlap).

`--kernels` picks the legs to build, compare and time (default: all); it
exists only so that a chip call can leave out the legs an A/B does not
need.
Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import multiprocessing
import random
import re
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from . import bls_corpus
from .breakdown import events_ms, queued_ms
from .crypto import pysigner
from .ops import _build, bls
from .ops import ed25519 as ed
from .ops import field, ladder
from .ops import field12 as f12

SOURCES = ("ladder", "committee_ladder", "decompress_table", "compress_eq", "h_digits", "h_digits_idx",
           "bit_ladder")
BLS_KERNELS = ("g1_aggregate", "bls_mont_mul")  # K6's fold alone and its product: `bls_ab`
BLS_KEYS, BLS_ROWS, BLS_POOL = 256, 1024, 8  # chip_smoke.py phase 8's largest table, its rows, its pool
CHAIN = "mont_chain"  # the carry-overlap leg: `chain_ab`
CHAIN_STEPS = 256
CONTROL_OPS = 64  # dependent multiply-adds a step of the control chain
CHAIN_SOURCE = r"""// ladder_ab's carry-overlap leg: `steps` dependent K6 products a thread
// (mont_mul of the g1_aggregate.cu on the include path), in CHAINS
// independent chains side by side, or (FIELD false) CONTROL_OPS dependent
// 32-bit multiply-adds a step on limb 0, which carry nothing. a: (CHAINS,
// 12, batch) canonical limbs, b: (12, batch); out like a.
#include "g1_aggregate.cu"

namespace {

template <int CHAINS, bool FIELD>
__global__ void __launch_bounds__(32) mont_chain_kernel(const uint32_t* __restrict__ a,
                                                        const uint32_t* __restrict__ b,
                                                        uint32_t* __restrict__ out, int steps, int batch) {
  const int i = blockIdx.x * 32 + threadIdx.x;
  if (i >= batch) return;
  Fe x[CHAINS], y;
#pragma unroll
  for (int j = 0; j < NL; j++) {
    y.v[j] = b[j * batch + i];
#pragma unroll
    for (int c = 0; c < CHAINS; c++) x[c].v[j] = a[(c * NL + j) * batch + i];
  }
#pragma unroll 1
  for (int s = 0; s < steps; s++) {
#pragma unroll
    for (int c = 0; c < CHAINS; c++) {
      if constexpr (FIELD) {
        mont_mul(x[c], x[c], y);
      } else {
#pragma unroll
        for (int k = 0; k < %(control)d; k++) x[c].v[0] = x[c].v[0] * x[c].v[0] + y.v[0];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NL; j++)
#pragma unroll
    for (int c = 0; c < CHAINS; c++) out[(c * NL + j) * batch + i] = x[c].v[j];
}

template <int CHAINS, bool FIELD>
void launch(const void* a, const void* b, void* out, int steps, int batch, cudaStream_t s) {
  mont_chain_kernel<CHAINS, FIELD><<<(batch + 31) / 32, 32, 0, s>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, steps, batch);
}

}  // namespace

extern "C" int hs_mont_chain(const void* a, const void* b, void* out, int chains, int field, int steps, int batch,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (field) {
    chains == 2 ? launch<2, true>(a, b, out, steps, batch, s) : launch<1, true>(a, b, out, steps, batch, s);
  } else {
    chains == 2 ? launch<2, false>(a, b, out, steps, batch, s) : launch<1, false>(a, b, out, steps, batch, s);
  }
  return (int)cudaGetLastError();
}
""" % {"control": CONTROL_OPS}
# Kernels counted over their whole function (no loop once unrolled): the
# cuobjdump function names of this checkout's build and of earlier ones.
WHOLE_FUNCTION = {
    "h_digits": r"h_digits_kernel(ILb0E|P)",
    "h_digits_idx": r"h_digits_(idx_kernel|kernelILb1E)",
    "g1_aggregate": r"g1_aggregate_kernel(ILb0E|EP)",
    "bls_mont_mul": r"mont_mul_kernel",
}
F12 = "field12"  # K8's leg: `field12_ab`
F12_CHAIN = 64  # squarings a launch, as tune_device --field
F12_WIDTHS = (7, 128, 4096, 135168)  # limbs held equal; 135,168 = 33 x 4,096 lanes
F12_TIMED = (128, 4096, 135168)
F12_MUL_WIDTH = 4096
# Kernels whose loop lies in one of several functions of their library.
LOOP_FUNCTION = {F12: r"\dfield12_kernel"}
WIDTHS = (128, 4096)
WIDTHS_OF = {"bit_ladder": (128, 4096, 8192)}  # K7 also at the f32 path's piece
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_FUNCTION = re.compile(r"Function : (\S+)")


def source_of(kernel: str) -> str:
    return _build.EXTRA_ENTRY_POINTS.get(kernel, kernel)


def build(jobs: dict[str, Path], kernels) -> dict:
    """Build the sources of `kernels` of every job (name -> csrc directory),
    all in parallel; returns {name: {source: (library, ptxas log)}}."""
    procs = {}
    for name, csrc in jobs.items():
        out = _build.BUILD / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        for src in dict.fromkeys(map(source_of, kernels)):
            lib, log = out / f"lib{src}.so", out / f"{src}.log"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib),
                   str(csrc / f"{src}.cu")]
            with open(log, "w") as fh:
                procs[name, src] = (lib, log, subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT))
    builds = collections.defaultdict(dict)
    for (name, src), (lib, log, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"ladder_ab: {name}/{src} failed to build:\n{log.read_text()}")
        builds[name][src] = (lib, log)
    return dict(builds)


def sass_counts(lib: Path, kernel: str, sass: str | None = None) -> dict:
    """SASS instructions counted by opcode (before the first '.'), plus
    `total` and the library's static count `all`. For a kernel of
    WHOLE_FUNCTION, every instruction of its function; otherwise those of
    the longest backward branch inside one function (a `#pragma unroll 1`
    loop: a ladder's group loop, K4's squaring loop, K3's entry loop, K8's
    squaring loop: in a function of LOOP_FUNCTION where the library has
    several), counted in that function alone: addresses restart at every
    function. `sass` stands for `cuobjdump -sass lib`'s output."""
    if sass is None:
        cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                              text=True).stdout
    parse = lambda text: [(int(m.group(1), 16), m.group(3), m.group(4)) for m in _INSN.finditer(text)]
    functions = [(f.group(1), parse(sec)) for sec in re.split(r"(?=Function : )", sass)
                 if (f := _FUNCTION.match(sec))]
    total = sum(len(insns) for _, insns in functions)
    pattern = WHOLE_FUNCTION.get(kernel, LOOP_FUNCTION.get(kernel))
    mine = [insns for name, insns in functions if pattern is None or re.search(pattern, name)]
    if pattern is not None and len(mine) != 1:
        raise SystemExit(f"ladder_ab: {len(mine)} SASS functions of {kernel} in {lib}")
    if kernel in WHOLE_FUNCTION:
        counts = collections.Counter(op.split(".")[0] for _, op, _ in mine[0])
        return dict(counts.most_common(), total=sum(counts.values()), all=total)
    best, lo, hi = [], 0, -1
    for insns in mine:
        for addr, op, args in insns:
            t = _TARGET.search(args) if op.startswith("BRA") else None
            if t and int(t.group(1), 16) < addr and addr - int(t.group(1), 16) > hi - lo:
                best, lo, hi = insns, int(t.group(1), 16), addr
    counts = collections.Counter(op.split(".")[0] for addr, op, _ in best if lo <= addr <= hi)
    return dict(counts.most_common(), total=sum(counts.values()), all=total)


def inputs(seed: int, lanes: int, dev) -> dict:
    """Random digits, random keys (about half decompress) and K3's table of
    them, a 64-validator committee table with random indices (every 97th
    out of range), K4's inputs: K1's points, R rows that match them on
    every even lane, valid on all but every seventh lane; K2's R and M
    rows; and K7's (253, lanes) bits of s and h."""
    rng = np.random.default_rng(seed)
    digits = lambda: torch.from_numpy(rng.integers(0, 16, (64, lanes), np.uint8)).to(dev)
    keys = torch.from_numpy(rng.integers(0, 256, (32, lanes), np.uint8)).to(dev)
    table, _ = ed.decompress_table(keys)
    vkeys = [pysigner.keypair_from_seed(bytes(r))[0] for r in rng.integers(0, 256, (64, 32), np.uint8)]
    ct = ed.CommitteeTable(vkeys, dev)
    idx_np = rng.integers(0, ct.size, lanes).astype(np.int32)
    idx_np[::97] = -1
    idx = torch.from_numpy(idx_np).to(dev)
    sd, hd = digits(), digits()
    xyzt = ladder.ladder(sd, hd, table)
    r = torch.from_numpy(rng.integers(0, 256, (32, lanes), np.uint8)).to(dev)
    r[:, ::2] = ed.compress(xyzt)[:, ::2]
    valid = torch.tensor([i % 7 != 5 for i in range(lanes)], device=dev)
    m = torch.from_numpy(rng.integers(0, 256, (32, lanes), np.uint8)).to(dev)
    bits = lambda: torch.from_numpy(rng.integers(0, 2, (ed.SCALAR_BITS, lanes), np.uint8)).to(dev)
    sb, hb = bits(), bits()
    return dict(keys=keys, sd=sd, hd=hd, table=table, ct=ct, idx=idx, xyzt=xyzt, r=r, valid=valid, m=m,
                sb=sb, hb=hb)


def runner(kernel: _build.Kernel, src: str, x: dict, w: int):
    """(out, lane_valid or None, a closure launching `kernel` on the first
    w lanes of x)."""
    dev = x["sd"].device
    cut = lambda t: t[..., :w].contiguous()
    if src == "compress_eq":
        xyzt, r, valid = cut(x["xyzt"]), cut(x["r"]), cut(x["valid"])
        mask = torch.empty((w,), dtype=torch.bool, device=dev)
        return mask, None, lambda: kernel.launch(xyzt, r, valid, mask, w)
    if src in ("h_digits", "h_digits_idx"):
        r, m, idx = cut(x["r"]), cut(x["m"]), cut(x["idx"])
        digits = torch.empty((64, w), dtype=torch.uint8, device=dev)
        if src == "h_digits":
            keys = cut(x["keys"])
            return digits, None, lambda: kernel.launch(r, keys, m, digits, w)
        keys = x["ct"].keys_u8
        return digits, None, lambda: kernel.launch(r, keys, idx, m, digits, keys.shape[1], w)
    if src == "decompress_table":
        keys = cut(x["keys"])
        table = torch.empty((4, 16, field.NL, w), dtype=torch.int32, device=dev)
        valid = torch.empty((w,), dtype=torch.bool, device=dev)
        return table, valid, lambda: kernel.launch(keys, table, valid, w)
    sd, hd = cut(x["sd"]), cut(x["hd"])
    base = field.const("base_table", ed.BASE_TABLE, dev)
    out = torch.empty((4, field.NL, w), dtype=torch.int32, device=dev)
    if src == "ladder":
        table = cut(x["table"])
        return out, None, lambda: kernel.launch(sd, hd, base, table, out, w)
    if src == "bit_ladder":
        sb, hb, table = cut(x["sb"]), cut(x["hb"]), cut(x["table"])
        return out, None, lambda: kernel.launch(sb, hb, base, table, out, w)
    ct, idx = x["ct"], cut(x["idx"])
    valid = torch.empty((w,), dtype=torch.bool, device=dev)
    return out, valid, lambda: kernel.launch(sd, hd, base, ct.entries, ct.valid, idx, out, valid, ct.size, w)


def bls_inputs(seed: int, dev) -> tuple:
    """Phase 8's table of BLS_KEYS keys (`bls_corpus`: its seeds, its
    special lanes) on `dev` and its BLS_ROWS bitmap rows."""
    with multiprocessing.get_context("spawn").Pool(BLS_POOL) as pool:
        pairs = pool.map(bls_corpus.keypair, bls_corpus.validator_seeds(BLS_KEYS))
    keys, _, lanes = bls_corpus.table_keys(pairs, BLS_KEYS)
    masks, _ = bls_corpus.bitmap_rows(seed, BLS_KEYS, lanes, BLS_ROWS)
    return bls.CommitteeTable(keys, device=dev), masks


def bls_kernels(libs: dict[str, Path]) -> tuple[dict, dict]:
    """Each build's (name -> its libg1_aggregate.so) K6 entries: the fold
    alone, and the affine entry where the library has one."""
    fold = {name: _build.Kernel("g1_aggregate", lib=lib) for name, lib in libs.items()}
    affine = {name: _build.Kernel("g1_aggregate_affine", "g1_aggregate", lib=lib) for name, lib in libs.items()
              if hasattr(ctypes.CDLL(str(lib)), "hs_g1_aggregate_affine")}
    return fold, affine


def bls_ab(fold: dict, affine: dict, reps: int, seed: int, dev) -> dict:
    """K6 of every build in turns (`bls_kernels`; "shipped" is this
    checkout's): the fold alone at all of the corpus's rows and at its last
    row, limbs equal and queued ms; then `aggregate_masks`' wall as each
    build serves it (see the module docstring). Returns {name: {...}}."""
    table, masks = bls_inputs(seed, dev)
    n = table.size
    out = {name: {} for name in fold}
    for b in (len(masks), 1):
        rows = torch.from_numpy(masks[-b:]).to(dev)
        res = {name: torch.empty((3, bls.NLIMB, b), dtype=torch.int32, device=dev) for name in fold}
        runs = {name: (lambda k=k, o=res[name]: k.launch(table.tx, table.ty, table.present, rows, o, n, b))
                for name, k in fold.items()}
        for run in runs.values():
            run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ref = res["shipped"]
        for name, o in res.items():
            if not torch.equal(o, ref):
                raise SystemExit(f"ladder_ab: {name}/g1_aggregate differs from the shipped build at {b} rows")
        queued = collections.defaultdict(list)
        for _ in range(reps):
            for name, run in runs.items():
                queued[name].append(queued_ms(run, 20))
        for name, q in queued.items():
            out[name][f"queued_ms_{b}"] = q
            print(f"{name} g1_aggregate {n} keys x {b} rows: queued {[round(v, 4) for v in q]} ms", flush=True)

    def serve(name: str) -> tuple[float, list]:
        t0 = time.perf_counter()
        rows = torch.from_numpy(masks).to(dev)
        b = rows.shape[0]
        if name in affine:
            lim = torch.empty((2, bls.NLIMB, b), dtype=torch.int32, device=dev)
            flags = torch.empty((b,), dtype=torch.uint8, device=dev)
            affine[name].launch(table.tx, table.ty, table.present, rows, lim, flags, n, b)
            pts = bls.affine_of_limbs(lim, flags)
        else:
            jac = torch.empty((3, bls.NLIMB, b), dtype=torch.int32, device=dev)
            fold[name].launch(table.tx, table.ty, table.present, rows, jac, n, b)
            pts = bls.affine_points(jac)
        return (time.perf_counter() - t0) * 1e3, pts

    walls = collections.defaultdict(list)
    want = serve("shipped")[1]
    for _ in range(reps):
        for name in fold:
            ms, pts = serve(name)
            if pts != want:
                raise SystemExit(f"ladder_ab: aggregate_masks as {name} serves it differs from the shipped build")
            walls[name].append(ms)
    for name, w in walls.items():
        how = "affine entry + affine_of_limbs" if name in affine else "fold + host affine_points"
        out[name].update(aggregate_masks_wall_ms=w, served_by=how)
        print(f"{name} aggregate_masks {n} x {len(masks)} ({how}): {[round(v, 3) for v in w]} ms wall, median "
              f"{statistics.median(w):.3f}", flush=True)
    return out


def field12_inputs(seed: int, lanes: int, dev) -> tuple:
    """x and y: (22, lanes) normalized radix-2^12 elements below 2^255, x's
    first lanes 0, 1, p - 1, 2^255 - 20; x25: (10, lanes) carried limbs of
    the production field (`hs_field_sqr_n`'s input)."""
    rng = np.random.default_rng(seed)

    def elements() -> np.ndarray:
        limbs = rng.integers(0, f12.RADIX, (f12.NLIMB, lanes), dtype=np.uint32)
        limbs[-1] &= 7  # limb 21 holds bits 252-254
        return limbs

    x, y = elements(), elements()
    edge = [0, 1, f12.P - 1, 2**255 - 20][:lanes]
    x[:, :len(edge)] = np.concatenate([f12.limbs_of_int(v) for v in edge], axis=1)
    x25 = np.stack([rng.integers(0, 1 << w, lanes) for w in field.WIDTHS]).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(t).view(np.int32)).to(dev) for t in (x, y, x25))


def field12_ab(kernels: dict, sqr_n_kernel, reps: int, seed: int, dev, widths=F12_WIDTHS, timed=F12_TIMED,
               mul_width: int = F12_MUL_WIDTH, chain: int = F12_CHAIN) -> dict:
    """K8 of every build in turns (name -> (`hs_field12`, `hs_field12_mul`)
    kernels; "shipped" is this checkout's): `chain` squarings a launch, limbs
    equal to the shipped build's at every width of `widths` and the product's
    at `mul_width`; queued ms at `timed`, with `sqr_n_kernel`
    (`hs_field_sqr_n`) at the same widths. Returns {"builds": {name: {...}},
    "field_sqr_n": {...}}; `over_field_sqr_n_<w>` is a build's median ms
    over `hs_field_sqr_n`'s, the production field's rate over field12's."""
    x, y, x25 = field12_inputs(seed, max(widths), dev)
    cut = lambda t, w: t[:, :w].contiguous()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    runs = {}
    for w in widths:
        xw = cut(x, w)
        res = {name: torch.empty_like(xw) for name in kernels}
        for name, (sq, _) in kernels.items():
            runs[name, w] = lambda sq=sq, xw=xw, o=res[name], w=w: sq.launch(xw, o, chain, w)
            runs[name, w]()
        sync()
        for name, o in res.items():
            if not torch.equal(o, res["shipped"]):
                raise SystemExit(f"ladder_ab: {name}/{F12} differs from the shipped build at {w} lanes")
    a, b = cut(x, mul_width), cut(y, mul_width)
    res = {name: torch.empty_like(a) for name in kernels}
    for name, (_, mul) in kernels.items():
        mul.launch(a, b, res[name], mul_width)
    sync()
    for name, o in res.items():
        if not torch.equal(o, res["shipped"]):
            raise SystemExit(f"ladder_ab: {name}/{F12}_mul differs from the shipped build at {mul_width} lanes")
    for w in timed:
        xw, o = cut(x25, w), torch.empty_like(cut(x25, w))
        runs["field_sqr_n", w] = lambda xw=xw, o=o, w=w: sqr_n_kernel.launch(xw, o, chain, w)
    queued = collections.defaultdict(list)
    for _ in range(reps):
        for w in timed:
            for name in (*kernels, "field_sqr_n"):
                queued[name, w].append(queued_ms(runs[name, w], 20))
    out = {"builds": {name: {"limbs_equal_at": list(widths), "mul_equal_at": mul_width} for name in kernels},
           "field_sqr_n": {}}
    for w in timed:
        base = statistics.median(queued["field_sqr_n", w])
        out["field_sqr_n"][f"queued_ms_{w}"] = queued["field_sqr_n", w]
        for name in kernels:
            q = queued[name, w]
            out["builds"][name].update({f"queued_ms_{w}": q,
                                        f"over_field_sqr_n_{w}": statistics.median(q) / base if base else 0.0})
            print(f"{name} {F12} sqr_n(., {chain}) {w} lanes: queued {[round(v, 6) for v in q]} ms, "
                  f"{w * chain / statistics.median(q) / 1e3:.2f} M field-sqr/s; over hs_field_sqr_n "
                  f"{out['builds'][name][f'over_field_sqr_n_{w}']:.3f}", flush=True)
        print(f"field_sqr_n {w} lanes: queued {[round(v, 6) for v in queued['field_sqr_n', w]]} ms, "
              f"{w * chain / base / 1e3:.2f} M field-sqr/s", flush=True)
    return out


def chain_build(csrcs: dict[str, Path]) -> dict[str, Path]:
    """CHAIN_SOURCE compiled against each build's csrc directory (name ->
    directory), all in parallel; returns name -> library."""
    procs = {}
    for name, csrc in csrcs.items():
        out = _build.BUILD / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        src, lib, log = out / f"{CHAIN}.cu", out / f"lib{CHAIN}.so", out / f"{CHAIN}.log"
        src.write_text(CHAIN_SOURCE)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(src)]
        with open(log, "w") as fh:
            procs[name] = (lib, log, subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT))
    for name, (lib, log, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"ladder_ab: {name}/{CHAIN} failed to build:\n{log.read_text()}")
    return {name: lib for name, (lib, _, _) in procs.items()}


def chain_want(a: list[list[int]], b: list[int], on_field: bool, steps: int) -> list[list[int]]:
    """What `hs_mont_chain` gives on the ints a (chains x lanes) and b
    (lanes): a b^steps / R^steps mod p, or limb 0 through steps x
    CONTROL_OPS of v = v v + b mod 2^32 (the other limbs unchanged)."""
    if on_field:
        return [[x * pow(y * bls.R_INV, steps, bls.P) % bls.P for x, y in zip(row, b)] for row in a]
    out = []
    for row in a:
        lanes = []
        for x, y in zip(row, b):
            v, y0 = x & 0xFFFFFFFF, y & 0xFFFFFFFF
            for _ in range(steps * CONTROL_OPS):
                v = (v * v + y0) & 0xFFFFFFFF
            lanes.append(x - (x & 0xFFFFFFFF) + v)
        out.append(lanes)
    return out


def chain_ab(kernels: dict, reps: int, seed: int, dev, lanes: int, steps: int = CHAIN_STEPS,
             checked: int = 4) -> dict:
    """The carry-overlap leg of every build in turns (name -> `hs_mont_chain`
    kernel; "shipped" is this checkout's): at `lanes` lanes, the field
    chain and the control, one chain and two; every build's output equal
    to the shipped build's, the first `checked` lanes to `chain_want`.
    Returns {name: {"field"|"control": {ns_per_step_1, ns_per_step_2,
    two_over_one}}}."""
    rng = random.Random(seed)
    a_int = [[rng.randrange(bls.P) for _ in range(lanes)] for _ in range(2)]
    b_int = [rng.randrange(bls.P) for _ in range(lanes)]
    a = field.to_i32(torch.cat([bls.limbs_of_int(row) for row in a_int])).to(dev)
    b = field.to_i32(bls.limbs_of_int(b_int)).to(dev)
    out = {name: {} for name in kernels}
    for on_field in (True, False):
        leg = "field" if on_field else "control"
        runs, res = {}, {}
        for chains in (1, 2):
            want = chain_want([row[:checked] for row in a_int[:chains]], b_int[:checked], on_field, steps)
            for name, k in kernels.items():
                o = torch.empty((chains * bls.NLIMB, lanes), dtype=torch.int32, device=dev)
                runs[name, chains] = lambda k=k, o=o, c=chains, f=int(on_field): k.launch(a, b, o, c, f, steps, lanes)
                res[name, chains] = o
                runs[name, chains]()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            for name in kernels:
                got = res[name, chains].cpu()
                if not torch.equal(got, res["shipped", chains].cpu()):
                    raise SystemExit(f"ladder_ab: {name}/{CHAIN} ({leg}, {chains} chains) differs from the shipped "
                                     "build")
                ints = [bls.int_of_limbs(got[c * bls.NLIMB:(c + 1) * bls.NLIMB, :checked]) for c in range(chains)]
                if ints != want:
                    raise SystemExit(f"ladder_ab: {name}/{CHAIN} ({leg}, {chains} chains) differs from Python's ints")
        queued = collections.defaultdict(list)
        for _ in range(reps):
            for key, run in runs.items():
                queued[key].append(queued_ms(run, 5))
        for name in kernels:
            t1, t2 = (statistics.median(queued[name, c]) for c in (1, 2))
            out[name][leg] = dict(ns_per_step_1=[v * 1e6 / steps for v in queued[name, 1]],
                                  ns_per_step_2=[v * 1e6 / steps for v in queued[name, 2]],
                                  two_over_one=t2 / t1 if t1 else 0.0)
            print(f"{name} {CHAIN} {leg}, {lanes} lanes x {steps} steps: one chain "
                  f"{[round(v, 2) for v in out[name][leg]['ns_per_step_1']]} ns a step, two chains "
                  f"{[round(v, 2) for v in out[name][leg]['ns_per_step_2']]}; two over one "
                  f"{out[name][leg]['two_over_one']:.3f}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[], help="NAME=DIR: another checkout's csrc/")
    ap.add_argument("--reps", type=int, default=3, help="rounds of timing in turns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+", choices=SOURCES + BLS_KERNELS + (F12, CHAIN),
                    default=SOURCES + BLS_KERNELS + (F12, CHAIN),
                    help="legs to build, compare and time (K6's runs when g1_aggregate is named)")
    args = ap.parse_args()
    names = tuple(k for k in args.kernels if k != CHAIN)
    if not torch.cuda.is_available():
        raise SystemExit("ladder_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.build_all()
    builds = {"shipped": {src: (_build.build_dir() / f"lib{src}.so", _build.build_dir() / f"{src}.log")
                          for src in map(source_of, names)}}
    jobs = {}
    for spec in args.csrc:
        name, _, path = spec.partition("=")
        jobs[name] = Path(path).resolve()
    builds.update(build(jobs, names))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    report, kernels = {"card": card, "builds": {}}, {}
    for name, per_src in builds.items():
        report["builds"][name] = {}
        for src in names:
            lib, log = per_src[source_of(src)]
            ptxas = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            row = dict(ptxas=" | ".join(ptxas), spill_bytes=_build.spill_bytes("\n".join(ptxas)),
                       stack_bytes=_build.stack_bytes("\n".join(ptxas)), sass=sass_counts(lib, src))
            report["builds"][name][src] = row
            kernels[name, src] = _build.Kernel(src, source_of(src), lib=lib)
            print(f"{name} {src}: {row}", flush=True)

    ed_names = [src for src in names if src in SOURCES]
    x = inputs(args.seed, max(max(w) for w in (WIDTHS, *WIDTHS_OF.values())), dev) if ed_names else None
    for src in ed_names:
        for w in WIDTHS_OF.get(src, WIDTHS):
            runs = {name: runner(kernels[name, src], src, x, w) for name in builds}
            for _, _, run in runs.values():
                run()
            torch.cuda.synchronize()
            ref_out, ref_valid, _ = runs["shipped"]
            for name, (out, valid, _) in runs.items():
                if not torch.equal(out, ref_out) or (valid is not None and not torch.equal(valid, ref_valid)):
                    raise SystemExit(f"ladder_ab: {name}/{src} differs from the shipped build at {w} lanes")
            times, queued = collections.defaultdict(list), collections.defaultdict(list)
            for _ in range(args.reps):
                for name, (_, _, run) in runs.items():
                    times[name].append(events_ms(run, 20 if w <= 128 else 5))
                    queued[name].append(queued_ms(run, 20))
            for name, t in times.items():
                report["builds"][name][src][f"ms_{w}"] = t
                report["builds"][name][src][f"queued_ms_{w}"] = queued[name]
                print(f"{name} {src} {w} lanes: {[round(v, 4) for v in t]} ms, queued "
                      f"{[round(v, 4) for v in queued[name]]} ms", flush=True)
    if "g1_aggregate" in names:
        k6 = bls_ab(*bls_kernels({name: per_src["g1_aggregate"][0] for name, per_src in builds.items()}),
                    args.reps, args.seed, dev)
        for name, row in k6.items():
            report["builds"][name]["g1_aggregate"].update(row)
    if F12 in names:
        libs = {name: per_src[F12][0] for name, per_src in builds.items()}
        k8 = field12_ab({name: (_build.Kernel(F12, lib=lib), _build.Kernel("field12_mul", F12, lib=lib))
                         for name, lib in libs.items()}, _build.KERNELS["field_sqr_n"], args.reps, args.seed, dev)
        for name, row in k8["builds"].items():
            report["builds"][name][F12].update(row)
        report["field_sqr_n"] = k8["field_sqr_n"]
    if CHAIN in args.kernels:
        libs = chain_build({"shipped": _build.CSRC, **jobs})
        lanes = 32 * torch.cuda.get_device_properties(dev).multi_processor_count
        rows = chain_ab({name: _build.Kernel(CHAIN, lib=lib) for name, lib in libs.items()}, args.reps,
                        args.seed, dev, lanes)
        for name, row in rows.items():
            report["builds"].setdefault(name, {})[CHAIN] = row
    print(f"card: {card}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
