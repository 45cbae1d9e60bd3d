"""The ladder kernels (K1 `ladder`, K5 `committee_ladder`, K7
`bit_ladder`), K3 `decompress_table`, K4 `compress_eq`, K2 `h_digits` and
K2g `h_digits_idx` of this checkout beside the same kernels of other
checkouts, on one card.

    python3 -m hotstuff_tpu_torch.ladder_ab [--csrc NAME=DIR ...] [--reps 3]

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
Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from .breakdown import events_ms, queued_ms
from .crypto import pysigner
from .ops import _build
from .ops import ed25519 as ed
from .ops import field, ladder

SOURCES = ("ladder", "committee_ladder", "decompress_table", "compress_eq", "h_digits", "h_digits_idx",
           "bit_ladder")
# Kernels counted over their whole function (no loop once unrolled): the
# cuobjdump function names of this checkout's build and of earlier ones.
WHOLE_FUNCTION = {
    "h_digits": r"h_digits_kernel(ILb0E|P)",
    "h_digits_idx": r"h_digits_(idx_kernel|kernelILb1E)",
}
WIDTHS = (128, 4096)
WIDTHS_OF = {"bit_ladder": (128, 4096, 8192)}  # K7 also at the f32 path's piece
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_FUNCTION = re.compile(r"Function : (\S+)")


def source_of(kernel: str) -> str:
    return _build.EXTRA_ENTRY_POINTS.get(kernel, kernel)


def build(jobs: dict[str, Path]) -> dict:
    """Build the sources of SOURCES of every job (name -> csrc directory),
    all in parallel; returns {name: {source: (library, ptxas log)}}."""
    procs = {}
    for name, csrc in jobs.items():
        out = _build.BUILD / "ab" / name
        out.mkdir(parents=True, exist_ok=True)
        for src in dict.fromkeys(map(source_of, SOURCES)):
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


def sass_counts(lib: Path, kernel: str) -> dict:
    """SASS instructions counted by opcode (before the first '.'), plus
    `total` and the library's static count `all`. For a kernel of
    WHOLE_FUNCTION, every instruction of its function; otherwise those of
    the library's longest backward branch (a `#pragma unroll 1` loop: a
    ladder's group loop, K4's squaring loop, K3's entry loop)."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    insns = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in _INSN.finditer(sass)]
    if kernel in WHOLE_FUNCTION:
        mine = [sec for sec in re.split(r"(?=Function : )", sass)
                if (f := _FUNCTION.match(sec)) and re.search(WHOLE_FUNCTION[kernel], f.group(1))]
        if len(mine) != 1:
            raise SystemExit(f"ladder_ab: {len(mine)} SASS functions of {kernel} in {lib}")
        counts = collections.Counter(m.group(3).split(".")[0] for m in _INSN.finditer(mine[0]))
        return dict(counts.most_common(), total=sum(counts.values()), all=len(insns))
    lo, hi = 0, -1
    for addr, op, args in insns:
        t = _TARGET.search(args) if op.startswith("BRA") else None
        if t and int(t.group(1), 16) < addr and addr - int(t.group(1), 16) > hi - lo:
            lo, hi = int(t.group(1), 16), addr
    counts = collections.Counter(op.split(".")[0] for addr, op, _ in insns if lo <= addr <= hi)
    return dict(counts.most_common(), total=sum(counts.values()), all=len(insns))


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[], help="NAME=DIR: another checkout's csrc/")
    ap.add_argument("--reps", type=int, default=3, help="rounds of timing in turns")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ladder_ab: no CUDA device")
    dev = torch.device("cuda")
    _build.build_all()
    builds = {"shipped": {src: (_build.build_dir() / f"lib{src}.so", _build.build_dir() / f"{src}.log")
                          for src in map(source_of, SOURCES)}}
    jobs = {}
    for spec in args.csrc:
        name, _, path = spec.partition("=")
        jobs[name] = Path(path).resolve()
    builds.update(build(jobs))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    report, kernels = {"card": card, "builds": {}}, {}
    for name, per_src in builds.items():
        report["builds"][name] = {}
        for src in SOURCES:
            lib, log = per_src[source_of(src)]
            ptxas = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            row = dict(ptxas=" | ".join(ptxas), spill_bytes=_build.spill_bytes("\n".join(ptxas)),
                       sass=sass_counts(lib, src))
            report["builds"][name][src] = row
            kernels[name, src] = _build.Kernel(src, source_of(src), lib=lib)
            print(f"{name} {src}: {row}", flush=True)

    x = inputs(args.seed, max(max(w) for w in (WIDTHS, *WIDTHS_OF.values())), dev)
    for src in SOURCES:
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
    print(f"card: {card}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
