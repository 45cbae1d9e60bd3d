"""The port's device tuning tool: the microbenchmarks of the reference's
`tools/tune_device.py` on the port's kernels, in one process.

    python3 -m hotstuff_tpu_torch.tune_device [--all] [--vpu] [--field] [--phases] [--chunks] [--dh]
                                              [--cpu] [--lanes N] [--reps N] [--chain N]

Each leg prints under the reference's output prefix, so that the two
outputs lie side by side:
  --vpu     `vpu`: three elementwise chains of 64 steps on (64, 4,096)
            elements, each one launch of `ops/csrc/alu_chain.cu` (f32 x*x + 1,
            i32 x*x + 1, u32 xor/shift/add), in T op/s at 2 operations a
            step, as the reference counts them;
  --field   `field`: a chain of 64 squarings on 4,096 lanes in one launch,
            on the port's production field (`int32 radix-2^25.5`,
            `ops/csrc/field_sqr_n.cu`, in the reference's `f32 radix-256`
            row) and on the radix-2^12 field (`u32 radix-2^12`, kernel K8
            `hs_field12`, each lane's products split over four warps of a
            block), in M field-sqr/s with the device ms of one call;
            both rows must equal v^(2^64) mod p on every lane (K8's through
            its `canonical`);
  --phases  `phase`: the verify kernels on one 4,096-lane device-hash chunk
            (K3 decompress+table, K1 ladder, K4 compress, K2 sha512+modL,
            and `verify_packed128_dh` whole); the reference's separate
            `decompress` row is fused into K3 and not timed apart;
  --chunks  `chunk`: the verifier end to end on 16,384 signatures at the
            reference's four (chunk, max_bucket) pairs; every mask must be
            all True;
  --dh      `dh-compare`: host-hash against device-hash staging, upload
            and kernels, serially, on 4,096 lanes.

Kernel legs report device time with the launches queued behind a spin
kernel (`breakdown.queued_ms`); `--chunks` and `--dh` the host clock.
`--cpu` runs every leg on the CPU through the plain versions, host clock
only; without a CUDA device and without `--cpu` the tool exits non-zero.
`--lanes`, `--reps` and `--chain` cut every leg's width, repetitions and
chain length (the reference's sizes are the defaults). The first line names
the card and its power limit; the last lists the kernel launches of the
run. The signatures are 4,096 distinct ones over 32-byte messages, tiled,
signed through OpenSSL where `cryptography` imports, else by the port's
pure-Python signer in a process pool.
"""

from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import _build, ladder, sha512
from .ops import ed25519 as ed
from .ops import field as f
from .ops import field12 as f12
from .ops.verifier import Ed25519TorchVerifier

VPU_SHAPE = (64, 4096)
CHUNK_PAIRS = ((2048, 8192), (4096, 8192), (8192, 8192), (16384, 16384))
DISTINCT = 4096  # distinct signatures of the corpus, tiled to a leg's batch
ALU_OPS = {0: ("f32 mul+add", torch.float32), 1: ("i32 mul+add", torch.int32), 2: ("u32 xor/shift/add", torch.int32)}
U32 = 0xFFFFFFFF


def fail(msg: str) -> None:
    raise SystemExit(f"tune_device: FAIL: {msg}")


# --- the --vpu chains --------------------------------------------------------


def alu_chain_plain(x: torch.Tensor, op: int, n: int) -> torch.Tensor:
    """n steps of chain `op` (see `csrc/alu_chain.cu`): f32 x*x + 1.0 as two
    rounded operations; i32 x*x + 1 wrapped to int32 (computed on int64);
    u32 (x ^ (x >> 7)) + (x << 3) on int32 bits."""
    if op == 0:
        for _ in range(n):
            x = x * x + 1.0
        return x
    v = f.from_i32(x)
    for _ in range(n):
        v = (v * v + 1 if op == 1 else (v ^ (v >> 7)) + (v << 3)) & U32
    return f.to_i32(v)


def alu_chain(x: torch.Tensor, op: int, n: int) -> torch.Tensor:
    """`hs_alu_chain`, all n steps in one launch: CPU tensors ->
    `alu_chain_plain`; CUDA tensors -> `csrc/alu_chain.cu`. x is float32
    for op 0, int32 (the bits) for ops 1 and 2."""
    if x.device.type == "cpu":
        return alu_chain_plain(x, op, n)
    _build.check(x, tuple(x.shape), ALU_OPS[op][1], x.device)
    out = torch.empty_like(x)
    _build.KERNELS["alu_chain"].launch(x, out, op, n, x.numel())
    return out


# --- timing and corpus -------------------------------------------------------


def _ms(fn, reps: int, dev: torch.device) -> float:
    """Mean ms a call: device time with the launches queued on the card;
    host clock over `reps` calls on the CPU."""
    if dev.type == "cuda":
        from .breakdown import queued_ms

        return queued_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _pysign(args: tuple[bytes, bytes]) -> tuple[bytes, bytes]:
    from .crypto import pysigner

    seed, msg = args
    pk, _ = pysigner.keypair_from_seed(seed)
    return pk, pysigner.sign(seed, msg, public_key=pk)


@functools.lru_cache(maxsize=4)
def _signed(n: int, seed: int) -> tuple[tuple, tuple, tuple]:
    """n distinct (message, key, signature) triples, key i signing message i."""
    rng = np.random.default_rng(seed)
    seeds = [bytes(r) for r in rng.integers(0, 256, (n, 32), np.uint8)]
    msgs = [bytes(r) for r in rng.integers(0, 256, (n, 32), np.uint8)]
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
        from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat
    except ImportError:
        with multiprocessing.get_context("spawn").Pool(min(8, os.cpu_count() or 1, n)) as pool:
            pairs = pool.map(_pysign, list(zip(seeds, msgs)), chunksize=64)
    else:
        pairs = []
        for s, m in zip(seeds, msgs):
            sk = Ed25519PrivateKey.from_private_bytes(s)
            pairs.append((sk.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw), sk.sign(m)))
    return tuple(msgs), tuple(p for p, _ in pairs), tuple(g for _, g in pairs)


def corpus(batch: int, seed: int = 0) -> tuple[list, list, list]:
    """`batch` triples: min(batch, DISTINCT) distinct ones, tiled."""
    msgs, pks, sigs = _signed(min(batch, DISTINCT), seed)
    reps = -(-batch // len(msgs))
    return [list(t * reps)[:batch] for t in (msgs, pks, sigs)]


# --- the legs ------------------------------------------------------------------


def bench_vpu(dev: torch.device, shape: tuple = VPU_SHAPE, chain: int = 64, reps: int = 20) -> dict:
    """The reference's three chains (tools/tune_device.py:41-56), each in one
    launch; T op/s at 2 operations a step and element."""
    out = {}
    for op, (name, dtype) in ALU_OPS.items():
        x = (torch.full(shape, 1.0001, dtype=dtype) if op == 0 else torch.full(shape, 3, dtype=dtype)).to(dev)
        ms = _ms(lambda: alu_chain(x, op, chain), reps, dev)
        ops = chain * 2 * x.numel()
        out[name] = ops / (ms / 1e3) / 1e12
        print(f"vpu {name:<20} {out[name]:8.3f} T op/s  ({ms:.6f} ms a launch, {_clock(dev)})", flush=True)
    return out


def bench_field(dev: torch.device, batch: int = 4096, chain: int = 64, reps: int = 10) -> dict:
    """A chain of `chain` squarings on `batch` lanes in one launch, on both
    fields (the reference's `bench_field`, :72-108), in M field-sqr/s;
    both results held against v^(2^chain) mod p on every lane."""
    rng = random.Random(5)
    vals = [rng.randrange(f.P) for _ in range(batch)]
    want = [pow(v, 1 << chain, f.P) for v in vals]
    x25 = f.limbs_of_int(vals).to(torch.int32).to(dev)
    x12 = f12.tensor_of_ints(vals, dev)
    rows = (("int32 radix-2^25.5", lambda: f.sqr_chain(x25, chain), f.canonical, f.int_of_limbs),
            ("u32 radix-2^12", lambda: f12.sqr_n(x12, chain), f12.canonical, f12.int_of_limbs))
    out = {}
    for name, run, canon, values in rows:
        if values(canon(run())) != want:
            fail(f"field {name}: the chain of {chain} squarings differs from v^(2^{chain}) mod p")
        ms = _ms(run, reps, dev)
        out[name] = dict(ms=ms, rate=batch * chain / (ms / 1e3))
        print(f"field {name:<18} {out[name]['rate'] / 1e6:8.2f} M field-sqr/s  ({ms:.6f} ms a call, "
              f"{_clock(dev)})", flush=True)
    print(f"field check: both rows equal v^(2^{chain}) mod p on all {batch} lanes", flush=True)
    return out


def bench_phases(dev: torch.device, batch: int = 4096, reps: int = 5) -> dict:
    """The verify kernels on one device-hash chunk (the reference's
    `bench_phases`, :111-171, on K3, K1, K4, K2 and the whole chunk)."""
    msgs, pks, sigs = corpus(batch)
    staged = ed.prepare_batch_packed_dh(msgs, pks, sigs)
    packed = torch.from_numpy(staged["packed"]).to(dev)
    a, r, s_b, m = ed.split_packed128(packed)
    s_d = sha512.nibble_rows(s_b)
    h_d = sha512.h_digits(r, a, m)
    table, valid = ed.decompress_table(a)
    point = ladder.ladder(s_d, h_d, table)
    mask = ladder.verify_packed128_dh(packed).cpu().numpy()
    if not mask.all():
        fail(f"phases: {int((~mask).sum())} of {batch} valid signatures rejected")
    print("phase decompress         fused into K3, not timed apart", flush=True)
    out = {}
    for name, fn in (("decompress+table", lambda: ed.decompress_table(a)),
                     ("ladder", lambda: ladder.ladder(s_d, h_d, table)),
                     ("compress", lambda: ed.compress_eq(point, r, valid)),
                     ("sha512+modL (dh)", lambda: sha512.h_digits(r, a, m)),
                     ("full verify", lambda: ladder.verify_packed128_dh(packed))):
        out[name] = ms = _ms(fn, reps, dev)
        print(f"phase {name:<18} {ms:10.4f} ms  {batch / (ms / 1e3):>12,.0f}/s  ({_clock(dev)})", flush=True)
    return out


def bench_chunks(dev: torch.device, batch: int = 16384, iters: int = 3, kernel: str = "pallas",
                 pairs: tuple = CHUNK_PAIRS) -> dict:
    """The verifier end to end at each (chunk, max_bucket) pair (the
    reference's `bench_chunks`, :174-194); host clock."""
    msgs, pks, sigs = corpus(batch)
    out = {}
    for chunk, bucket in pairs:
        v = Ed25519TorchVerifier(device=dev, max_bucket=bucket, kernel=kernel, chunk=chunk)
        try:
            if not v.verify_batch_mask(msgs, pks, sigs).all():
                fail(f"chunk {chunk} (bucket {bucket}): a valid signature was rejected")
            t0 = time.perf_counter()
            for _ in range(iters):
                v.verify_batch_mask(msgs, pks, sigs)
            out[(chunk, bucket)] = rate = batch * iters / (time.perf_counter() - t0)
        finally:
            v.close()
        print(f"chunk {chunk:>5} (bucket {bucket:>5})  e2e {rate:>10,.0f} sigs/s", flush=True)
    return out


def bench_dh(dev: torch.device, batch: int = 4096, iters: int = 4) -> dict:
    """Host-hash against device-hash staging + upload + kernels on the same
    lanes, serially (the reference's `bench_dh`, :197-227); host clock."""
    msgs, pks, sigs = corpus(batch)
    out = {}
    for name, stage, fn in (("host-hash", ed.prepare_batch_packed, ladder.verify_packed128),
                            ("device-hash", ed.prepare_batch_packed_dh, ladder.verify_packed128_dh)):
        staged = stage(msgs, pks, sigs)
        if not fn(torch.from_numpy(ed._pad(staged["packed"], batch)).to(dev)).cpu().numpy().all():
            fail(f"dh-compare {name}: a valid signature was rejected")
        t0 = time.perf_counter()
        for _ in range(iters):
            s = stage(msgs, pks, sigs)
            mask = fn(torch.from_numpy(ed._pad(s["packed"], batch)).to(dev))
        mask.cpu()
        out[name] = rate = batch * iters / (time.perf_counter() - t0)
        print(f"dh-compare {name:<12} {rate:>10,.0f} sigs/s (serial, no pipeline)", flush=True)
    return out


# --- entry point -----------------------------------------------------------------


def _clock(dev: torch.device) -> str:
    return "device time" if dev.type == "cuda" else "host clock, CPU"


def devices_line(dev: torch.device) -> str:
    if dev.type == "cpu":
        return "# devices: cpu (--cpu: the plain PyTorch versions, host clock)"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return f"# devices: {card} ({torch.cuda.device_count()} visible; this tool uses {dev})"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for flag in ("all", "vpu", "field", "phases", "chunks", "dh", "cpu"):
        ap.add_argument(f"--{flag}", action="store_true")
    ap.add_argument("--lanes", type=int, default=None, help="cut every leg's lanes to N")
    ap.add_argument("--reps", type=int, default=None, help="repetitions (iterations) of every leg")
    ap.add_argument("--chain", type=int, default=None, help="steps of the --vpu and --field chains")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("tune_device: no CUDA device is available; pass --cpu to run the plain versions on the CPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    print(devices_line(dev), flush=True)
    lanes = lambda default: min(default, args.lanes) if args.lanes else default
    reps = lambda default: args.reps or default
    chain = args.chain or 64
    if args.all or args.vpu:
        bench_vpu(dev, (VPU_SHAPE[0], lanes(VPU_SHAPE[1])), chain, reps(20))
    if args.all or args.field:
        bench_field(dev, lanes(4096), chain, reps(10))
    if args.all or args.phases:
        bench_phases(dev, lanes(4096), reps(5))
    kernel = "w4" if args.cpu else "pallas"
    if args.all or args.chunks:
        pairs = tuple(dict.fromkeys((lanes(c), lanes(b)) for c, b in CHUNK_PAIRS))
        bench_chunks(dev, lanes(16384), reps(3), kernel, pairs)
    if args.all or args.dh:
        bench_dh(dev, lanes(4096), reps(4))
    print(f"# launches: {json.dumps({k: n for k, n in _build.launches().items() if n})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
