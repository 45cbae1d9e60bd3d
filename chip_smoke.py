#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`hotstuff_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and no phase's exception is
caught:
  1. the card line (`nvidia-smi` name, power limit), then build every CUDA
     kernel from `hotstuff_tpu_torch/ops/csrc/` (nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the same CUDA tensors
     at 4,096 lanes, exactly (integer outputs, tolerance 0);
  3. the main path: `TorchBackend(device="cuda").verify_batch_mask` on a
     16,384-signature batch (4,096 distinct pysigner signatures over 32-byte
     digests, tiled, ~1/16 of lanes corrupted), chunk 4,096, max_bucket
     8,192; then one host-hash batch (33-byte messages and the RFC 8032
     vectors). Masks must equal the expected masks, which the exact host
     verifier cross-checks;
  4. launch counts of the main path, end-to-end rate, per-kernel times
     beside the plain versions' and the least time the card could take.
The last line is `{"ok": true, "device": {...}}`. Imports nothing of JAX
or of `hotstuff_tpu`. Exits non-zero without a result when no CUDA device
is available or the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
LANES = 4096
BATCH = 16384
CHUNK = 4096
MAX_BUCKET = 8192

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 3.35 TB/s;
# INT32 issue 64 lanes/clk/SM x 132 SMs x 1.98 GHz boost. A field product
# is one 32x32->64 IMAD.WIDE, counted as one INT32 operation: the least
# issue work, so `bound_ms` is a floor.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# K2's integer operations per lane, counted from csrc/h_digits.cu: 64
# schedule words x 13 64-bit ops and 80 rounds x 24 64-bit ops, two INT32
# operations per 64-bit op; TweetNaCl modL, 32 x 20 64-bit multiply-adds.
H_DIGITS_OPS_PER_LANE = 2 * (64 * 13 + 80 * 24) + 2 * 32 * 20

RFC8032_VECTORS = [  # (public key, message, signature), RFC 8032 section 7.1
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# --- corpus workers (spawned processes: picklable top-level functions) ------


def _sign_one(args: tuple[bytes, bytes]) -> tuple[bytes, bytes]:
    from hotstuff_tpu_torch.crypto import pysigner

    seed, msg = args
    pk, _ = pysigner.keypair_from_seed(seed)
    return pk, pysigner.sign(seed, msg, public_key=pk)


def _verify_one(args: tuple[bytes, bytes, bytes]) -> bool:
    from hotstuff_tpu_torch.crypto import pysigner

    return pysigner.verify(*args)


# --- phase 1 -----------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def phase_build() -> float:
    from hotstuff_tpu_torch.ops import _build

    secs = _build.build_all()
    print(f"build: {secs:.1f} s ({_build.build_dir()})", flush=True)
    for name, line in _build.ptxas_report().items():
        print(f"ptxas {name}: {line}", flush=True)
    return secs


# --- phase 2: kernels against their plain versions ---------------------------


def _plain_ms(fn) -> tuple[float, object]:
    """One timed call of a plain version (its first call is the one that
    the comparison uses), CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _max_abs(a, b) -> int:
    return (a.long() - b.long()).abs().max().item()


def _bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _special_keys():
    """Key encodings the decompression must get right: y >= p, x = 0 with
    the sign bit set, y = 0 and y = 1, the all-ones encoding."""
    p = 2**255 - 19
    encs = [p, p + 1, p + 18, 1 | (1 << 255), 1, 0, (p - 1) | (1 << 255), 2**256 - 1]
    return [e.to_bytes(32, "little") for e in encs]


def phase_compare(seed: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.breakdown import events_ms
    from hotstuff_tpu_torch.ops import field, ladder, sha512
    from hotstuff_tpu_torch.ops import ed25519 as ed

    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    rows = lambda n: torch.from_numpy(rng.integers(0, 256, (n, LANES), np.uint8)).to(dev)
    results = {}

    # K2: h digits on random R / A / M rows; a sample against hashlib.
    r, a, m = rows(32), rows(32), rows(32)
    hd_full = sha512.h_digits(r, a, m)
    plain_ms, want = _plain_ms(lambda: sha512.h_digits_plain(r, a, m))
    if not torch.equal(hd_full, want):
        fail("K2 h_digits differs from its plain version")
    rh, ah, mh = (t.T.cpu().numpy() for t in (r, a, m))
    for i in range(0, LANES, 257):
        hv = int.from_bytes(hashlib.sha512(rh[i].tobytes() + ah[i].tobytes() + mh[i].tobytes()).digest(), "little") % ed.L_ORDER
        digits = [(hv >> (4 * d)) & 15 for d in range(64)]
        if hd_full[:, i].tolist() != digits:
            fail(f"K2 h_digits lane {i} differs from hashlib")
    results["h_digits"] = dict(
        ms=events_ms(lambda: sha512.h_digits(r, a, m), 20), plain_ms=plain_ms,
        max_abs_err=_max_abs(hd_full, want),
        bytes=LANES * (96 + 64), ops=LANES * H_DIGITS_OPS_PER_LANE,
    )

    # K3: random keys (about half decompress) and the special encodings.
    keys = rows(32)
    special = _special_keys()
    for i, enc in enumerate(special):
        keys[:, i] = torch.tensor(list(enc), dtype=torch.uint8, device=dev)
    table, valid = ed.decompress_table(keys)
    field.PRODUCTS.n = 0
    plain_ms, (ptable, pvalid) = _plain_ms(lambda: ed.decompress_table_plain(keys))
    products = field.PRODUCTS.n
    if not torch.equal(valid, pvalid):
        fail("K3 validity mask differs from its plain version")
    canon = lambda t: field.canonical(t.reshape(4 * 16, field.NL, LANES).permute(1, 0, 2).reshape(field.NL, -1))
    err = _max_abs(canon(table), canon(ptable))
    if err != 0:
        fail(f"K3 table differs from its plain version (max |diff| {err})")
    print(f"K3: {int(valid.sum())}/{LANES} random+special keys decompress; "
          f"raw limbs identical: {torch.equal(table, ptable)}", flush=True)
    results["decompress_table"] = dict(
        ms=events_ms(lambda: ed.decompress_table(keys), 20), plain_ms=plain_ms, max_abs_err=err,
        bytes=LANES * (32 + 4 * 16 * field.NL * 4 + 1), ops=LANES * products,
    )

    # K1: random digits with K3's tables.
    sd = torch.from_numpy(rng.integers(0, 16, (64, LANES), np.uint8)).to(dev)
    hd = torch.from_numpy(rng.integers(0, 16, (64, LANES), np.uint8)).to(dev)
    point = ladder.ladder(sd, hd, table)
    field.PRODUCTS.n = 0
    plain_ms, ppoint = _plain_ms(lambda: ladder.ladder_plain(sd, hd, table))
    products = field.PRODUCTS.n
    enc_k, enc_p = ed.compress(point), ed.compress(ppoint)
    err = _max_abs(enc_k, enc_p)
    if err != 0:
        fail(f"K1 ladder differs from its plain version (max |diff| {err})")
    print(f"K1: raw limbs identical: {torch.equal(point, ppoint)}", flush=True)
    results["ladder"] = dict(
        ms=events_ms(lambda: ladder.ladder(sd, hd, table), 5), plain_ms=plain_ms, max_abs_err=err,
        bytes=LANES * (2 * 64 + 4 * 16 * field.NL * 4 + 4 * field.NL * 4) + 3 * 16 * field.NL * 4,
        ops=LANES * products,
    )

    # K4: K1's points against R rows that match on every other lane.
    r_bytes = rows(32)
    r_bytes[:, ::2] = enc_p[:, ::2]
    got = ed.compress_eq(point, r_bytes, valid)
    field.PRODUCTS.n = 0
    plain_ms, want = _plain_ms(lambda: ed.compress_eq_plain(point, r_bytes, valid))
    products = field.PRODUCTS.n
    if not torch.equal(got, want):
        fail("K4 compress_eq differs from its plain version")
    if int(got.sum()) == 0:
        fail("K4 matched no lane")
    results["compress_eq"] = dict(
        ms=events_ms(lambda: ed.compress_eq(point, r_bytes, valid), 20), plain_ms=plain_ms,
        max_abs_err=_max_abs(got, want), bytes=LANES * (3 * field.NL * 4 + 32 + 1 + 1),
        ops=LANES * products,
    )
    # A ragged width (not a multiple of any block size) through every kernel:
    # each lane is independent, so it must equal the full run's first lanes.
    w = 1000
    cut = lambda t: t[..., :w].contiguous()
    if not torch.equal(sha512.h_digits(cut(r), cut(a), cut(m)), cut(hd_full)):
        fail("K2 differs at a ragged width")
    rt, rv = ed.decompress_table(cut(keys))
    if not (torch.equal(rt, cut(table)) and torch.equal(rv, cut(valid))):
        fail("K3 differs at a ragged width")
    if not torch.equal(ladder.ladder(cut(sd), cut(hd), rt), cut(point)):
        fail("K1 differs at a ragged width")
    if not torch.equal(ed.compress_eq(cut(point), cut(r_bytes), cut(valid)), cut(got)):
        fail("K4 differs at a ragged width")
    for name, res in results.items():
        res["bound_ms"], res["bound_by"] = _bound_ms(res["bytes"], res["ops"])
        print(f"{name}: kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.1f} ms, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) per {LANES}-lane call", flush=True)
    return results


# --- phase 3: the main path --------------------------------------------------


def _corpus(seed: int, pool):
    """4,096 distinct (message, key, signature) over 32-byte digests."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    seeds = [bytes(row) for row in rng.integers(0, 256, (LANES, 32), np.uint8)]
    msgs = [bytes(row) for row in rng.integers(0, 256, (LANES, 32), np.uint8)]
    signed = pool.map(_sign_one, list(zip(seeds, msgs)), chunksize=64)
    return msgs, [k for k, _ in signed], [s for _, s in signed]


def _bad_key() -> bytes:
    """An encoding whose y has no x on the curve (no square root)."""
    from hotstuff_tpu_torch.crypto import pysigner

    y = 2
    while pysigner._recover_x(y, 0) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _corrupt(seed: int, msgs, keys, sigs):
    """Tile to BATCH lanes and corrupt a seeded ~1/16 of them, one class
    per lane in turn. Returns (msgs, keys, sigs, expected mask)."""
    import numpy as np

    from hotstuff_tpu_torch.crypto import pysigner

    rng = np.random.default_rng(seed + 2)
    M = [msgs[i % LANES] for i in range(BATCH)]
    K = [keys[i % LANES] for i in range(BATCH)]
    S = [sigs[i % LANES] for i in range(BATCH)]
    expected = np.ones(BATCH, bool)
    bad_key = _bad_key()
    noncanon_r = (pysigner.P + 1).to_bytes(32, "little")
    lanes = np.sort(rng.choice(BATCH, BATCH // 16, replace=False))
    for n, i in enumerate(lanes):
        kind = n % 6
        s = S[i]
        if kind == 0:  # flipped R byte
            S[i] = s[:5] + bytes([s[5] ^ 0x40]) + s[6:]
        elif kind == 1:  # flipped S byte
            S[i] = s[:40] + bytes([s[40] ^ 0x01]) + s[41:]
        elif kind == 2:  # s >= L (s + L, same residue)
            sv = int.from_bytes(s[32:], "little") + pysigner.L
            S[i] = s[:32] + sv.to_bytes(32, "little")
        elif kind == 3:  # wrong message
            M[i] = bytes([M[i][0] ^ 0x80]) + M[i][1:]
        elif kind == 4:  # non-decompressable key
            K[i] = bad_key
        else:  # non-canonical R (y = p + 1)
            S[i] = noncanon_r + s[32:]
        expected[i] = False
    return M, K, S, expected, lanes


def _host_hash_batch(pool):
    """33-byte messages signed by pysigner, the RFC 8032 vectors, and the
    vectors perturbed. Returns (msgs, keys, sigs, expected mask)."""
    import numpy as np

    rng = np.random.default_rng(7)
    seeds = [bytes(row) for row in rng.integers(0, 256, (60, 32), np.uint8)]
    msgs = [bytes(row) for row in rng.integers(0, 256, (60, 33), np.uint8)]
    signed = pool.map(_sign_one, list(zip(seeds, msgs)))
    M, K, S = list(msgs), [k for k, _ in signed], [s for _, s in signed]
    expected = [True] * len(M)
    for i in range(0, len(M), 5):  # every fifth lane: flipped message byte
        M[i] = M[i][:-1] + bytes([M[i][-1] ^ 1])
        expected[i] = False
    for pk, msg, sig in RFC8032_VECTORS:
        M.append(bytes.fromhex(msg))
        K.append(bytes.fromhex(pk))
        S.append(bytes.fromhex(sig))
        expected.append(True)
        M.append(bytes.fromhex(msg) + b"\x00")
        K.append(bytes.fromhex(pk))
        S.append(bytes.fromhex(sig))
        expected.append(False)
    return M, K, S, np.array(expected)


def phase_main_path(seed: int) -> dict:
    import numpy as np
    import torch

    from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
    from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
    from hotstuff_tpu_torch.ops import _build

    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    with ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        msgs, keys, sigs = _corpus(seed, pool)
        M, K, S, expected, lanes = _corrupt(seed, msgs, keys, sigs)
        # Cross-check the expected mask with the exact host verifier on every
        # distinct triple: the 4,096 signatures and each corrupted lane.
        check = list(range(LANES)) + [int(i) for i in lanes]
        host = pool.map(_verify_one, [(K[i], M[i], S[i]) for i in check], chunksize=64)
        if [bool(v) for v in host] != [bool(expected[i]) for i in check]:
            fail("expected mask disagrees with the host verifier")
        HM, HK, HS, hexpected = _host_hash_batch(pool)
        hhost = pool.map(_verify_one, list(zip(HK, HM, HS)))
        if list(hhost) != hexpected.tolist():
            fail("host-hash expected mask disagrees with the host verifier")
    print(f"corpus: {LANES} signatures, {len(lanes)} corrupted lanes, host cross-check "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    backend = TorchBackend(device="cuda", crossover=1, max_bucket=MAX_BUCKET, chunk=CHUNK)
    pks, sgs = [PublicKey(k) for k in K], [Signature(s) for s in S]
    _build.reset_launches()
    mask = backend.verify_batch_mask(M, pks, sgs)
    launches = _build.launches()
    print(f"main path launches: {launches}", flush=True)
    if np.array(mask).tolist() != expected.tolist():
        bad = np.flatnonzero(np.array(mask) != expected)
        fail(f"main-path mask differs from expected on {len(bad)} lanes, e.g. {bad[:8].tolist()}")
    if any(v == 0 for v in launches.values()):
        fail(f"a kernel of the main path was not launched: {launches}")
    if backend.stats["host_sigs"] != 0:
        fail(f"lanes verified on the host: {backend.stats}")

    iters, times = 5, []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        again = backend.verify_batch_mask(M, pks, sgs)
        end.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0, start.elapsed_time(end) / 1e3))
        if again != mask:
            fail("main-path mask changed between iterations")
    wall = [w for w, _ in times]
    print(f"e2e: {BATCH} signatures per batch, {iters} batches: "
          f"{BATCH * iters / sum(wall):.1f} sigs/s (host clock), "
          f"per batch {[round(w * 1e3, 3) for w in wall]} ms", flush=True)

    _build.reset_launches()
    hmask = backend.verify_batch_mask(HM, [PublicKey(k) for k in HK], [Signature(s) for s in HS])
    hlaunches = _build.launches()
    print(f"host-hash batch launches: {hlaunches}", flush=True)
    if hmask != hexpected.tolist():
        fail("host-hash mask differs from expected")
    if hlaunches["h_digits"] != 0 or any(hlaunches[k] == 0 for k in ("ladder", "decompress_table", "compress_eq")):
        fail(f"host-hash batch launched the wrong kernels: {hlaunches}")
    return dict(launches=launches, sigs_per_s=BATCH * iters / sum(wall), batch_ms=[w * 1e3 for w in wall])


REPLACES = {
    "ladder": "hotstuff_tpu/ops/pallas_ladder.py:144",
    "h_digits": "hotstuff_tpu/ops/sha512.py:448",
    "decompress_table": "hotstuff_tpu/ops/ed25519.py:561",
    "compress_eq": "hotstuff_tpu/ops/ed25519.py:591",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "hotstuff_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the hotstuff_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    phase_build()
    kernels = phase_compare(args.seed)
    main_path = phase_main_path(args.seed)

    rows = []
    for name, res in kernels.items():
        rows.append(dict(
            name=name, route="cuda", source=f"hotstuff_tpu_torch/ops/csrc/{name}.cu",
            replaces=REPLACES[name], launches=main_path["launches"][name],
            matches_plain=res["max_abs_err"] == 0, max_abs_err=res["max_abs_err"],
            ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound_ms"],
            bound_by=res["bound_by"], library_ms=None,
        ))
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
