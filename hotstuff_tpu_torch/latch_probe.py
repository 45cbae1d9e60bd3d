"""Probe the device-hash latch of the port's verifier.

    python -m hotstuff_tpu_torch.latch_probe [--device cuda|cpu] [--lanes N]

The port's counterpart of `tools/latch_probe.py`. `Ed25519TorchVerifier`
hashes SHA-512 and reduces mod L on the device (kernel K2) when every
message is a 32-byte digest. What a K2 failure does depends on where the
verifier runs (`ops/verifier.py` `_with_latch`): on the CPU the batch is
redone with host hashing and the device hash is latched off for the life
of the verifier; on the card the failure propagates and nothing latches.
This tool runs the three scenarios against a live verifier and records
what happened:

  1. organic   — `--lanes` 32-byte-digest signatures, clean and with every
                 3rd signature corrupted, plus lanes / 2 of random keys and
                 signatures, through the device-hash path. Every mask must
                 equal the one known by construction, K2 must never fail
                 (`device_hash_fallbacks` stays 0, the latch stays on), and
                 on the card K2's launch count must rise.
  2. forced    — `ladder.verify_packed128_dh` (K2 and the generic kernels
                 behind it) made to raise. On the card the error must
                 propagate with the latch on; on the CPU the batch must
                 return the right mask through the host-hash retry and the
                 latch must end off.
  3. transient — both `verify_packed128_dh` and `verify_packed128` made to
                 raise: the error must propagate and the latch stay on.

It prints one JSON line per phase and a summary line, whose
`contracts_held` is true only when every phase held its device's rules;
the exit code is 0 only then. The signatures are the reference probe's
(OpenSSL, `random.Random(7)`). The verifier runs on the card unless
`--device cpu` (the kernels' plain versions; a small `--lanes` keeps that
short). The reference's kernel selection (Pallas on the chip, w4 on the
CPU) has no counterpart: the port runs K2, K3, K1 and K4 on both.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import resolve_device
from .ops import _build, ladder
from .ops.verifier import Ed25519TorchVerifier

LANES = 512  # the reference probe's batch


def _batch(n: int, corrupt_every: int = 0):
    """n (32-byte message, key, signature) triples; every `corrupt_every`-th
    signature has its first byte flipped (0: none). Returns them with the
    mask known by construction."""
    from .bench import signed_batch

    msgs, keys, sigs = signed_batch(n, msg_len=32, seed=7)
    sigs = [bytearray(s) for s in sigs]
    expect = []
    for i in range(n):
        bad = bool(corrupt_every) and i % corrupt_every == 0
        if bad:
            sigs[i][0] ^= 0xFF
        expect.append(not bad)
    return msgs, keys, [bytes(s) for s in sigs], np.asarray(expect)


def _k2_launches() -> int:
    return _build.KERNELS["h_digits"].launches


def phase_organic(v: Ed25519TorchVerifier, lanes: int) -> dict:
    t0 = time.perf_counter()
    k2_before = _k2_launches()
    masks_ok, checked = True, 0
    for corrupt in (0, 3):
        msgs, keys, sigs, expect = _batch(lanes, corrupt)
        masks_ok &= bool((v.verify_batch_mask(msgs, keys, sigs) == expect).all())
        checked += lanes
    # Random keys and signatures must verify False, not crash, and not
    # trip the latch.
    rng = np.random.default_rng(99)
    junk = lanes // 2
    junk_m = [rng.bytes(32) for _ in range(junk)]
    junk_k = [rng.bytes(32) for _ in range(junk)]
    junk_s = [rng.bytes(64) for _ in range(junk)]
    masks_ok &= not v.verify_batch_mask(junk_m, junk_k, junk_s).any()
    checked += junk
    return {
        "phase": "organic",
        "inputs_checked": checked,
        "masks_ok": masks_ok,
        "latch_fired": v.device_hash_fallbacks > 0 or not v._device_hash_ok,
        "latch_state_ok": v._device_hash_ok,
        "k2_launches": _k2_launches() - k2_before,
        "secs": round(time.perf_counter() - t0, 3),
    }


def _raise(*_a, **_k):
    raise RuntimeError("synthetic device-hash kernel failure")


def phase_forced(v: Ed25519TorchVerifier, lanes: int) -> dict:
    """Deterministic K2 failure: the device-hash call raises, host hashing
    works."""
    t0 = time.perf_counter()
    real = ladder.verify_packed128_dh
    ladder.verify_packed128_dh = _raise
    raised, correct = False, None
    try:
        msgs, keys, sigs, expect = _batch(lanes, corrupt_every=5)
        try:
            correct = bool((v.verify_batch_mask(msgs, keys, sigs) == expect).all())
        except RuntimeError:
            raised = True
    finally:
        ladder.verify_packed128_dh = real
    return {
        "phase": "forced",
        "raised": raised,
        "mask_correct_via_host_retry": correct,
        "latch_ended_off": not v._device_hash_ok,
        "device_hash_fallbacks": v.device_hash_fallbacks,
        "secs": round(time.perf_counter() - t0, 3),
    }


def phase_transient(v: Ed25519TorchVerifier, lanes: int) -> dict:
    """Both paths raise (a device outage): the error must propagate and
    the latch stay where it was (re-armed here after the forced phase)."""
    t0 = time.perf_counter()
    v._device_hash_ok = True
    real_dh, real_hh = ladder.verify_packed128_dh, ladder.verify_packed128
    ladder.verify_packed128_dh = ladder.verify_packed128 = _raise
    raised = False
    try:
        msgs, keys, sigs, _ = _batch(lanes)
        try:
            v.verify_batch_mask(msgs, keys, sigs)
        except RuntimeError:
            raised = True
    finally:
        ladder.verify_packed128_dh, ladder.verify_packed128 = real_dh, real_hh
    return {
        "phase": "transient",
        "raised": raised,
        "latch_survived_on": v._device_hash_ok,
        "secs": round(time.perf_counter() - t0, 3),
    }


def contracts(results: list[dict], on_card: bool) -> bool:
    """Whether every phase held its device's rules (see the module
    docstring)."""
    organic, forced, transient = results
    ok = organic["masks_ok"] and not organic["latch_fired"] and organic["latch_state_ok"]
    if on_card:
        ok = ok and organic["k2_launches"] > 0
        ok = ok and forced["raised"] and not forced["latch_ended_off"] and forced["device_hash_fallbacks"] == 0
    else:
        ok = ok and not forced["raised"] and forced["mask_correct_via_host_retry"] and forced["latch_ended_off"]
    return bool(ok and transient["raised"] and transient["latch_survived_on"])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hotstuff_tpu_torch.latch_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default; no card raises) or the kernels' plain versions")
    ap.add_argument("--lanes", type=int, default=LANES, help="signatures in each organic batch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lanes = max(4, args.lanes)
    v = Ed25519TorchVerifier(device=device, min_bucket=min(128, lanes // 4))
    try:
        results = [phase_organic(v, lanes), phase_forced(v, lanes // 2), phase_transient(v, lanes // 4)]
    finally:
        v.close()
    for r in results:
        print(json.dumps(r), flush=True)
    ok = contracts(results, device.type == "cuda")
    print(json.dumps({
        "summary": "latch_probe",
        "device": str(device),
        "lanes": lanes,
        "organic_latch_fired": results[0]["latch_fired"],
        "organic_k2_launches": results[0]["k2_launches"],
        "contracts_held": ok,
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
