"""The port's device tuning tool (`hotstuff_tpu_torch/tune_device.py`) on
the CPU, where every leg runs the plain versions: each leg at 16 lanes or
fewer prints the reference tool's row names, the command line runs and
refuses to run quietly without a card, the plain chains of its two
yardstick kernels equal chains computed by hand, and the `--field` leg's
two fields agree with each other and with the JAX package's production
field (`hotstuff_tpu.ops.field.sqr`, chained) in value mod p."""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import field as jf
from hotstuff_tpu_torch import tune_device as td
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import field as f
from hotstuff_tpu_torch.ops import field12 as f12
from tests.common_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LANES = 16
CHAIN = 4

LEGS = {  # leg -> (call at <= 16 lanes, the reference's row names it prints)
    "vpu": (lambda: td.bench_vpu(CPU, (64, LANES), CHAIN, 1),
            ["vpu f32 mul+add", "vpu i32 mul+add", "vpu u32 xor/shift/add"]),
    "field": (lambda: td.bench_field(CPU, LANES, CHAIN, 1),
              ["field int32 radix-2^25.5", "field u32 radix-2^12", "field check: both rows equal"]),
    "phases": (lambda: td.bench_phases(CPU, LANES, 1),
               ["phase decompress ", "phase decompress+table", "phase ladder", "phase compress",
                "phase sha512+modL (dh)", "phase full verify"]),
    "chunks": (lambda: td.bench_chunks(CPU, LANES, 1, "w4", ((8, 8), (16, 16))),
               ["chunk     8 (bucket     8)  e2e", "chunk    16 (bucket    16)  e2e"]),
    "dh": (lambda: td.bench_dh(CPU, LANES, 1),
           ["dh-compare host-hash", "dh-compare device-hash"]),
}


@pytest.mark.parametrize("leg", list(LEGS))
def test_leg_prints_the_reference_rows_on_the_cpu(leg, capsys):
    run, rows = LEGS[leg]
    out = run()
    lines = capsys.readouterr().out.splitlines()
    for row in rows:
        assert any(ln.startswith(row) for ln in lines), (row, lines)
    assert out and all(v for v in (out.values() if leg != "vpu" else [1]))
    if leg == "phases":
        assert "phase decompress         fused into K3, not timed apart" in lines


def test_command_line_on_the_cpu_exits_zero():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "hotstuff_tpu_torch.tune_device", "--cpu", "--field", "--vpu",
         "--lanes", str(LANES), "--reps", "1", "--chain", str(CHAIN)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("# devices: cpu") and lines[-1] == "# launches: {}"
    assert sum(ln.startswith(("vpu ", "field ")) for ln in lines) == 6


def test_without_a_card_and_without_cpu_it_exits_non_zero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert td.main(["--field"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_alu_chain_plain_equals_chains_by_hand():
    x = np.array([1.0001, 0.5, -3.25, 1e-3], np.float32)
    got = td.alu_chain(torch.from_numpy(x.copy()), 0, 3)
    want = x.copy()
    for _ in range(3):
        want = np.float32(want * want) + np.float32(1.0)
    assert np.array_equal(got.numpy().view(np.uint32), want.astype(np.float32).view(np.uint32))
    ints = [3, -1, 2**31 - 1, -2**31, 123456789]
    x = torch.tensor(ints, dtype=torch.int32)
    for op, step in ((1, lambda v: v * v + 1), (2, lambda v: (v ^ (v >> 7)) + (v << 3))):
        want = []
        for v in ints:
            u = v % 2**32
            for _ in range(5):
                u = step(u) % 2**32
            want.append(u - 2**32 if u >= 2**31 else u)
        got = td.alu_chain(x, op, 5)
        assert got.dtype == torch.int32 and got.tolist() == want


def test_sqr_chain_plain_equals_squarings_by_hand():
    vals = [0, 1, 2, f.P - 1, 2**255 - 20, 12345678901234567890]
    x = f.limbs_of_int(vals).to(torch.int32)
    out = f.sqr_chain(x, 5)
    assert out.dtype == torch.int32
    assert [v % f.P for v in f.int_of_limbs(out)] == [pow(v, 2**5, f.P) for v in vals]
    assert torch.equal(out, f.sqr_n(x.long(), 5).to(torch.int32))


def test_field_rows_agree_with_each_other_and_with_the_jax_field():
    rng = random.Random(14)
    vals = [0, 1, f.P - 1] + [rng.randrange(f.P) for _ in range(LANES - 3)]
    r25 = f.sqr_chain(f.limbs_of_int(vals).to(torch.int32), CHAIN)
    r12 = f12.sqr_n(f12.tensor_of_ints(vals), CHAIN)
    limbs = np.concatenate([jf.limbs_of_int(v) for v in vals], axis=1)
    rj = jax.jit(lambda a: jax.lax.fori_loop(0, CHAIN, lambda _, y: jf.sqr(y), a))(limbs)
    want = [pow(v, 2**CHAIN, f.P) for v in vals]
    assert [v % f.P for v in f.int_of_limbs(r25)] == want
    assert f12.int_of_limbs(f12.canonical(r12)) == want
    assert [v % f.P for v in jf.int_of_limbs(np.asarray(rj))] == want


def test_corpus_without_cryptography_signs_in_a_pool(monkeypatch):
    for mod in ("cryptography", "cryptography.hazmat.primitives.asymmetric.ed25519",
                "cryptography.hazmat.primitives.serialization"):
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setattr(td, "DISTINCT", 2)
    td._signed.cache_clear()
    try:
        msgs, keys, sigs = td.corpus(3, seed=7)
    finally:
        td._signed.cache_clear()
    assert len(set(zip(msgs, keys, sigs))) == 2 and (msgs[2], keys[2], sigs[2]) == (msgs[0], keys[0], sigs[0])
    assert all(pysigner.verify(k, m, s) for m, k, s in zip(msgs, keys, sigs))
