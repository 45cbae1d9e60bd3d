"""The port's ladder (hotstuff_tpu_torch/ops/ladder.py, plain version of
kernel K1) against the JAX package's Pallas kernel `_ladder_kernel`, run
here in interpret mode with the BlockSpecs of `ladder_pallas`, on the same
digits and -A tables (carried across with `convert`). Results are compared
as compressed encodings, exactly."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.ops import field as jf
from hotstuff_tpu.ops import pallas_ladder as jpl
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import ladder as tl
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = 2**255 - 19
B = jpl.BLOCK  # 256 lanes: one grid program


def _pallas_ladder_interpret(s_digits, h_digits, ta):
    """`ladder_pallas` with interpret=True: the same kernel body and specs."""
    digit_spec = pl.BlockSpec((jed.NGROUPS, B), lambda i: (0, i), memory_space=pltpu.VMEM)
    shared_spec = pl.BlockSpec((16, jf.NLIMB), lambda i: (0, 0), memory_space=pltpu.VMEM)
    item_spec = pl.BlockSpec((16, jf.NLIMB, B), lambda i: (0, 0, i), memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((jf.NLIMB, B), lambda i: (0, i), memory_space=pltpu.VMEM)
    out_shape = jax.ShapeDtypeStruct((jf.NLIMB, B), jnp.float32)
    base = [np.ascontiguousarray(t.T) for t in jed.BASE_TABLE]
    return pl.pallas_call(
        jpl._ladder_kernel,
        grid=(1,),
        in_specs=[digit_spec, digit_spec] + [shared_spec] * 3 + [item_spec] * 4,
        out_specs=[out_spec] * 4,
        out_shape=[out_shape] * 4,
        interpret=True,
    )(s_digits, h_digits, *base, *ta)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    keys = rng.integers(0, 256, (B, 32), np.uint8)
    for i in range(8):  # a few real keys among the random encodings
        keys[i] = np.frombuffer(pysigner.keypair_from_seed(bytes([i + 1]) * 32)[0], np.uint8)
    rows = keys.T.copy()
    a_y = rows.astype(np.float32)
    a_y[31] = (rows[31] & 0x7F).astype(np.float32)
    sign = (rows[31] >> 7).astype(np.float32)
    s_digits = rng.integers(0, 16, (64, B)).astype(np.float32)
    h_digits = rng.integers(0, 16, (64, B)).astype(np.float32)
    s_digits[:, 0] = 0  # an all-zero lane: the ladder returns the identity
    h_digits[:, 0] = 0

    @jax.jit
    def table(a_y, sign):
        _, xneg, valid = jed.decompress(a_y, sign)
        return jed._build_neg_a_table(xneg, a_y), valid

    ta, valid = table(a_y, sign)
    ta = [np.asarray(t) for t in ta]
    return rows, s_digits, h_digits, ta, np.asarray(valid)


def test_ladder_matches_pallas_interpret(inputs):
    rows, s_digits, h_digits, ta, _ = inputs
    jx, jy, jz, jt = _pallas_ladder_interpret(s_digits, h_digits, ta)
    jpoint = torch.stack([convert.field_from_jax(np.asarray(c)) for c in (jx, jy, jz, jt)])
    point = tl.ladder(  # CPU tensors: the plain version
        convert.digits_from_jax(s_digits), convert.digits_from_jax(h_digits),
        convert.table_from_jax(*ta),
    )
    assert point.dtype == torch.int32 and point.shape == (4, 10, B)
    assert not point[3].any()  # T is skipped by the last cached add
    enc, jenc = ted.compress(point), ted.compress(jpoint)
    assert torch.equal(enc, jenc)
    np.testing.assert_array_equal(
        jenc.numpy(), np.asarray(jax.jit(jed.compress)((jx, jy, jz, jt))).astype(np.uint8)
    )
    identity = (1).to_bytes(32, "little")
    assert bytes(enc[:, 0].tolist()) == identity


def test_ladder_is_double_scalar_mult(inputs):
    """Lanes with real keys: enc([s]B + [h](-A)) from exact host ints."""
    rows, s_digits, h_digits, _, _ = inputs
    sd, hd = convert.digits_from_jax(s_digits), convert.digits_from_jax(h_digits)
    table, valid = ted.decompress_table(torch.from_numpy(rows[:, :8].copy()))
    assert valid.all()
    point = tl.ladder(sd[:, :8].contiguous(), hd[:, :8].contiguous(), table)
    enc = ted.compress(point)
    for i in range(8):
        s = sum(int(sd[d, i]) << (4 * d) for d in range(64))
        h = sum(int(hd[d, i]) << (4 * d) for d in range(64))
        a_pt = pysigner._pt_decompress(bytes(rows[:, i].tolist()))
        neg_a = ((P - a_pt[0]) % P, a_pt[1], 1, (P - a_pt[3]) % P)
        want = pysigner._pt_add(pysigner._pt_mul(s, pysigner._B_POINT), pysigner._pt_mul(h, neg_a))
        assert bytes(enc[:, i].tolist()) == pysigner._pt_compress(want)


def test_verify_unpacked_composes_the_kernels(inputs):
    """K3 -> K1 -> K4 on the CPU: R set to the ladder's own encoding
    verifies exactly on the lanes whose key decompresses."""
    rows, s_digits, h_digits, _, valid = inputs
    a = torch.from_numpy(rows[:, :32].copy())
    sd = convert.digits_from_jax(s_digits[:, :32]).contiguous()
    hd = convert.digits_from_jax(h_digits[:, :32]).contiguous()
    table, tvalid = ted.decompress_table(a)
    r = ted.compress(tl.ladder(sd, hd, table))
    r[:, 5] ^= 1
    mask = tl.verify_unpacked(a, r, sd, hd)
    want = valid[:32].copy()
    want[5] = False
    assert mask.tolist() == want.tolist()
