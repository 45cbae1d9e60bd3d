"""The split field multiply of kernels K4 and K3 (`csrc/split_field.cuh`),
through its integer model in hotstuff_tpu_torch/ops/field.py
(`carry_split`, `mul_split`, `sqr_split`, `invert_split`,
`pow2523_split`), against the port's ref10 `mul` / `sqr` / `invert` /
`pow2523`, exact Python integers, and JAX's `compress`. Values are
compared mod p and bytes exactly (tolerance 0); the split carry's output
limbs are held to the bound the header states, at worst-case operands."""

import random

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.ops import field as jf
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import field as tf
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = tf.P
B = 16
TOP = [(1 << 27) if i % 2 == 0 else (1 << 26) for i in range(tf.NL)]  # mul's operand bound


def _vals(x) -> list[int]:
    return [v % P for v in tf.int_of_limbs(x)]


def _cols(*columns) -> torch.Tensor:
    return torch.tensor(columns, dtype=torch.int64).T.contiguous()


def _assert_bounded(out: torch.Tensor) -> None:
    for i in range(tf.NL):
        assert int(out[i].abs().max()) <= tf.SPLIT_BOUND[i], (i, int(out[i].abs().max()))


def _carried(rng, n):
    return tf.mul(tf.limbs_of_int([rng.randrange(P) for _ in range(n)]), tf.ONE.expand(tf.NL, n))


def _worst(case: str) -> torch.Tensor:
    """B columns of operands at mul's bound: every limb +, every limb -,
    alternating signs (both phases), and sums of two lazy adds of carried
    values (each at the split bound, either sign)."""
    alt = [t * (-1) ** i for i, t in enumerate(TOP)]
    if case == "plus":
        return _cols(*[TOP] * B)
    if case == "minus":
        return _cols(*[[-t for t in TOP]] * B)
    if case == "alternating":
        return _cols(*[alt if b % 2 else [-t for t in alt] for b in range(B)])
    rng = random.Random(7)
    edge = _cols(*[[s * tf.SPLIT_BOUND[i] for i in range(tf.NL)] for s in (1, -1)])
    x = torch.cat([edge, _carried(rng, B - 2)], 1)
    y = torch.cat([edge.flip(1), _carried(rng, B - 2)], 1)
    return tf.add(x, y) if case == "lazy_add" else tf.sub(tf.sub(tf.ZERO, x), y)


def test_split_groups_partition_the_columns():
    """The column groups of the header and their product counts."""
    assert sorted(k for g in tf.SPLIT_GROUPS for k in g) == list(range(tf.NL))
    sq = [sum(1 for i in range(tf.NL) for j in range(i, tf.NL) if (i + j) % tf.NL in g) for g in tf.SPLIT_GROUPS]
    mul = [sum(1 for i in range(tf.NL) for j in range(tf.NL) if (i + j) % tf.NL in g) for g in tf.SPLIT_GROUPS]
    assert sq == [17, 16, 11, 11] and sum(sq) == tf.SQR_PRODUCTS
    assert mul == [30, 30, 20, 20] and sum(mul) == tf.MUL_PRODUCTS


@pytest.mark.parametrize("seed", range(3))
def test_mul_sqr_split_random(seed):
    rng = random.Random(100 + seed)
    a_int = [rng.randrange(P) for _ in range(128)]
    b_int = [rng.randrange(P) for _ in range(128)]
    a, b = tf.limbs_of_int(a_int), tf.limbs_of_int(b_int)
    got = tf.mul_split(a, b)
    assert _vals(got) == _vals(tf.mul(a, b)) == [(x * y) % P for x, y in zip(a_int, b_int)]
    sq = tf.sqr_split(got)
    assert _vals(sq) == _vals(tf.sqr(got)) == [(v * v) % P for v in _vals(got)]
    _assert_bounded(got)
    _assert_bounded(sq)


@pytest.mark.parametrize("case", ["plus", "minus", "alternating", "lazy_add", "lazy_sub"])
def test_mul_sqr_split_worst_case_operands(case):
    a = _worst(case)
    for b in (a, _worst("plus"), _worst("alternating"), a.flip(1)):
        assert int(tf._column_sums(a, b).abs().max()) < 2**61
        got = tf.mul_split(a, b)
        assert _vals(got) == _vals(tf.mul(a, b))
        assert _vals(got) == [(x * y) % P for x, y in zip(tf.int_of_limbs(a), tf.int_of_limbs(b))]
        _assert_bounded(got)
    sq = tf.sqr_split(a)
    assert _vals(sq) == _vals(tf.sqr(a)) == [(x * x) % P for x in tf.int_of_limbs(a)]
    _assert_bounded(sq)


def test_carry_split_at_the_column_sum_limit():
    """Column sums at +-(2^61 - 1), every limb and mixed signs: the output
    keeps the value mod p and stays within the stated bound."""
    m = (1 << 61) - 1
    rng = random.Random(3)
    h = _cols([m] * tf.NL, [-m] * tf.NL, *[[rng.choice((m, -m, rng.randrange(-m, m))) for _ in range(tf.NL)] for _ in range(B - 2)])
    out = tf.carry_split(h)
    assert _vals(out) == [v % P for v in tf.int_of_limbs(h)]
    _assert_bounded(out)
    ref = tf.carry(h)
    assert _vals(out) == _vals(ref)


def test_invert_split():
    rng = random.Random(11)
    ints = [rng.randrange(1, P) for _ in range(61)] + [1, P - 1, 0]
    z = tf.limbs_of_int(ints)
    inv = tf.invert_split(z)
    _assert_bounded(inv)
    assert _vals(inv) == _vals(tf.invert(z)) == [pow(v, P - 2, P) for v in ints]
    assert _vals(tf.mul(inv, z)) == [1] * (len(ints) - 1) + [0]


@pytest.mark.parametrize("case", ["random", "plus", "minus", "alternating", "lazy_add", "lazy_sub"])
def test_pow2523_split(case):
    """K3's square-root power on the split ops: z^((p-5)/8) mod p as the
    ref10 chain and exact ints, from random and edge values and from
    operands at mul's bound (phase 1 feeds it split outputs and their lazy
    sums with constants, inside these bounds)."""
    if case == "random":
        rng = random.Random(13)
        z = tf.limbs_of_int([rng.randrange(P) for _ in range(B - 3)] + [0, 1, P - 1])
    else:
        z = _worst(case)
    got = tf.pow2523_split(z)
    _assert_bounded(got)
    want = [pow(v % P, (P - 5) // 8, P) for v in tf.int_of_limbs(z)]
    assert _vals(got) == _vals(tf.pow2523(z)) == want


def _random_points(rng, n):
    pts = []
    while len(pts) < n:
        pt = jed._decompress_int(rng.randbytes(32))
        if pt is None:
            continue
        z = rng.randrange(1, P)
        x, y = pt
        pts.append((x * z % P, y * z % P, z, x * y % P * z % P))
    return pts


def _compress_split(xyzt: torch.Tensor) -> torch.Tensor:
    """K4's steps: the split inversion and multiplies, then ref10's
    canonical reduction and encoding."""
    X, Y, Z = xyzt[0].long(), xyzt[1].long(), xyzt[2].long()
    zinv = tf.invert_split(Z)
    x_c = tf.canonical(tf.mul_split(X, zinv))
    enc = tf.to_bytes(tf.canonical(tf.mul_split(Y, zinv)))
    enc[31] |= (tf.parity(x_c) << 7).to(torch.uint8)
    return enc


def test_compress_through_invert_split_matches_jax():
    pts = _random_points(random.Random(29), B)
    cols = list(zip(*pts))
    port = torch.stack([tf.limbs_of_int(list(c)) for c in cols]).to(torch.int32)
    enc = _compress_split(port)
    jenc = np.asarray(jax.jit(jed.compress)(tuple(
        np.concatenate([jf.limbs_of_int(v) for v in c], axis=1) for c in cols
    )))
    np.testing.assert_array_equal(enc.numpy(), jenc.astype(np.uint8))
    assert torch.equal(enc, ted.compress(port))


def test_compress_split_identity_and_scaled_points():
    """The identity (0, 1, 1, 0) encodes as 1; the same point with Z scaled
    by a random lambda encodes as before."""
    rng = random.Random(31)
    pts = _random_points(rng, B - 1)
    port = torch.stack([tf.limbs_of_int(list(c)) for c in zip(*pts)]).to(torch.int32)
    ident = torch.tensor([[0] * tf.NL, [1] + [0] * 9, [1] + [0] * 9, [0] * tf.NL], dtype=torch.int32)
    port = torch.cat([ident[:, :, None], port], 2)
    lam = tf.limbs_of_int([rng.randrange(1, P) for _ in range(B)])
    scaled = torch.stack([tf.mul(port[c].long(), lam) for c in range(4)]).to(torch.int32)
    enc = _compress_split(port)
    assert bytes(enc[:, 0].tolist()) == (1).to_bytes(32, "little")
    assert torch.equal(_compress_split(scaled), enc)
