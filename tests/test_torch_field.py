"""The port's GF(2^255 - 19) (hotstuff_tpu_torch/ops/field.py) against the
JAX package's field (hotstuff_tpu/ops/field.py) and exact Python integers,
on the edge values and random op chains of test_field_fuzz.py and
test_ops_ed25519.py. Exact: every comparison is of integers."""

import random

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import field as jf
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.ops import field as tf
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = tf.P
RNG = random.Random(99)

EDGES = [
    0, 1, 2, 19, P - 1, P - 2, P - 19, (2**255 - 1) % P, 2**254, 2**200, 2**128,
    int("55" * 32, 16) % P, int("aa" * 32, 16) % P,
]

_jcanon = jax.jit(jf.canonical)


def _jax_cols(values):
    return np.concatenate([jf.limbs_of_int(v % P) for v in values], axis=1)


def _jax_ints(x) -> list[int]:
    return jf.int_of_limbs(np.asarray(_jcanon(x)))


def _port_ints(x) -> list[int]:
    canon = tf.canonical(x)
    assert int(canon.min()) >= 0
    assert all(int(canon[i].max()) < 2 ** tf.WIDTHS[i] for i in range(tf.NL))
    return tf.int_of_limbs(canon)


def test_mul_sqr_edge_matrix():
    a = [x for x in EDGES for _ in EDGES]
    b = [y for _ in EDGES for y in EDGES]
    want = [(x * y) % P for x, y in zip(a, b)]
    got = _port_ints(tf.mul(tf.limbs_of_int(a), tf.limbs_of_int(b)))
    assert got == want
    assert _jax_ints(jf.mul(_jax_cols(a), _jax_cols(b))) == want
    sq = _port_ints(tf.sqr(tf.limbs_of_int(EDGES)))
    assert sq == [(e * e) % P for e in EDGES] == _jax_ints(jf.sqr(_jax_cols(EDGES)))


@pytest.mark.parametrize("trial", range(4))
def test_random_op_chains_match_jax_and_bigint(trial):
    """add / sub / mul / sqr chains with at most two lazy adds feeding a
    mul (the curve code's pattern), both packages and Python ints."""
    rng = random.Random(1000 + trial)
    B = 16
    ints = [rng.randrange(P) for _ in range(B)]
    port, jx = tf.limbs_of_int(ints), _jax_cols(ints)
    for _ in range(10):
        op = rng.choice(["mul", "sqr", "sub", "addmul", "subsub"])
        other = [rng.randrange(P) for _ in range(B)]
        third = [rng.randrange(P) for _ in range(B)]
        o_t, o_j = tf.limbs_of_int(other), _jax_cols(other)
        if op == "mul":
            port, jx = tf.mul(port, o_t), jf.mul(jx, o_j)
            ints = [(x * y) % P for x, y in zip(ints, other)]
        elif op == "sqr":
            port, jx = tf.sqr(port), jf.sqr(jx)
            ints = [(x * x) % P for x in ints]
        elif op == "sub":
            port, jx = tf.sub(port, o_t), jf.sub(jx, o_j)
            ints = [(x - y) % P for x, y in zip(ints, other)]
        elif op == "addmul":
            port = tf.mul(tf.add(port, o_t), tf.limbs_of_int(third))
            jx = jf.mul(jf.add(jx, o_j), _jax_cols(third))
            ints = [((x + y) * z) % P for x, y, z in zip(ints, other, third)]
        else:  # (x - y) - z into a mul: the dbl's tp = zz2 - zp pattern
            port = tf.mul(tf.sub(tf.sub(port, o_t), tf.limbs_of_int(third)), o_t)
            jx = jf.mul(jf.sub(jf.sub(jx, o_j), _jax_cols(third)), o_j)
            ints = [((x - y - z) * y) % P for x, y, z in zip(ints, other, third)]
    assert _port_ints(port) == ints == _jax_ints(jx)


def test_worst_case_limbs_stay_exact():
    """Operands at the bound the curve code reaches (|limb| ~2^27 even,
    ~2^26 odd, either sign) multiply exactly."""
    top = [(1 << 27) - 1 if i % 2 == 0 else (1 << 26) - 1 for i in range(tf.NL)]
    a = torch.tensor([top, [-v for v in top], top], dtype=torch.int64).T.contiguous()
    b = torch.tensor([top, top, [-v for v in top]], dtype=torch.int64).T.contiguous()
    va, vb = tf.int_of_limbs(a), tf.int_of_limbs(b)
    assert _port_ints(tf.mul(a, b)) == [(x * y) % P for x, y in zip(va, vb)]
    out = tf.mul(a, b)
    assert int(out.abs().max()) < 2**26


def test_invert_and_pow2523():
    vals = [RNG.randrange(1, P) for _ in range(6)] + [1, P - 1, 0]
    got_inv = _port_ints(tf.invert(tf.limbs_of_int(vals)))
    assert got_inv == [pow(v, P - 2, P) for v in vals]
    assert got_inv == _jax_ints(jax.jit(jf.invert)(_jax_cols(vals)))
    got_pow = _port_ints(tf.pow2523(tf.limbs_of_int(vals)))
    assert got_pow == [pow(v, (P - 5) // 8, P) for v in vals]
    assert got_pow == _jax_ints(jax.jit(jf.pow2523)(_jax_cols(vals)))


def test_canonical_edges_and_negative_limbs():
    vals = [0, 1, 19, P - 1, P - 19, 2**255 - 20]
    raw = [v + P for v in vals if v + P < 2**255]  # unreduced encodings y >= p
    assert _port_ints(tf.limbs_of_int(raw)) == [v % P for v in raw]
    negs = tf.sub(tf.ZERO, tf.limbs_of_int(vals))  # negative limbs
    assert _port_ints(negs) == [(-v) % P for v in vals]
    assert _jax_ints(jf.sub(jf.ZERO, _jax_cols(vals))) == [(-v) % P for v in vals]


def test_parity_select_eq():
    vals = [RNG.randrange(P) for _ in range(8)]
    c = tf.canonical(tf.limbs_of_int(vals))
    assert tf.parity(c).tolist() == [v & 1 for v in vals]
    jc = _jcanon(_jax_cols(vals))
    assert np.asarray(jf.parity(jc)).astype(int).tolist() == [v & 1 for v in vals]
    mask = torch.tensor([i % 2 == 0 for i in range(8)])
    sel = tf.select(mask, c, tf.canonical(tf.limbs_of_int(vals[::-1])))
    assert tf.int_of_limbs(sel) == [vals[i] if i % 2 == 0 else vals[::-1][i] for i in range(8)]
    assert tf.eq_canonical(c, tf.canonical(tf.add(tf.limbs_of_int(vals), tf.limbs_of_int([0] * 8)))).all()


def test_bytes_roundtrip_and_limbs():
    vals = [RNG.randrange(2**255) for _ in range(8)] + [2**255 - 1, 0, P]
    b = torch.tensor([list(v.to_bytes(32, "little")) for v in vals], dtype=torch.uint8).T
    limbs = tf.from_bytes(b)
    assert tf.int_of_limbs(limbs) == vals
    assert tf.int_of_limbs(tf.limbs_of_int(vals)) == vals
    red = [v % P for v in vals]
    enc = tf.to_bytes(tf.canonical(limbs))
    assert [int.from_bytes(bytes(enc[:, i].tolist()), "little") for i in range(len(vals))] == red
    # bit 255 (the sign of x in a point encoding) is dropped by from_bytes
    b[31] |= 0x80
    assert tf.int_of_limbs(tf.from_bytes(b)) == vals


def test_convert_field_roundtrip():
    vals = [RNG.randrange(P) for _ in range(8)]
    lazy = jf.mul(_jax_cols(vals), _jax_cols(vals[::-1]))  # unnormalized limbs
    port = convert.field_from_jax(np.asarray(lazy))
    assert port.dtype == torch.int32
    assert tf.int_of_limbs(port) == [(x * y) % P for x, y in zip(vals, vals[::-1])]
    back = convert.field_to_jax(tf.sub(tf.ZERO, port))
    assert jf.int_of_limbs(back) == [(-x * y) % P for x, y in zip(vals, vals[::-1])]
