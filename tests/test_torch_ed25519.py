"""The port's curve code (hotstuff_tpu_torch/ops/ed25519.py: plain versions
of kernels K3 `decompress_table` and K4 `compress_eq`, and the model of
K3's split square root, `decompress_split`) against the JAX package's
`decompress`, `_build_neg_a_table` and `compress`, and against exact affine
Edwards arithmetic in Python integers. Exact comparisons."""

import random

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.ops import field as jf
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import field as tf
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = tf.P
RNG = random.Random(23)
B = 16


def _keys():
    """Random encodings (about half decompress), real public keys, and the
    edge encodings: y >= p, x = 0 with the sign bit, y = 0, all ones."""
    keys = [RNG.randbytes(32) for _ in range(6)]
    keys += [pysigner.keypair_from_seed(bytes([i]) * 32)[0] for i in range(4)]
    edges = [P, P + 1, 1 | (1 << 255), 0, 2**256 - 1, (P + 3) | (1 << 255)]
    keys += [e.to_bytes(32, "little") for e in edges]
    assert len(keys) == B
    return keys


def _key_rows(keys):
    return np.frombuffer(b"".join(keys), np.uint8).reshape(len(keys), 32).T.copy()


def _jax_key_args(rows):
    a_y = rows.astype(np.float32)
    a_y[31] = (rows[31] & 0x7F).astype(np.float32)
    return a_y, (rows[31] >> 7).astype(np.float32)


def _vals(x) -> list[int]:
    return [v % P for v in tf.int_of_limbs(x)]


def _jvals(x) -> list[int]:
    return [v % P for v in jf.int_of_limbs(np.asarray(x))]


def _table_vals(table):
    """(4, 16, NL, B) -> nested values mod p [component][entry][lane]."""
    return [[_vals(table[c, k]) for k in range(16)] for c in range(4)]


_jdecompress = jax.jit(jed.decompress)
_jtable = jax.jit(jed._build_neg_a_table)


def test_decompress_matches_jax_and_ints():
    keys = _keys()
    rows = _key_rows(keys)
    y, sign = ted.unpack_key(torch.from_numpy(rows))
    x, xneg, valid = ted.decompress(y, sign)
    jx, jxneg, jvalid = _jdecompress(*_jax_key_args(rows))
    assert valid.tolist() == np.asarray(jvalid).tolist()
    assert _vals(x) == _jvals(jx) and _vals(xneg) == _jvals(jxneg)
    for i, k in enumerate(keys):  # host decompression semantics, exact
        pt = jed._decompress_int(k)
        assert valid[i].item() == (pt is not None)
        if pt is not None:
            assert _vals(x)[i] == pt[0] and _vals(xneg)[i] == (P - pt[0]) % P
    assert valid[-6:-3].tolist() == [True, True, True]  # y = p, y = p + 1, x = 0 with sign


def test_decompress_split_matches_decompress_and_jax(monkeypatch):
    """K3's phase 1 (`decompress_split`: every product on the split multiply
    of csrc/split_field.cuh) gives `decompress`'s canonical x, -x and valid
    exactly, so JAX's values too; every product's operands stay within
    mul's bound and every product within the split bound."""
    rows = _key_rows(_keys())
    y, sign = ted.unpack_key(torch.from_numpy(rows))
    mul_split, products = tf.mul_split, []

    def checked(a, b):
        for t in (a, b):
            for i in range(tf.NL):
                assert int(t[i].abs().max()) <= 1 << (27 if i % 2 == 0 else 26)
        out = mul_split(a, b)
        products.append(max(int(out[i].abs().max()) - tf.SPLIT_BOUND[i] for i in range(tf.NL)))
        return out

    monkeypatch.setattr(tf, "mul_split", checked)
    got = ted.decompress_split(y, sign)
    monkeypatch.undo()
    assert len(products) == 274 and max(products) <= 0  # every field product of phase 1
    for g, w in zip(got, ted.decompress(y, sign)):
        assert torch.equal(g, w)
    jx, jxneg, jvalid = _jdecompress(*_jax_key_args(rows))
    assert got[2].tolist() == np.asarray(jvalid).tolist()
    assert _vals(got[0]) == _jvals(jx) and _vals(got[1]) == _jvals(jxneg)


def test_neg_a_table_matches_jax():
    rows = _key_rows(_keys())
    table, valid = ted.decompress_table(torch.from_numpy(rows))  # CPU: plain version
    assert table.dtype == torch.int32 and table.shape == (4, 16, tf.NL, B)
    assert torch.equal(valid, ted.decompress_table_plain(torch.from_numpy(rows))[1])
    a_y, sign = _jax_key_args(rows)
    _, jxneg, _ = _jdecompress(a_y, sign)
    jtable = [np.asarray(t) for t in _jtable(jxneg, a_y)]
    assert _table_vals(table) == [[_jvals(comp[k]) for k in range(16)] for comp in jtable]
    assert torch.equal(convert.table_from_jax(*jtable), torch.stack(
        [torch.stack([tf.canonical(table[c, k]) for k in range(16)]) for c in range(4)]
    ).to(torch.int32))


def test_neg_a_table_entries_are_multiples():
    """Entry k is k*(-A) in cached form, checked with exact affine ints."""
    keys = [pysigner.keypair_from_seed(bytes([i + 9]) * 32)[0] for i in range(3)]
    table, valid = ted.decompress_table(torch.from_numpy(_key_rows(keys)))
    assert valid.all()
    d2 = ted.D2_INT
    for lane, k in enumerate(keys):
        x, y = jed._decompress_int(k)
        neg = ((P - x) % P, y)
        cur = (0, 1)
        for e in range(16):
            ypx, ymx, z, t2d = (_vals(table[c, e])[lane] for c in range(4))
            zi = pow(z, P - 2, P)
            yy, xx = (ypx + ymx) * pow(2, P - 2, P) % P, (ypx - ymx) * pow(2, P - 2, P) % P
            assert (xx * zi % P, yy * zi % P) == cur
            assert t2d == d2 * xx * yy % P * zi % P
            cur = ted._edwards_add_int(cur, neg)


def test_base_table_matches_jax():
    assert torch.equal(convert.base_table_from_jax(jed.BASE_TABLE), ted.BASE_TABLE)


def _random_points(n):
    """Projective (X, Y, Z, T) of affine points with a random Z."""
    pts = []
    while len(pts) < n:
        pt = jed._decompress_int(RNG.randbytes(32))
        if pt is None:
            continue
        z = RNG.randrange(1, P)
        x, y = pt
        pts.append((x * z % P, y * z % P, z, x * y % P * z % P))
    return pts


def test_compress_matches_jax():
    pts = _random_points(B)
    cols = list(zip(*pts))
    port = torch.stack([tf.limbs_of_int(list(c)) for c in cols]).to(torch.int32)
    enc = ted.compress(port)
    jenc = np.asarray(jax.jit(jed.compress)(tuple(
        np.concatenate([jf.limbs_of_int(v) for v in c], axis=1) for c in cols
    )))
    np.testing.assert_array_equal(enc.numpy(), jenc.astype(np.uint8))
    for i, (X, Y, Z, _) in enumerate(pts):
        zi = pow(Z, P - 2, P)
        want = (Y * zi % P) | ((X * zi % P & 1) << 255)
        assert bytes(enc[:, i].tolist()) == want.to_bytes(32, "little")


def test_compress_eq_masks():
    pts = _random_points(8)
    port = torch.stack([tf.limbs_of_int(list(c)) for c in zip(*pts)]).to(torch.int32)
    r = ted.compress(port)
    r[0, 1] ^= 1  # lane 1: one byte off
    valid = torch.ones(8, dtype=torch.bool)
    valid[2] = False  # lane 2: key did not decompress
    got = ted.compress_eq(port, r, valid)  # CPU: plain version
    assert got.tolist() == [True, False, False, True, True, True, True, True]


def _affine(pt):
    X, Y, Z, _ = (tf.int_of_limbs(c)[0] % P for c in pt)
    zi = pow(Z, P - 2, P)
    return X * zi % P, Y * zi % P


@pytest.mark.parametrize("with_t", [True, False])
def test_point_ops_match_affine_ints(with_t):
    (x1, y1), (x2, y2) = [p for p in (jed._decompress_int(pysigner.keypair_from_seed(bytes([s]) * 32)[0]) for s in (1, 2))]
    p1 = tuple(tf.limbs_of_int(v) for v in (x1, y1, 1, x1 * y1 % P))
    dbl = ted.point_dbl(p1, with_t=with_t)
    want_dbl = ted._edwards_add_int((x1, y1), (x1, y1))
    assert _affine(dbl) == want_dbl
    if with_t:
        X, Y, Z, T = (tf.int_of_limbs(c)[0] % P for c in dbl)
        assert T * Z % P == X * Y % P
    want_add = ted._edwards_add_int((x1, y1), (x2, y2))
    precomp = [tf.limbs_of_int(v) for v in ((y2 + x2) % P, (y2 - x2) % P, ted.D2_INT * x2 * y2 % P)]
    assert _affine(ted.point_madd(p1, *precomp, with_t=with_t)) == want_add
    cached = [tf.limbs_of_int(v) for v in ((y2 + x2) % P, (y2 - x2) % P, 1, ted.D2_INT * x2 * y2 % P)]
    assert _affine(ted.point_add_cached(p1, *cached, with_t=with_t)) == want_add


def test_unpack_wire_rows():
    packed = torch.from_numpy(np.arange(128 * 4, dtype=np.int64).reshape(128, 4).astype(np.uint8))
    a, r, s, h = ted.split_packed128(packed)
    assert torch.equal(a, packed[0:32]) and torch.equal(h, packed[96:128])
    a2, r2, sd, hd = ted.unpack_packed_inputs(a, r, s, h)
    assert torch.equal(a2, a) and torch.equal(r2, r)
    assert torch.equal(sd[0::2], s & 15) and torch.equal(hd[1::2], h >> 4)
    jsd = np.asarray(jed._device_nibbles(np.asarray(s.numpy())))
    np.testing.assert_array_equal(sd.numpy(), jsd.astype(np.uint8))
