"""The port's BLS12-381 G1 committee aggregation (hotstuff_tpu_torch/ops/bls.py:
the plain field and point functions, the plain versions of kernel K6's two
entries `g1_aggregate` and `g1_aggregate_affine`, the inversion chain
and `CommitteeTable` on the CPU) against the JAX package's
`hotstuff_tpu/ops/bls.py` and the exact integer fold of `crypto/aggsig.py`.
Inputs come from seeds; every comparison is exact (tolerance 0): the
outputs are integers. The port's residues are canonical in [0, p), the
reference's in [0, 2p), so values are compared mod p and the port's are
also held below p."""

import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from hotstuff_tpu.crypto import aggsig as jagg
from hotstuff_tpu.ops import bls as jb
from hotstuff_tpu_torch import bls_corpus, convert
from hotstuff_tpu_torch.crypto import aggsig
from hotstuff_tpu_torch.ops import bls
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = bls.P
SCHEME = aggsig.ExactBlsScheme()
EDGES = (0, 1, P - 1, P, 2 * P - 1)  # 2p - 1: the top of the admissible [0, 2p)


def _key(i: int) -> bytes:
    return SCHEME.keypair_from_seed(bytes([i]) * 32)[0]


def _jax_limbs(values) -> jax.Array:
    return jax.numpy.asarray(np.concatenate([jb.limbs_of_int(v) for v in values], 1), jax.numpy.uint32)


def _ints(limbs) -> list[int]:
    return bls.int_of_limbs(limbs)


def _exact_fold(points, row) -> tuple[int, int] | None:
    acc = None
    for i in np.flatnonzero(row):
        acc = aggsig._FP_OPS.add_affine(acc, points[i])
    return acc


# --- limbs and the field -----------------------------------------------------


def test_montgomery_radix_and_limbs_match_the_reference():
    assert bls.R_MONT == jb.R_MONT  # R = 2^384 on both sides
    rng = random.Random(1)
    vals = list(EDGES) + [rng.randrange(2**384) for _ in range(8)]
    limbs = bls.limbs_of_int(vals)
    assert limbs.shape == (12, len(vals)) and limbs.dtype == torch.int64
    assert _ints(limbs) == vals
    assert _ints(bls.to_i32(limbs)) == vals and torch.equal(bls.from_i32(bls.to_i32(limbs)), limbs)
    for v in vals[:3] + [rng.randrange(P) for _ in range(4)]:
        assert bls.to_mont(v) == jb.to_mont(v) and bls.from_mont(bls.to_mont(v)) == v
        assert bls.from_mont(v) == jb.from_mont(v)
    assert (P * bls.PINV32 + 1) % 2**32 == 0 and (P * bls.PINV16 + 1) % 2**16 == 0
    assert bls.THREADS == 32


def _operands(seed: int, n: int, b_top: int):
    rng = random.Random(seed)
    a = list(EDGES) + [rng.randrange(2 * P) for _ in range(n)]
    b = list(EDGES) + [rng.randrange(b_top) for _ in range(n)]
    return [x for x in a for _ in b], [y for _ in a for y in b]


@pytest.mark.parametrize("op", ["mont_mul", "add_mod", "sub_mod"])
def test_field_ops_match_the_reference(op):
    """Every pair of the edge residues and random [0, 2p) values (mont_mul's
    second operand up to 4p), fed to both packages through `convert`: the
    port's canonical result equals the reference's mod p and the exact
    integer answer."""
    a, b = _operands(7, 4, 4 * P if op == "mont_mul" else 2 * P)
    ja, jbb = _jax_limbs(a), _jax_limbs(b)
    ta, tb = convert.bls_fe_from_jax(np.asarray(ja)), convert.bls_fe_from_jax(np.asarray(jbb))
    assert _ints(ta) == a and _ints(tb) == b
    got = _ints(getattr(bls, op)(ta, tb))
    ref = [v % P for v in jb.int_of_limbs(np.asarray(getattr(jb, op)(ja, jbb)))]
    exact = {"mont_mul": lambda x, y: x * y * bls.R_INV % P,
             "add_mod": lambda x, y: (x + y) % P, "sub_mod": lambda x, y: (x - y) % P}[op]
    assert got == ref == [exact(x, y) for x, y in zip(a, b)]
    assert convert.bls_fe_to_jax(bls.limbs_of_int(got)).shape == (32, len(got))


def test_mont_sqr_is_zero_and_the_device_entry_on_cpu():
    rng = random.Random(11)
    vals = list(EDGES) + [rng.randrange(2 * P) for _ in range(6)]
    limbs = bls.limbs_of_int(vals)
    assert _ints(bls.mont_sqr(limbs)) == [v * v * bls.R_INV % P for v in vals]
    assert bls.is_zero_mod_p(limbs).tolist() == np.asarray(jb.is_zero_mod_p(_jax_limbs(vals))).tolist()
    assert bls.is_zero_mod_p(limbs).tolist() == [v % P == 0 for v in vals]
    i32 = bls.to_i32(limbs)
    out = bls.mont_mul_device(i32, i32.flip(1))
    assert out.dtype == torch.int32
    assert _ints(out) == [x * y * bls.R_INV % P for x, y in zip(vals, reversed(vals))]


# --- the group -----------------------------------------------------------------


def _jacobian(points, zs):
    """Affine integer points (None: the identity) -> Montgomery Jacobian
    (x z^2, y z^3, z) ints per coordinate."""
    cols = [[], [], []]
    for pt, z in zip(points, zs):
        x, y, z = (1, 1, 0) if pt is None else (pt[0] * z * z % P, pt[1] * z**3 % P, z)
        for c, v in zip(cols, (x, y, z)):
            c.append(bls.to_mont(v))
    return cols


def _lane_pairs():
    """Eight lanes of (p1, p2): generic, doubling (the same point, another
    Z), the inverse pair, p1 the identity, p2 the identity, both, and two
    more generic ones."""
    pts = [aggsig.decompress_g1(_key(i)) for i in range(1, 6)]
    neg = aggsig._g1_neg(pts[2])
    p1 = [pts[0], pts[1], pts[2], None, pts[3], None, pts[4], pts[0]]
    p2 = [pts[1], pts[1], neg, pts[3], None, None, pts[0], pts[4]]
    rng = random.Random(5)
    z1 = [rng.randrange(1, P) for _ in p1]
    z2 = [rng.randrange(1, P) for _ in p2]
    return p1, p2, _jacobian(p1, z1), _jacobian(p2, z2)


def _affine(jac_ints):
    out = []
    for x, y, z in zip(*jac_ints):
        x, y, z = bls.from_mont(x % P), bls.from_mont(y % P), bls.from_mont(z % P)
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, P)
        out.append((x * zi * zi % P, y * zi**3 % P))
    return out


@pytest.mark.parametrize("op", ["point_add", "point_dbl"])
def test_point_ops_match_jax_jit(op):
    """The same Jacobian inputs (made in the JAX package's limbs, carried
    across by `convert`) through `jax.jit` of the reference's function and
    the port's plain one: coordinates equal mod p lane for lane, the
    port's canonical; the affine results equal the exact group law."""
    p1, p2, j1, j2 = _lane_pairs()
    jp1 = tuple(_jax_limbs(c) for c in j1)
    jp2 = tuple(_jax_limbs(c) for c in j2)
    tp1 = tuple(convert.bls_point_from_jax(np.stack([np.asarray(c) for c in jp1])))
    tp2 = tuple(convert.bls_point_from_jax(np.stack([np.asarray(c) for c in jp2])))
    if op == "point_add":
        ref = jax.jit(jb.point_add)(jp1, jp2)
        got = bls.point_add(tp1, tp2)
        want = [aggsig._FP_OPS.add_affine(a, b) for a, b in zip(p1, p2)]
    else:
        ref = jax.jit(jb.point_dbl)(jp1)
        got = bls.point_dbl(tp1)
        want = [aggsig._FP_OPS.add_affine(a, a) for a in p1]
    ref_ints = [[v % P for v in jb.int_of_limbs(np.asarray(c))] for c in ref]
    got_ints = [_ints(c) for c in got]
    assert got_ints == ref_ints
    assert all(v < P for c in got_ints for v in c)
    assert _affine(got_ints) == want
    back = convert.bls_point_to_jax(torch.stack(got))
    assert [jb.int_of_limbs(c) for c in back] == got_ints


def test_point_madd_matches_the_exact_group_law():
    """The fold's mixed add on the lanes where `sel` is set (generic,
    doubling, inverse, identity accumulator), p1 elsewhere."""
    p1, _, j1, _ = _lane_pairs()
    qs = [aggsig.decompress_g1(_key(i)) for i in (2, 2, 7, 3, 8, 9, 5, 6)]
    qs[2] = aggsig._g1_neg(p1[2])  # the inverse of lane 2's accumulator
    qs[1] = p1[1]  # lane 1 doubles
    sel = torch.tensor([True, True, True, True, True, False, True, False])
    x2 = bls.limbs_of_int([bls.to_mont(q[0]) for q in qs])
    y2 = bls.limbs_of_int([bls.to_mont(q[1]) for q in qs])
    got = bls.point_madd(tuple(bls.limbs_of_int(c) for c in j1), x2, y2, sel)
    want = [aggsig._FP_OPS.add_affine(a, q) if s else a for a, q, s in zip(p1, qs, sel.tolist())]
    assert _affine([_ints(c) for c in got]) == want
    assert want[2] is None and want[3] == qs[3]
    assert [_ints(c)[5] for c in got] == [j1[0][5], j1[1][5], j1[2][5]]


# --- the table and the kernel's plain version -----------------------------------


def _reference_suite_tables():
    """tests/test_ops_bls.py's two shapes: 6 keys (a duplicate) x 5 bitmaps,
    and 2 keys (one undecodable) x 1 bitmap."""
    keys = [_key(i) for i in range(1, 6)]
    keys.append(keys[0])
    good = SCHEME.keypair_from_seed(b"\x07" * 32)[0]
    return [(keys, [0b000001, 0b011111, 0b100001, 0b111111, 0]), ([good, b"\x00" * 48], [0b10])]


@pytest.mark.parametrize("shape", [0, 1], ids=["6x5", "2x1"])
def test_committee_table_matches_jax(shape):
    keys, bitmaps = _reference_suite_tables()[shape]
    ref = jb.CommitteeTable(keys)
    table = bls.CommitteeTable(keys, device="cpu")
    assert table.device == torch.device("cpu")
    assert table.tx.is_contiguous() and table.ty.is_contiguous()  # as K6's checks require
    tx, ty, present = convert.bls_table_from_jax(np.asarray(ref.tx), np.asarray(ref.ty), np.asarray(ref.present))
    assert torch.equal(table.tx, tx) and torch.equal(table.ty, ty) and torch.equal(table.present, present)
    assert table.invalid.tolist() == list(ref.invalid) and table.points == ref.points
    assert table.index == ref.index and table.keys == ref.keys and table.size == ref.size
    got = table.aggregate_bitmaps(bitmaps)
    assert got == ref.aggregate_bitmaps(bitmaps)
    masks = table._masks_of_bitmaps(bitmaps)
    assert got == [_exact_fold(table.points, row) for row in masks]


def _special_table(n: int) -> tuple[list[bytes], dict]:
    """Phase 8's table of n keys (`bls_corpus.table_keys`): a duplicate, a
    key beside its negation, one undecodable key, and (n > 34) a duplicate
    and an inverse pair in one partial's lanes."""
    keys, _, lanes = bls_corpus.table_keys([SCHEME.keypair_from_seed(bytes([i + 1]) * 32) for i in range(n)], n)
    return keys, lanes


@pytest.mark.parametrize("n", [5, 7, 43, 64])
def test_aggregate_masks_equals_the_exact_fold(n):
    """Ragged widths (T = 32 partials divide none of them but 64) and the
    special lanes, in phase 8's rows (empty, all, one member, the special
    pairs, then quorums), against `_FP_OPS.add_affine` over the members."""
    keys, lanes = _special_table(n)
    table = bls.CommitteeTable(keys, device="cpu")
    assert table.invalid.tolist() == [i == n - 1 for i in range(n)]
    masks, labels = bls_corpus.bitmap_rows(n, n, lanes, 3 + len(lanes) + 4)
    got = table.aggregate_masks(masks)
    assert got == [_exact_fold(table.points, row) for row in masks]
    named = dict(zip(labels, got))
    assert named["empty"] is None and named["inverse"] is None and named["invalid"] is None
    dup = table.points[lanes["dup"][0]]
    assert named["dup"] == aggsig._FP_OPS.add_affine(dup, dup) and named["single"] is not None
    if "inverse_one_partial" in named:
        assert named["inverse_one_partial"] is None and named["dup_one_partial"] is not None


def test_g1_aggregate_wrapper_takes_the_plain_version_on_cpu():
    keys, _ = _special_table(7)
    table = bls.CommitteeTable(keys, device="cpu")
    mask = torch.from_numpy(np.random.default_rng(3).random((5, 7)) < 0.6)
    out = bls.g1_aggregate(table.tx, table.ty, table.present, mask)
    assert out.shape == (3, 12, 5) and out.dtype == torch.int32
    assert torch.equal(out, bls.g1_aggregate_plain(table.tx, table.ty, table.present, mask))
    empty = bls.g1_aggregate(table.tx, table.ty, table.present, mask[:0])
    assert empty.shape == (3, 12, 0)


def test_aggregate_masks_checks_and_counts():
    keys, _ = _special_table(5)
    c = {k: metrics.counter(k).value for k in ("bls.table_builds", "bls.aggregations", "bls.points_aggregated")}
    table = bls.CommitteeTable(keys, device="cpu")
    with pytest.raises(ValueError, match="mask width"):
        table.aggregate_masks(np.ones((1, 4), bool))
    for bad in (1 << 5, -1):
        with pytest.raises(ValueError, match="exceeds committee"):
            table.aggregate_bitmaps([bad])
    with pytest.raises(ValueError, match="at least one key"):
        bls.CommitteeTable([], device="cpu")
    one = table.aggregate_masks(np.array([True, True, False, False, False]))  # a 1-D mask is one row
    assert one == [_exact_fold(table.points, [1, 1, 0, 0, 0])]
    assert metrics.counter("bls.table_builds").value == c["bls.table_builds"] + 1
    assert metrics.counter("bls.aggregations").value == c["bls.aggregations"] + 1
    assert metrics.counter("bls.points_aggregated").value == c["bls.points_aggregated"] + 2


def test_verify_aggregate_verdicts_match_jax():
    """Two keys and a signature under their summed secret (as `bench.py
    --aggregate-ab` builds one): the right message, a wrong one, the empty
    bitmap, a bitmap with an undecodable lane and a malformed signature get
    the JAX package's verdicts."""
    pairs = [SCHEME.keypair_from_seed(bytes([i]) * 32) for i in (1, 2)]
    keys = [pk for pk, _ in pairs]
    msg = b"aggregate-qc digest"
    sig = SCHEME.sign(sum(sk for _, sk in pairs) % aggsig.R_ORDER, msg)
    table, ref = bls.CommitteeTable(keys, device="cpu"), jb.CommitteeTable(keys)
    cases = [(0b11, msg, sig), (0b11, b"another digest", sig), (0, msg, sig), (0b11, msg, b"\x00" * 96)]
    got = [table.verify_aggregate(*c) for c in cases]
    assert got == [ref.verify_aggregate(*c) for c in cases] == [True, False, False, False]
    bad_keys = [keys[0], b"\x00" * 48]
    assert bls.CommitteeTable(bad_keys, device="cpu").verify_aggregate(0b11, msg, sig) is False
    assert jb.CommitteeTable(bad_keys).verify_aggregate(0b11, msg, sig) is False
    assert jagg.exact_scheme().verify(keys, msg, sig)


# --- the affine conversion: the inversion chain and the affine entry ------------


def test_invert_plain_equals_pow():
    """z^(p - 2) over INV_WINDOWS on Montgomery limbs: z^-1 mod p for 0, 1,
    p - 1, mont(1) and seeded residues (0 goes to 0, as the kernel's chain
    takes it)."""
    rng = random.Random(16)
    zs = [0, 1, P - 1, bls.MONT_ONE] + [rng.randrange(1, P) for _ in range(8)]
    got = _ints(bls.invert_plain(bls.limbs_of_int([bls.to_mont(z) for z in zs])))
    assert got == [0] + [bls.to_mont(pow(z, -1, P)) for z in zs[1:]]
    assert all(v < P for v in got)


def test_inv_windows_are_p_minus_2_and_the_kernels_digits():
    """INV_WINDOWS recomposes to p - 2 with odd digits below 32, and equals
    the `__constant__` pairs of csrc/g1_aggregate.cu; chip_smoke.py's count
    of the chain's squarings and products (its bound) is the chain's."""
    e = 0
    for s, d in bls.INV_WINDOWS:
        e = (e << s) + d
    assert e == P - 2
    assert all(d % 2 == 1 and d < 2 * bls.INV_ODD for _, d in bls.INV_WINDOWS)
    src = (Path(bls.__file__).parent / "csrc" / "g1_aggregate.cu").read_text()
    body = re.search(r"INV_WINDOWS\[INV_STEPS\]\[2\] = \{(.*?)\};", src, re.S).group(1)
    pairs = tuple((int(a), int(b)) for a, b in re.findall(r"\{(\d+), (\d+)\}", body))
    assert pairs == bls.INV_WINDOWS
    assert int(re.search(r"INV_STEPS = (\d+);", src).group(1)) == len(pairs)
    squarings = sum(s for s, _ in bls.INV_WINDOWS[1:])
    assert chip_smoke.BLS_CHAIN_SQUARES == 1 + squarings
    assert chip_smoke.BLS_CHAIN_PRODUCTS == bls.INV_ODD - 1 + len(pairs) - 1


@pytest.mark.parametrize("n", [5, 7, 43, 64])
def test_g1_aggregate_affine_plain_matches_jax_and_the_exact_fold(n):
    """Phase 8's rows (empty, all, one member, the special pairs, then
    quorums) on its special table: the affine entry's plain version, read by
    `affine_of_limbs`, equals the JAX package's `aggregate_masks` and the
    exact fold; identity rows are flagged with zero limbs."""
    keys, lanes = _special_table(n)
    table = bls.CommitteeTable(keys, device="cpu")
    masks, _ = bls_corpus.bitmap_rows(n, n, lanes, 3 + len(lanes) + 2)
    limbs, identity = bls.g1_aggregate_affine_plain(table.tx, table.ty, table.present, torch.from_numpy(masks))
    assert limbs.shape == (2, 12, len(masks)) and limbs.dtype == torch.int32
    assert identity.shape == (len(masks),) and identity.dtype == torch.uint8
    got = bls.affine_of_limbs(limbs, identity)
    assert got == [_exact_fold(table.points, row) for row in masks]
    assert got == jb.CommitteeTable(keys).aggregate_masks(masks)
    assert identity.tolist() == [int(pt is None) for pt in got]
    assert not limbs[:, :, identity.bool()].any()


def test_g1_aggregate_affine_wrapper_takes_the_plain_version_on_cpu():
    keys, _ = _special_table(7)
    table = bls.CommitteeTable(keys, device="cpu")
    mask = torch.from_numpy(np.random.default_rng(4).random((5, 7)) < 0.6)
    limbs, identity = bls.g1_aggregate_affine(table.tx, table.ty, table.present, mask)
    want_limbs, want_identity = bls.g1_aggregate_affine_plain(table.tx, table.ty, table.present, mask)
    assert limbs.shape == (2, 12, 5) and identity.shape == (5,)
    assert torch.equal(limbs, want_limbs) and torch.equal(identity, want_identity)
    empty, none = bls.g1_aggregate_affine(table.tx, table.ty, table.present, mask[:0])
    assert empty.shape == (2, 12, 0) and none.shape == (0,)
    assert bls.affine_of_limbs(empty, none) == []


def test_affine_of_limbs_equals_affine_points():
    """The host's old conversion of the Jacobian sums and the affine entry's
    limbs read by `affine_of_limbs` give the same points, identities too."""
    keys, lanes = _special_table(43)
    table = bls.CommitteeTable(keys, device="cpu")
    masks, _ = bls_corpus.bitmap_rows(1, 43, lanes, 3 + len(lanes) + 3)
    rows = torch.from_numpy(masks)
    want = bls.affine_points(bls.g1_aggregate(table.tx, table.ty, table.present, rows))
    assert bls.affine_of_limbs(*bls.g1_aggregate_affine(table.tx, table.ty, table.present, rows)) == want
    assert None in want and table.aggregate_masks(masks) == want
