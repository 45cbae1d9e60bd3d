"""The port's radix-2^12 field (`hotstuff_tpu_torch/ops/field12.py`, the
plain version of kernel K8) against the JAX package's
`hotstuff_tpu/ops/field12.py`, limb for limb (tolerance 0: uint32 integer
limbs), and the reference's value contract (tests/test_field12.py) against
Python ints on the port's side.

Inputs are made from a seed with numpy as the reference's (22, B) uint32
limbs and carried into the port by `convert.field12_from_jax`; outputs come
back through `convert.field12_to_numpy`. The JAX side traces two functions
at B = 64: every compared function in one jitted tuple, and the chain step
of tests/test_field12.py:58-77. The tests of K8's partition (at the end)
trace nothing.
"""

import random
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import field12 as jf12
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.ops import field12 as f12
from tests.common_torch_threads import one_torch_thread  # noqa: F401

P = f12.P
B = 64
CHAIN_STEPS = 8


def _ints_to_limbs(vals) -> np.ndarray:
    return np.concatenate([jf12.limbs_of_int(v) for v in vals], axis=1)


def _inputs() -> dict:
    """numpy (22, B) / (46, B) uint32 operands, from one seed."""
    rng = np.random.default_rng(14)
    edge = [0, 1, P - 1, (1 << 255) - 20, P, 2 * P, (1 << 264) - 1, 500 * P + 7]
    vals = edge + [int.from_bytes(rng.bytes(33), "little") % (1 << 264) for _ in range(B - len(edge))]
    a = _ints_to_limbs([v % P for v in vals])
    b = rng.integers(0, f12.RADIX, (f12.NLIMB, B), dtype=np.uint32)
    return dict(
        a=a, b=b,
        c264=_ints_to_limbs(vals),  # canonical's whole domain
        raw=rng.integers(0, 2**30, (f12.NLIMB, B), dtype=np.uint32),  # carry's input bound
        rows=rng.integers(0, 2**32, (2 * f12.NLIMB + 2, B), dtype=np.uint64).astype(np.uint32),
        big=rng.integers(0, 2**32, (f12.NLIMB, B), dtype=np.uint64).astype(np.uint32),  # sub wraps
    )


def _step_jax(x):
    y = jf12.sqr(x)
    z = jf12.mul(x, y)
    w = jf12.sub(jf12.add(z, y), x)
    return jf12.mul(w, w)


def _step_port(x):
    y = f12.sqr(x)
    z = f12.mul(x, y)
    w = f12.sub(f12.add(z, y), x)
    return f12.mul(w, w)


CASES = {  # name -> (JAX function, port function, operand names)
    "mul": (jf12.mul, f12.mul, ("a", "b")),
    "sqr": (jf12.sqr, f12.sqr, ("a",)),
    "sub_of_add": (lambda x, y: jf12.sub(jf12.add(x, y), y), lambda x, y: f12.sub(f12.add(x, y), y), ("a", "b")),
    "sub_wrapping": (jf12.sub, f12.sub, ("a", "big")),
    "carry": (jf12.carry, f12.carry, ("raw",)),
    "_reduce": (jf12._reduce, f12._reduce, ("rows",)),
    "sqr_n_3": (lambda x: jf12.sqr_n(x, 3), lambda x: f12.sqr_n(x, 3), ("a",)),
    "canonical": (jf12.canonical, f12.canonical, ("c264",)),
    "canonical_of_mul": (lambda x, y: jf12.canonical(jf12.mul(x, y)), lambda x, y: f12.canonical(f12.mul(x, y)),
                         ("a", "b")),
}


@pytest.fixture(scope="module")
def reference():
    """The inputs and the JAX package's outputs of every case (one trace)."""
    ins = _inputs()
    fn = jax.jit(lambda ops: {name: jfn(*(ops[k] for k in keys)) for name, (jfn, _, keys) in CASES.items()})
    out = fn(ins)
    return ins, {name: np.asarray(v) for name, v in out.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_jax_limb_for_limb(reference, name):
    ins, want = reference
    _, port_fn, keys = CASES[name]
    got = port_fn(*(convert.field12_from_jax(ins[k]) for k in keys))
    assert got.dtype == torch.int32 and tuple(got.shape) == want[name].shape
    np.testing.assert_array_equal(convert.field12_to_numpy(got), want[name])


def test_chain_step_equals_jax_eight_times(reference):
    ins, _ = reference
    step = jax.jit(_step_jax)
    x_j, x_p = ins["a"], convert.field12_from_jax(ins["a"])
    for _ in range(CHAIN_STEPS):
        x_j, x_p = np.asarray(step(x_j)), _step_port(x_p)
        np.testing.assert_array_equal(convert.field12_to_numpy(x_p), x_j)


def test_convert_round_trip_is_bit_exact():
    top = np.array([[0, 1, 2**31 - 1, 2**31, 2**32 - 1]] * f12.NLIMB, np.uint32)
    t = convert.field12_from_jax(top)
    assert t.dtype == torch.int32 and int(t[0, 3]) == -2**31
    np.testing.assert_array_equal(convert.field12_to_numpy(t), top)
    with pytest.raises(ValueError):
        convert.field12_from_jax(np.zeros(22, np.uint32))


def test_module_constants_match_the_reference():
    for name in ("P", "NLIMB", "BITS", "RADIX", "MASK", "FOLD"):
        assert getattr(f12, name) == getattr(jf12, name), name
    for name in ("BIAS", "P_COMPLEMENT", "ZERO", "ONE"):
        np.testing.assert_array_equal(getattr(f12, name), getattr(jf12, name))
    assert (f12.MUL_PRODUCTS, f12.SQR_PRODUCTS) == (484, 253)


def test_products_counted_by_the_plain_versions():
    x = f12.tensor_of_ints([3, 5])
    f12.PRODUCTS.n = 0
    f12.mul(x, x)
    f12.sqr_n(x, 2)
    assert f12.PRODUCTS.n == 484 + 2 * 253


# --- the reference's value contract (tests/test_field12.py) on the port ----

RNG = random.Random(41)


def _vals(n, lo=0, hi=P):
    return [0, 1, P - 1, (1 << 255) - 20] + [RNG.randrange(lo, hi) for _ in range(n - 4)]


def test_roundtrip():
    vals = _vals(32)
    assert f12.int_of_limbs(f12.tensor_of_ints(vals)) == vals


def test_mul_and_sqr_exact_mod_p():
    a_v, b_v = _vals(64), _vals(64)
    a, b = f12.tensor_of_ints(a_v), f12.tensor_of_ints(b_v)
    for g, x, y in zip(f12.int_of_limbs(f12.mul(a, b)), a_v, b_v):
        assert g % P == x * y % P
    for g, x in zip(f12.int_of_limbs(f12.sqr(a)), a_v):
        assert g % P == x * x % P


def test_add_sub_roundtrip():
    a_v, b_v = _vals(48), _vals(48)
    a, b = f12.tensor_of_ints(a_v), f12.tensor_of_ints(b_v)
    for g, v in zip(f12.int_of_limbs(f12.sub(f12.add(a, b), b)), a_v):
        assert g % P == v


def test_mul_chain_stays_exact():
    vals = _vals(32)
    x, want = f12.tensor_of_ints(vals), list(vals)
    for _ in range(CHAIN_STEPS):
        x = _step_port(x)
        want = [((v * v * v + v * v - v) ** 2) % P for v in want]
    assert [g % P for g in f12.int_of_limbs(x)] == want


def test_canonical_on_the_264_bit_domain():
    vals = _vals(48) + [P, P + 1, 2 * P - 1, 2 * P, (1 << 264) - 1, 500 * P + 7]
    vals += [RNG.randrange(1 << 264) for _ in range(64)]
    out = f12.canonical(f12.tensor_of_ints(vals))
    assert int(out.max()) <= f12.MASK and int(out.min()) >= 0
    assert f12.int_of_limbs(out) == [v % P for v in vals]


def test_canonical_of_real_mul_outputs():
    a_v, b_v = _vals(64), _vals(64)
    a, b = f12.tensor_of_ints(a_v), f12.tensor_of_ints(b_v)
    out = f12.canonical(f12.mul(a, b))
    assert f12.int_of_limbs(out) == [x * y % P for x, y in zip(a_v, b_v)]
    assert bool(f12.eq_canonical(out, f12.canonical(f12.mul(b, a))).all())


def test_normalized_bounds():
    vals = _vals(64)
    out = f12.mul(f12.tensor_of_ints(vals), f12.tensor_of_ints(vals[::-1]))
    assert int(out[0].max()) <= f12.RADIX + f12.FOLD + 64
    assert int(out[1:].max()) <= f12.RADIX + 64


# --- K8's split of the products over four threads (csrc/field12.cu) --------
#
# Pure Python on numpy uint32 (wrapping as the card's 32-bit IMADs do): no
# JAX trace. The table is read from the CUDA source, so these tests hold the
# partition the kernel compiles.

F12_SOURCE = (Path(f12.__file__).parent / "csrc" / "field12.cu").read_text()
HALO = int(re.search(r"#define F12_HALO (\d+)", F12_SOURCE).group(1))
N, ROWS = f12.NLIMB, 2 * f12.NLIMB + 2


def _owner_of_rows(part) -> dict:
    """row -> the threads holding it: column pair k of thread g is rows k and
    22 + k; thread 0 also holds rows 44 and 45 (carries only)."""
    owners = {}
    for g in range(len(part) - 1):
        for k in range(part[g], part[g + 1]):
            for r in (k, N + k):
                owners.setdefault(r, []).append(g)
    for r in (2 * N, 2 * N + 1):
        owners.setdefault(r, []).append(0)
    return owners


def _reference_products(sq: bool) -> list:
    """(row, i, j) of every product of the reference's column sums:
    `sqr` (field12.py:147-155) a_i^2 and (2 a_i) a_j for i < j, `mul` a_i b_j."""
    return [(i + j, i, j) for i in range(N) for j in range(i if sq else 0, N)]


def test_k8_partition_gives_each_row_and_product_to_one_thread():
    part = f12.kernel_partition()
    assert part[0] == 0 and part[-1] == N and list(part) == sorted(part) and len(part) == 5
    owners = _owner_of_rows(part)
    assert sorted(owners) == list(range(ROWS)) and all(len(g) == 1 for g in owners.values())
    layout = f12.kernel_layout()
    assert layout["threads_per_lane"] == 4
    assert [sorted(rs) for rs in layout["rows"]] == [sorted(r for r, g in owners.items() if g == [t])
                                                     for t in range(4)]
    for sq, total, key in ((True, 253, "sqr_products"), (False, 484, "mul_products")):
        prods = _reference_products(sq)
        assert len(prods) == total
        per_thread = [sum(1 for r, _, _ in prods if owners[r] == [g]) for g in range(4)]
        assert sum(per_thread) == total and per_thread == layout[key]
        mean = total / 4
        assert all(abs(n - mean) <= 0.15 * mean for n in per_thread), (key, per_thread)


def _passes(vals: list, wrap_at: int = -1) -> list:
    """Three carry passes over a run of rows (uint32 arrays): row k takes row
    k - 1's carry, times FOLD at `wrap_at`; the first row takes none."""
    c = list(vals)
    for _ in range(3):
        hi = [v >> np.uint32(f12.BITS) for v in c]
        c = [v & np.uint32(f12.MASK) for v in c]
        for k in range(1, len(c)):
            c[k] = c[k] + (np.uint32(f12.FOLD) if k == wrap_at else np.uint32(1)) * hi[k - 1]
    return c


def _split_product(a: list, b: list, sq: bool, part, halo: int = HALO) -> list:
    """One product as K8's four threads compute it: each thread's column
    sums of its rows (published: the first exchange), the three passes over
    each of its bands with the `halo` raw rows below it, the fold of its
    limbs (published: the second exchange), the three wrapping passes over
    its limbs with the `halo` folded limbs below them; returns the 22 limbs
    (the gather)."""
    zero = np.zeros_like(a[0])
    owners = _owner_of_rows(part)
    published = {}
    for r, i, j in _reference_products(sq):
        x = (a[i] + a[i] if i < j else a[i]) * a[j] if sq else a[i] * b[j]
        assert len(owners[r]) == 1  # one thread sums row r whole
        published[r] = published.get(r, zero) + x
    raw = lambda r: published.get(r, zero) if r >= 0 else zero  # rows 43-45 hold no products
    fold = np.uint32(f12.FOLD)
    folded = {}
    for g in range(4):
        l0, l1 = part[g], part[g + 1]
        chains = [range(l0 - halo, l1), range(N + l0 - halo, N + l1)] + ([range(2 * N - halo, ROWS)] if g == 0 else [])
        c3 = {}
        for rows in chains:  # the first rows of a chain come out short; only its own are read
            c3.update(zip(rows, _passes([raw(r) for r in rows])))
        for k in range(l0, l1):
            u = c3[N + k] + (fold * c3[2 * N + k] if k < 2 else zero)  # rows 44-45 into 22-23
            folded[k] = c3[k] + fold * u
    limbs = [None] * N
    for g in range(4):
        ks = range(part[g] - halo, part[g + 1])  # below limb 0: limbs 22 + k
        wrapped = _passes([folded[k % N] for k in ks], wrap_at=list(ks).index(0) if 0 in ks[1:] else -1)
        for k, v in zip(ks, wrapped):
            if k >= part[g]:
                limbs[k] = v
    return limbs


def _limbs(t: torch.Tensor) -> list:
    return list(convert.field12_to_numpy(t))


@pytest.fixture(scope="module")
def split_inputs():
    """chip_smoke.field12_inputs at 128 seeded lanes (the edges first)."""
    import chip_smoke

    lanes, chip_smoke.LANES = chip_smoke.LANES, 128
    try:
        t, _ = chip_smoke.field12_inputs(0, "cpu")
    finally:
        chip_smoke.LANES = lanes
    return t


SPLIT_CASES = {  # name -> (operands, squarings; 0: one product)
    "mul": (("x", "y"), 0),
    "mul lazy": (("lazy", "m2"), 0),
    "sqr": (("x",), 1),
    "sqr lazy": (("lazy",), 1),
    "sqr_n 6 of products": (("m1",), 6),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_k8_split_schedule_equals_the_plain_version(split_inputs, name):
    """The split schedule, limb for limb, against `mul_plain` / `sqr_n_plain`
    on 128 seeded lanes with phase 10's edge inputs."""
    keys, n = SPLIT_CASES[name]
    ops = [split_inputs[k] for k in keys]
    part = f12.kernel_partition()
    if n == 0:
        want, got = f12.mul_plain(*ops), _split_product(_limbs(ops[0]), _limbs(ops[1]), False, part)
    else:
        want, got = f12.sqr_n_plain(ops[0], n), _limbs(ops[0])
        for _ in range(n):
            got = _split_product(got, got, True, part)
    np.testing.assert_array_equal(np.stack(got), convert.field12_to_numpy(want))


def test_k8_halo_covers_the_carry_passes():
    """Row k after three carry passes reads rows k - 3 .. k and no fewer: a
    run that starts three rows below row k gives it as the whole run does,
    one that starts two rows below does not. So F12_HALO is three rows
    before the fold, and three folded limbs before the wrapping passes."""
    run = [np.array([v], np.uint32) for v in (0xFFFFFFFF, 0xFFFFFFFF, 4095, 4095, 4095)]
    whole = _passes(run)[-1]
    assert _passes(run[1:])[-1] == whole and _passes(run[2:])[-1] != whole
    assert HALO == 3
