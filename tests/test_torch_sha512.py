"""The port's device hash (hotstuff_tpu_torch/ops/sha512.py, plain version
of kernel K2) against hashlib, exact Python integers and the JAX
package's `h_digits_on_device`, plus the host staging it pairs with.
Bit-exact: every replica must accept exactly the same signature set."""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.ops import sha512 as JS
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import sha512 as TS
from tests.common_torch_threads import one_torch_thread  # noqa: F401

RNG = random.Random(17)
L = TS.L


def _cols(rows_of_bytes, width=32):
    n = len(rows_of_bytes)
    return np.frombuffer(b"".join(rows_of_bytes), np.uint8).reshape(n, width).T.copy()


def test_constants_match_reference():
    assert TS.K64 == JS.K64 and TS.H0 == JS.H0 and TS.L == JS.L


def test_sha512_96_matches_hashlib_and_jax():
    B = 16
    rs = [RNG.randbytes(32) for _ in range(B)]
    as_ = [RNG.randbytes(32) for _ in range(B)]
    ms = [RNG.randbytes(32) for _ in range(B)]
    rs[0] = bytes(32)
    as_[1] = b"\xff" * 32
    ms[2] = b"\x80" * 32
    r, a, m = (_cols(x) for x in (rs, as_, ms))
    got = TS.sha512_96(torch.from_numpy(r), torch.from_numpy(a), torch.from_numpy(m))
    assert got.dtype == torch.uint8 and got.shape == (64, B)
    for i in range(B):
        assert bytes(got[:, i].tolist()) == hashlib.sha512(rs[i] + as_[i] + ms[i]).digest()
    ref = np.asarray(jax.jit(JS.sha512_96)(jnp.asarray(r), jnp.asarray(a), jnp.asarray(m)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.uint8))


def test_reduce_mod_l_exact():
    """The edge list of test_sha512_device.py plus 500 random 512-bit values
    (the same (64, 511) shape, so the JAX side shares its compile)."""
    vals = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2**252, 2**256 - 1, 2**512 - 1,
            (L << 134) + 5, (L << 259) - 1]
    vals += [RNG.randrange(2**512) for _ in range(500)]
    arr = np.array([list(v.to_bytes(64, "little")) for v in vals], np.uint8).T.copy()
    red = TS.reduce_mod_l(torch.from_numpy(arr))
    got = [int.from_bytes(bytes(red[:, i].tolist()), "little") for i in range(len(vals))]
    assert got == [v % L for v in vals]
    jred = np.asarray(jax.jit(JS.reduce_mod_l)(jnp.asarray(arr.astype(np.float32))))
    np.testing.assert_array_equal(red.numpy(), jred.astype(np.uint8))


def test_reduce_mod_l_random_sweep():
    """A wide seeded sweep of the port alone against Python ints (cheap:
    one batched call), biased towards multiples of L and byte edges."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (4096, 64), np.uint8)
    raw[:256] = 0xFF
    raw[:256, rng.integers(0, 64, 256)] = 0
    vals = [int.from_bytes(row.tobytes(), "little") for row in raw]
    for i in range(256, 512):
        k = int(rng.integers(1, 2**62)) << int(rng.integers(0, 190))
        vals[i] = min(k * L + int(rng.integers(-3, 3)), 2**512 - 1) % 2**512
    arr = np.array([list(v.to_bytes(64, "little")) for v in vals], np.uint8).T.copy()
    red = TS.reduce_mod_l(torch.from_numpy(arr)).numpy()
    got = [int.from_bytes(red[:, i].tobytes(), "little") for i in range(len(vals))]
    assert got == [v % L for v in vals]


def _edge_and_sweep_values():
    """The edge list of test_reduce_mod_l_exact and values around multiples
    of L, where the reduction's last fold goes negative."""
    vals = [0, 1, L - 1, L, L + 1, 2 * L - 1, 2**252, 2**256 - 1, 2**512 - 1,
            (L << 134) + 5, (L << 259) - 1]
    vals += [(k * L + d) % 2**512 for k in (1, 2, 3, 2**100, 2**259 - 1) for d in (-2, -1, 0, 1)]
    rng = random.Random(23)
    vals += [rng.randrange(2**512) for _ in range(200)]
    return vals


def _value_rows(vals):
    return torch.from_numpy(np.array([list(v.to_bytes(64, "little")) for v in vals], np.uint8).T.copy())


def test_column_bounds_below_int64():
    """The largest |column| of each fold, from the limb ranges the folds
    read: well inside int64 (the card accumulates them in int64 too)."""
    bounds = TS.column_bounds()
    assert set(bounds) == {"fold1", "fold2", "fold3"}
    assert max(bounds.values()) < 2**63
    assert bounds["fold1"] < 2**58 and bounds["fold2"] < 2**58 and bounds["fold3"] < 2**35
    assert TS.C_LIMBS == tuple((TS.C >> (28 * i)) & (2**28 - 1) for i in range(5))
    assert sum(c << (28 * i) for i, c in enumerate(TS.C_LIMBS)) == L - 2**252


def test_limb_ranges_hold_at_the_edges():
    """Every fold's limbs stay inside LIMB_RANGES (what column_bounds
    assumes), the result limbs are canonical, and both sides of the final
    conditional add of L are taken."""
    vals = _edge_and_sweep_values()
    st = TS._reduce_stages(TS._le_words(_value_rows(vals)))
    for name, ((lo_min, lo_max), (top_min, top_max)) in TS.LIMB_RANGES.items():
        limbs = st[name]
        low = torch.stack(limbs[:-1])
        assert int(low.min()) >= lo_min and int(low.max()) <= lo_max, name
        assert int(limbs[-1].min()) >= top_min and int(limbs[-1].max()) <= top_max, name
    assert [len(st[k]) for k in "xyzwh"] == [19, 14, 10, 10, 10]
    assert 0 < int((st["w"][9] == -1).sum()) < len(vals)
    got = [sum(st["h"][k][i].item() << (28 * k) for k in range(10)) for i in range(len(vals))]
    assert got == [v % L for v in vals]


def test_reduce_mod_l_device_on_cpu():
    """The wrapper of the kernel's test entry takes `reduce_mod_l` on CPU
    tensors; both agree with Python ints on the edge values."""
    vals = _edge_and_sweep_values()
    x = _value_rows(vals)
    got = TS.reduce_mod_l_device(x)
    assert got.dtype == torch.uint8 and got.shape == (32, len(vals))
    assert torch.equal(got, TS.reduce_mod_l(x))
    assert [int.from_bytes(bytes(got[:, i].tolist()), "little") for i in range(len(vals))] == [v % L for v in vals]


def test_h_digits_matches_jax_and_host_staging():
    B = 32
    rs = [RNG.randbytes(32) for _ in range(B)]
    as_ = [RNG.randbytes(32) for _ in range(B)]
    ms = [RNG.randbytes(32) for _ in range(B)]
    r, a, m = (torch.from_numpy(_cols(x)) for x in (rs, as_, ms))
    got = TS.h_digits(r, a, m)  # CPU tensors: the plain version
    assert torch.equal(got, TS.h_digits_plain(r, a, m))
    ref = np.asarray(jax.jit(JS.h_digits_on_device)(*(jnp.asarray(t.numpy()) for t in (r, a, m))))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.uint8))
    for i in range(B):
        h = int.from_bytes(hashlib.sha512(rs[i] + as_[i] + ms[i]).digest(), "little") % L
        assert got[:, i].tolist() == [(h >> (4 * d)) & 15 for d in range(64)]


def test_nibble_rows():
    b = torch.from_numpy(np.arange(64, dtype=np.uint8).reshape(32, 2) * 7)
    out = TS.nibble_rows(b)
    assert out.shape == (64, 2)
    assert torch.equal(out[0::2], b & 15) and torch.equal(out[1::2], b >> 4)
    np.testing.assert_array_equal(out.numpy(), jed._nibbles(b.numpy().T.copy()).astype(np.uint8))


def test_host_staging_matches_reference():
    n = 12
    msgs = [RNG.randbytes(32) for _ in range(n)]
    keys = [RNG.randbytes(32) for _ in range(n)]
    sigs = [RNG.randbytes(64) for _ in range(n)]
    # s edges around L
    for i, s in enumerate([0, L - 1, L, L + 1, 2**256 - 1]):
        sigs[i] = sigs[i][:32] + s.to_bytes(32, "little")
    ours = ted.prepare_batch_packed_dh(msgs, keys, sigs)
    ref = jed.prepare_batch_packed_dh(msgs, keys, sigs)
    np.testing.assert_array_equal(ours["packed"], ref["packed"])
    np.testing.assert_array_equal(ours["s_ok"], ref["s_ok"])
    assert ours["s_ok"][:5].tolist() == [True, True, False, False, False]
    long_msgs = [m + b"!" for m in msgs]
    ours = ted.prepare_batch_packed(long_msgs, keys, sigs)
    ref = jed.prepare_batch_packed(long_msgs, keys, sigs, allow_native=False)
    np.testing.assert_array_equal(ours["packed"], ref["packed"])
    np.testing.assert_array_equal(ours["s_ok"], ref["s_ok"])


def test_h_digits_gather_plain_matches_jax():
    """K2g's plain version against the JAX committee path's gather
    (`jnp.take(keys_u8, idx, axis=1)`) + `h_digits_on_device`, at the B = 32
    shape of test_h_digits_matches_jax_and_host_staging; out-of-range
    indices give all-zero digits."""
    B, n = 32, 5
    rng = np.random.default_rng(11)
    r, m = (rng.integers(0, 256, (32, B), np.uint8) for _ in range(2))
    keys = rng.integers(0, 256, (32, n), np.uint8)
    idx = rng.integers(0, n, B).astype(np.int32)
    oob = [3, 17, 31]
    idx[oob] = [-1, n, 2**31 - 1]
    got = TS.h_digits_gather_plain(*(torch.from_numpy(t) for t in (r, keys, idx, m)))
    safe = np.clip(idx, 0, n - 1)
    a = np.asarray(jnp.take(jnp.asarray(keys), jnp.asarray(safe), axis=1))
    ref = np.asarray(jax.jit(JS.h_digits_on_device)(jnp.asarray(r), jnp.asarray(a), jnp.asarray(m)))
    ref = ref.astype(np.uint8)
    ref[:, oob] = 0
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[:, oob].any()
