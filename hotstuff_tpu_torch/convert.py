"""Carry state across from the JAX package: its numpy arrays -> the port's
tensors and back.

The JAX package keeps a field element as (32, B) float32 radix-256 limbs
(exact integers, not necessarily normalized); the port keeps (NL, B)
integer limbs of radix 2^25.5 (`ops/field.py`). Conversions go through the
exact value of each column and reduce mod p, so any representative on
either side converts to the same element. Tests use these to feed the
same intermediates to both packages. numpy and torch only.

The f32-argument form (`kernel_args_from_jax`): the reference keeps the
verifier's separate arguments as float32 arrays of byte, digit and bit
values; the port keeps the same values as uint8.

BLS12-381 (`ops/bls.py`): the JAX package keeps an Fp residue as (32, B)
uint32 digits of 12 bits, the port as (12, B) limbs of 32 bits (int32 bit
patterns in tables and kernel outputs). Both are Montgomery residues with
R = 2^384, so a residue is the same integer on both sides and converts by
repacking its bits, unreduced: the reference's [0, 2p) values arrive as
they are, and the plain field functions take them. The port's key table is
(12, N) int32 limbs of mont(x) and mont(y) beside an (N,) bool `present`,
the reference's layout with wider limbs.

The radix-2^12 field (`ops/field12.py`): both packages keep (22, B) uint32
limbs; the port's tensors are int32 of the same bits, so the limbs cross
bit for bit, unreduced.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import bls
from .ops import field as f


def _values_of_radix256(limbs: np.ndarray) -> list[int]:
    arr = np.asarray(limbs, np.float64)
    return [
        sum(int(arr[i, b]) << (8 * i) for i in range(arr.shape[0]))
        for b in range(arr.shape[1])
    ]


def field_from_jax(limbs32: np.ndarray) -> torch.Tensor:
    """(32, B) f32 radix-256 limbs -> (NL, B) int32 canonical port limbs."""
    return f.limbs_of_int([v % f.P for v in _values_of_radix256(limbs32)]).to(torch.int32)


def field_to_jax(limbs: torch.Tensor) -> np.ndarray:
    """(NL, B) port limbs (any representative) -> (32, B) f32 canonical
    radix-256 limbs."""
    vals = [v % f.P for v in f.int_of_limbs(limbs)]
    out = np.zeros((32, len(vals)), np.float32)
    for b, v in enumerate(vals):
        out[:, b] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return out


def table_from_jax(*components: np.ndarray) -> torch.Tensor:
    """(16, 32, B) f32 component tables — the four of `_build_neg_a_table`'s
    cached -A table, or the three of a committee table — -> (C, 16, NL, B)
    int32 canonical port table."""
    return torch.stack([
        torch.stack([field_from_jax(comp[k]) for k in range(comp.shape[0])])
        for comp in map(np.asarray, components)
    ])


def base_table_from_jax(base_table) -> torch.Tensor:
    """`BASE_TABLE`, three (32, 16) f32 arrays of k*B -> (3, 16, NL) int32."""
    return torch.stack([field_from_jax(np.asarray(t)).T for t in base_table])


def committee_table_from_jax(ct) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's `CommitteeTable` (its `ta_ypx` / `ta_ymx` /
    `ta_xy2d` (16, 32, N) f32 tables, `valid`, `keys_u8`) -> the port's
    (entries (N, 16, 3, NL) int32 canonical, valid (N,) bool, keys_u8
    (32, N) uint8), as `ops/ed25519.CommitteeTable` holds them."""
    ta = table_from_jax(ct.ta_ypx, ct.ta_ymx, ct.ta_xy2d)  # (3, 16, NL, N)
    valid = torch.from_numpy(np.asarray(ct.valid, bool).copy())
    keys_u8 = torch.from_numpy(np.asarray(ct.keys_u8, np.uint8).copy())
    return ta.permute(3, 1, 0, 2).contiguous(), valid, keys_u8


def digits_from_jax(digits: np.ndarray) -> torch.Tensor:
    """(64, B) f32 4-bit digits -> (64, B) uint8."""
    return torch.from_numpy(np.asarray(digits).astype(np.uint8))


def kernel_args_from_jax(args, kernel: str = "w4") -> tuple[torch.Tensor, ...]:
    """The reference's f32 `kernel_args` tuple (a_y (32, W), a_sign (W,),
    r_enc (32, W), s and h as (64, W) digits or, for `kernel="bits"`,
    (253, W) bits; float32 arrays of exact small integers) -> the port's
    uint8 tensors of `ladder.verify_args`, the same values."""
    rows = 253 if kernel == "bits" else 64
    out = []
    for a, want in zip(args, (32, None, 32, rows, rows)):
        arr = np.asarray(a)
        u8 = arr.astype(np.uint8)
        if not np.array_equal(u8, arr) or (want is not None and arr.shape[0] != want):
            raise ValueError(f"not a {kernel} kernel argument of exact bytes: shape {arr.shape}")
        out.append(torch.from_numpy(u8))
    return tuple(out)


def _bls_repack(limbs: np.ndarray, bits_in: int, bits_out: int, n_out: int) -> list[list[int]]:
    """(n_in, B) digits of `bits_in` -> B columns of n_out digits of
    `bits_out`, the same integers."""
    arr = np.asarray(limbs).astype(np.uint64)
    out = []
    for b in range(arr.shape[1]):
        v = sum(int(arr[i, b]) << (bits_in * i) for i in range(arr.shape[0]))
        assert v < 1 << (bits_out * n_out), "residue does not fit 384 bits"
        out.append([(v >> (bits_out * i)) & ((1 << bits_out) - 1) for i in range(n_out)])
    return out


def bls_fe_from_jax(limbs: np.ndarray) -> torch.Tensor:
    """(32, B) uint32 12-bit digits -> (12, B) int64 limbs of 32 bits, the
    same integers (the plain field functions' operands)."""
    return torch.tensor(_bls_repack(limbs, 12, 32, bls.NLIMB), dtype=torch.int64).reshape(-1, bls.NLIMB).T.contiguous()


def bls_fe_to_jax(limbs: torch.Tensor) -> np.ndarray:
    """(12, B) limbs (int64 values or int32 bit patterns) -> (32, B) uint32
    12-bit digits, the same integers."""
    vals = bls.from_i32(limbs).numpy()
    return np.asarray(_bls_repack(vals, 32, 12, 32), np.uint32).T.reshape(32, -1)


def bls_table_from_jax(tx, ty, present) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX `CommitteeTable`'s (32, N) `tx`, `ty` digits and (N,)
    `present` -> the port's (12, N) int32 `tx`, `ty` and (N,) bool
    `present`, as `ops/bls.py:CommitteeTable` holds them."""
    return (bls.to_i32(bls_fe_from_jax(tx)), bls.to_i32(bls_fe_from_jax(ty)),
            torch.from_numpy(np.asarray(present, bool).copy()))


def bls_point_from_jax(pt) -> torch.Tensor:
    """Jacobian (X, Y, Z), each (32, B) 12-bit digits (or one (3, 32, B)
    array) -> (3, 12, B) int64 limbs, the plain point functions'
    operands."""
    return torch.stack([bls_fe_from_jax(c) for c in pt])


def bls_point_to_jax(pt: torch.Tensor) -> np.ndarray:
    """(3, 12, B) limbs (int64 values or int32 bit patterns) -> (3, 32, B)
    uint32 12-bit digits."""
    return np.stack([bls_fe_to_jax(c) for c in pt])


def field12_from_jax(limbs: np.ndarray) -> torch.Tensor:
    """(22, B) uint32 radix-2^12 limbs (or `_reduce`'s (46, B) product
    rows) -> an int32 tensor of the same shape and bits."""
    arr = np.ascontiguousarray(np.asarray(limbs, np.uint32))
    if arr.ndim != 2:
        raise ValueError(f"expected (rows, B) limbs, got shape {arr.shape}")
    return torch.from_numpy(arr.view(np.int32).copy())


def field12_to_numpy(t: torch.Tensor) -> np.ndarray:
    """(22, B) port limbs (int32 bits, or int64 values below 2^32) -> (22, B)
    uint32 numpy limbs, the reference's layout."""
    return f.from_i32(t.detach().cpu()).numpy().astype(np.uint32)
