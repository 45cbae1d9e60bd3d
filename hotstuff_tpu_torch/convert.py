"""Carry state across from the JAX package: its numpy arrays -> the port's
tensors and back.

The JAX package keeps a field element as (32, B) float32 radix-256 limbs
(exact integers, not necessarily normalized); the port keeps (NL, B)
integer limbs of radix 2^25.5 (`ops/field.py`). Conversions go through the
exact value of each column and reduce mod p, so any representative on
either side converts to the same element. Tests use these to feed the
same intermediates to both packages. numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

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


def table_from_jax(ypx: np.ndarray, ymx: np.ndarray, z: np.ndarray, t2d: np.ndarray) -> torch.Tensor:
    """The (16, 32, B) x4 cached -A table of `_build_neg_a_table`
    -> (4, 16, NL, B) int32 port table."""
    return torch.stack([
        torch.stack([field_from_jax(comp[k]) for k in range(comp.shape[0])])
        for comp in (ypx, ymx, z, t2d)
    ])


def base_table_from_jax(base_table) -> torch.Tensor:
    """`BASE_TABLE`, three (32, 16) f32 arrays of k*B -> (3, 16, NL) int32."""
    return torch.stack([field_from_jax(np.asarray(t)).T for t in base_table])


def digits_from_jax(digits: np.ndarray) -> torch.Tensor:
    """(64, B) f32 4-bit digits -> (64, B) uint8."""
    return torch.from_numpy(np.asarray(digits).astype(np.uint8))
