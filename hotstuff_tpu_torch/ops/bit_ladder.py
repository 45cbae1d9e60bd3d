"""The 253-step bit ladder [s]B + [h](-A) — kernel K7 — the ladder of the
f32-argument verifier's `kernel="bits"`.

Counterpart of the ladder in `hotstuff_tpu/ops/ed25519.py:_verify_kernel`
(`:599-626`, jitted as `_verify_jit`): from the identity, for bit i = 252
down to 0, a doubling, then a mixed add of B where bit i of s is set and a
mixed add of -A where bit i of h is set. The plain version takes the
reference's form (both adds on every lane, then a per-lane select), and so
does the kernel, four threads a signature on `csrc/quad.cuh`: a quad may
not skip an add its warp runs, so it keeps the same limbs by the same
select.

-A's affine precomp (y+x, y-x, 2d*x*y) is entry 1 of K3's cached table
(k = 1, Z = 1): components 0, 1 and 3 of `ed.build_neg_a_table`'s output,
equal mod p to the (na_ypx, na_ymx, na_xy2d) that `_verify_kernel` builds.
B's is entry 1 of the shared k*B table.

Only bits 0..252 are read: for s >= 2^253 the raw mask follows s mod 2^253,
as the reference's does; the host's s < L check rejects those lanes.
"""

from __future__ import annotations

import torch

from . import _build
from . import ed25519 as ed
from . import field as f


def _select_point(mask: torch.Tensor, a: ed.Point, b: ed.Point) -> ed.Point:
    return tuple(f.select(mask, x, y) for x, y in zip(a, b))


def bit_ladder_plain(s_bits: torch.Tensor, h_bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(253, B) uint8 bits of s and h (row i = bit i), (4, 16, NL, B) int32
    -A table (entry 1 read) -> (4, NL, B) int32 extended point (X, Y, Z, T)."""
    batch = s_bits.shape[1]
    dev = s_bits.device
    base = f.const("base_table", ed.BASE_TABLE, dev).long()
    b_ypx, b_ymx, b_xy2d = (base[c, 1].view(f.NL, 1).expand(f.NL, batch) for c in range(3))
    na = table[:, 1].long()  # (4, NL, B): y+x, y-x, z = 1, 2d*t
    acc = ed.point_identity(batch, dev)
    for i in range(ed.SCALAR_BITS - 1, -1, -1):
        acc = ed.point_dbl(acc)
        acc = _select_point(s_bits[i] != 0, ed.point_madd(acc, b_ypx, b_ymx, b_xy2d), acc)
        acc = _select_point(h_bits[i] != 0, ed.point_madd(acc, na[0], na[1], na[3]), acc)
    return torch.stack(acc).to(torch.int32)


def bit_ladder(s_bits: torch.Tensor, h_bits: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel K7 wrapper (replaces `_verify_kernel`'s ladder): CPU tensors
    -> `bit_ladder_plain`; CUDA tensors -> `csrc/bit_ladder.cu`."""
    if s_bits.device.type == "cpu":
        return bit_ladder_plain(s_bits, h_bits, table)
    batch = s_bits.shape[1]
    dev = s_bits.device
    _build.check(s_bits, (ed.SCALAR_BITS, batch), torch.uint8, dev)
    _build.check(h_bits, (ed.SCALAR_BITS, batch), torch.uint8, dev)
    _build.check(table, (4, 16, f.NL, batch), torch.int32, dev)
    base = f.const("base_table", ed.BASE_TABLE, dev)
    out = torch.empty((4, f.NL, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["bit_ladder"].launch(s_bits, h_bits, base, table, out, batch)
    return out
