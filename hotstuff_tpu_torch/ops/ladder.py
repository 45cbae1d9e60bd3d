"""The 4-bit-window Straus ladder [s]B + [h](-A) — kernel K1 — and the
composition of the five verification steps.

Counterpart of `hotstuff_tpu/ops/pallas_ladder.py` (`_ladder_kernel`,
`ladder_pallas`, `_verify_pallas_p128(_dh)_jit`). The ladder runs 64 groups
of [4 doublings (T only on the last); mixed add of the shared k*B entry
for the s digit; cached add of the per-item k*(-A) entry for the h digit],
most significant window first. Digit 0 picks the identity entry, which the
unified formulas absorb, so there is no data-dependent control flow.

The TPU kernel selects table entries with masked sums over all 16 (TPUs
gather poorly); the plain version here and the CUDA kernel index the
tables by digit directly.
"""

from __future__ import annotations

import torch

from . import _build
from . import ed25519 as ed
from . import field as f
from .bit_ladder import bit_ladder

# The f32-argument path's ladder flavours: K1 on 4-bit digits stands in for
# both the reference's jnp w4 ladder and its Pallas ladder; K7 on bits.
KERNEL_FLAVOURS = ("w4", "pallas", "bits")


def ladder_plain(s_digits: torch.Tensor, h_digits_: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(64, B) uint8 digits of s and h, (4, 16, NL, B) int32 -A table
    -> (4, NL, B) int32 extended point (X, Y, Z, T); T is zeros (the last
    cached add skips it, as in the TPU kernel)."""
    batch = s_digits.shape[1]
    dev = s_digits.device
    base = f.const("base_table", ed.BASE_TABLE, dev).long()  # (3, 16, NL)
    table = table.long()
    acc = ed.point_identity(batch, dev)
    for g in range(ed.NGROUPS):
        row = ed.NGROUPS - 1 - g
        for i in range(ed.WINDOW):
            acc = ed.point_dbl(acc, with_t=i == ed.WINDOW - 1)
        sd = s_digits[row].long()
        hd = h_digits_[row].long()
        b_ypx, b_ymx, b_xy2d = base[:, sd, :].permute(0, 2, 1)  # (3, NL, B)
        acc = ed.point_madd(acc, b_ypx, b_ymx, b_xy2d)
        idx = hd.view(1, 1, 1, batch).expand(4, 1, f.NL, batch)
        q = table.gather(1, idx).squeeze(1)  # (4, NL, B)
        acc = ed.point_add_cached(acc, q[0], q[1], q[2], q[3], with_t=False)
    return torch.stack(acc).to(torch.int32)


def ladder(s_digits: torch.Tensor, h_digits_: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Kernel K1 wrapper (replaces `pallas_ladder._ladder_kernel`): CPU
    tensors -> `ladder_plain`; CUDA tensors -> `csrc/ladder.cu`."""
    if s_digits.device.type == "cpu":
        return ladder_plain(s_digits, h_digits_, table)
    batch = s_digits.shape[1]
    dev = s_digits.device
    _build.check(s_digits, (ed.NGROUPS, batch), torch.uint8, dev)
    _build.check(h_digits_, (ed.NGROUPS, batch), torch.uint8, dev)
    _build.check(table, (4, 16, f.NL, batch), torch.int32, dev)
    base = f.const("base_table", ed.BASE_TABLE, dev)
    out = torch.empty((4, f.NL, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["ladder"].launch(s_digits, h_digits_, base, table, out, batch)
    return out


def verify_unpacked(a_bytes, r_bytes, s_digits, h_digits_) -> torch.Tensor:
    """(B,) bool device mask (before the host s < L check): decompress and
    table (K3), ladder (K1), compress and compare with R (K4)."""
    table, valid = ed.decompress_table(a_bytes)
    point = ladder(s_digits, h_digits_, table)
    return ed.compress_eq(point, r_bytes, valid)


def verify_args(a_y, a_sign, r_enc, s, h, kernel: str = "w4") -> torch.Tensor:
    """The f32-argument verification (`_verify_jit_args`,
    hotstuff_tpu/ops/ed25519.py:1313-1321; `_kernel_fn`,
    hotstuff_tpu/parallel/mesh.py:88-93) on the port's uint8 arguments
    (`ed.kernel_args`): (32, B) key y bytes with row 31 & 0x7F, (B,) sign of
    x, (32, B) R bytes, and s and h as (64, B) 4-bit digits (`kernel="w4"`
    or `"pallas"`) or (253, B) bits (`kernel="bits"`). The key bytes are
    rebuilt with the sign in bit 255, then K3 decompresses them and builds
    the -A table, K1 (digits) or K7 (bits) runs the ladder and K4 compares
    the encoding with R. Returns the (B,) bool device mask, before the host
    s < L check."""
    if kernel not in KERNEL_FLAVOURS:
        raise ValueError(f"kernel must be one of {KERNEL_FLAVOURS}, got {kernel!r}")
    a_bytes = torch.cat((a_y[:31], (a_y[31] | a_sign.to(torch.uint8) << 7)[None]))
    table, valid = ed.decompress_table(a_bytes)
    point = (bit_ladder if kernel == "bits" else ladder)(s, h, table)
    return ed.compress_eq(point, r_enc, valid)


def verify_packed128(packed: torch.Tensor) -> torch.Tensor:
    """(128, B) u8 host-hash wire array -> (B,) bool."""
    return verify_unpacked(*ed.unpack_packed_inputs(*ed.split_packed128(packed)))


def verify_packed128_dh(packed: torch.Tensor) -> torch.Tensor:
    """(128, B) u8 device-hash wire array (rows 96-127 = the message)
    -> (B,) bool; h is computed on the device (K2)."""
    return verify_unpacked(*ed.unpack_packed_inputs_dh(packed))
