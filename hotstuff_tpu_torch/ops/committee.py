"""The committee path: the ladder over device-resident validator tables —
kernel K5 — and the composition of its verification steps.

Counterpart of `_verify_kernel_w4_committee` and its `_packed96` /
`_packed96_dh` wrappers (`hotstuff_tpu/ops/ed25519.py:412-490`). Lanes carry
a validator index into a `CommitteeTable` (`ops/ed25519.py`), built once per
registration; the ladder reads each lane's affine k*(-A) entry by index, so
no key is decompressed and no per-lane table is built (no K3). The 64 groups
are [4 doublings (T only on the last); mixed add of the shared k*B entry for
the s digit; mixed add of the lane's committee entry for the h digit, without
T], most significant window first.

    verify_committee96     R, S, h rows (host hash)   -> K5, K4
    verify_committee96_dh  R, S, M rows (device hash) -> K2g, K5, K4
"""

from __future__ import annotations

import torch

from . import _build
from . import ed25519 as ed
from . import field as f
from .sha512 import h_digits_gather, nibble_rows


def committee_ladder_plain(
    s_digits: torch.Tensor, h_digits_: torch.Tensor, entries: torch.Tensor, valid: torch.Tensor,
    idx: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(64, B) uint8 digits of s and h, (N, 16, 3, NL) int32 committee
    entries, (N,) bool valid, (B,) int32 validator indices -> ((4, NL, B)
    int32 extended point, T zeros; (B,) bool lane_valid = 0 <= idx < N and
    valid[idx]). An index outside [0, N) is clamped (the lane's point uses
    the clamped validator's table) and its lane is masked."""
    batch = s_digits.shape[1]
    dev = s_digits.device
    n = entries.shape[0]
    ci = idx.long().clamp(0, n - 1)
    lane_valid = (idx >= 0) & (idx < n) & valid[ci]
    base = f.const("base_table", ed.BASE_TABLE, dev).long()  # (3, 16, NL)
    lanes = entries.index_select(0, ci).long()  # (B, 16, 3, NL)
    lane_no = torch.arange(batch, device=dev)
    acc = ed.point_identity(batch, dev)
    for g in range(ed.NGROUPS):
        row = ed.NGROUPS - 1 - g
        for i in range(ed.WINDOW):
            acc = ed.point_dbl(acc, with_t=i == ed.WINDOW - 1)
        sd = s_digits[row].long()
        hd = h_digits_[row].long()
        b_ypx, b_ymx, b_xy2d = base[:, sd, :].permute(0, 2, 1)  # (3, NL, B)
        acc = ed.point_madd(acc, b_ypx, b_ymx, b_xy2d)
        q = lanes[lane_no, hd].permute(1, 2, 0)  # (3, NL, B)
        acc = ed.point_madd(acc, q[0], q[1], q[2], with_t=False)
    return torch.stack(acc).to(torch.int32), lane_valid


def committee_ladder(
    s_digits: torch.Tensor, h_digits_: torch.Tensor, table: ed.CommitteeTable, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel K5 wrapper (replaces `_verify_kernel_w4_committee` up to the
    compress): CPU tensors -> `committee_ladder_plain`; CUDA tensors ->
    `csrc/committee_ladder.cu`. Both read `table.entries`."""
    if s_digits.device.type == "cpu":
        return committee_ladder_plain(s_digits, h_digits_, table.entries, table.valid, idx)
    batch, n = s_digits.shape[1], table.size
    dev = s_digits.device
    _build.check(s_digits, (ed.NGROUPS, batch), torch.uint8, dev)
    _build.check(h_digits_, (ed.NGROUPS, batch), torch.uint8, dev)
    _build.check(table.entries, (n, 16, 3, f.NL), torch.int32, dev)
    _build.check(table.valid, (n,), torch.bool, dev)
    _build.check(idx, (batch,), torch.int32, dev)
    base = f.const("base_table", ed.BASE_TABLE, dev)
    out = torch.empty((4, f.NL, batch), dtype=torch.int32, device=dev)
    lane_valid = torch.empty((batch,), dtype=torch.bool, device=dev)
    _build.KERNELS["committee_ladder"].launch(
        s_digits, h_digits_, base, table.entries, table.valid, idx, out, lane_valid, n, batch
    )
    return out, lane_valid


def split_packed96(packed: torch.Tensor) -> tuple:
    """(96, B) u8 committee wire array -> (r, s, h_or_m) (32, B) row groups."""
    return packed[0:32], packed[32:64], packed[64:96]


def verify_committee96(table: ed.CommitteeTable, idx: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(96, B) u8 host-hash rows (R, S, h) + (B,) int32 indices -> (B,) bool
    device mask (before the host s < L check): K5, then K4."""
    r, s, h = split_packed96(packed)
    point, lane_valid = committee_ladder(nibble_rows(s), nibble_rows(h), table, idx)
    return ed.compress_eq(point, r, lane_valid)


def verify_committee96_dh(table: ed.CommitteeTable, idx: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(96, B) u8 device-hash rows (R, S, 32-byte M) + (B,) int32 indices
    -> (B,) bool; h is computed on the device with each lane's key read from
    the table (K2g), then K5 and K4."""
    r, s, m = split_packed96(packed)
    hd = h_digits_gather(r, table.keys_u8, idx, m)
    point, lane_valid = committee_ladder(nibble_rows(s), hd, table, idx)
    return ed.compress_eq(point, r, lane_valid)
