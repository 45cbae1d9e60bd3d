"""Device meshes for the crypto plane: verification batches split over
devices, committee tables replicated per device, per-QC quorum counts.

Counterpart of the single-process half of `hotstuff_tpu/parallel/mesh.py`.
The reference expresses the split once with `shard_map` and lets XLA place
the shards and reduce the counts (`psum`); here each step is done by hand:

  * a (rows, W) wire array is split on lanes into one equal block per
    device of the mesh, in device order, and each block is verified on its
    device by the port's kernels (K2, K3, K1, K4 on the generic path; K2g,
    K5, K4 on the committee path), against that device's replica of the
    committee table; the blocks' masks are joined in lane order;
  * per-QC counts are each device's sum of its mask, and the sum over the
    "dp" axis is a sum of those partials on the first device of the QC's
    row of the mesh;
  * the f32-argument form (`sharded_verify`, the reference's
    `sharded_verify_fn`) splits each of the five argument arrays on lanes
    the same way, runs `ladder.verify_args` per device (K3, K1 or K7, K4)
    and sums the devices' counts of their masks (the reference's `psum`).

A mesh is an ordered tuple of `torch.device`s. Devices may repeat: a
*virtual* mesh of n shards on one device (`default_mesh(n, device=...)`)
splits every batch exactly as n devices would, which is how the split is
held on the CPU and on a host with one card (the counterpart of the 8
virtual CPU devices `tests/conftest.py` gives JAX). A virtual mesh shows
that the split, the padding and the reduction are right; it cannot show
what several cards gain, since its shards share one device.

Deliberate departure: asking for more GPUs than are visible raises, where
the reference takes `jax.devices()[:n]` and runs on fewer. Not ported:
`init_multihost` and the multi-process readback.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops import committee as cm
from ..ops import ed25519 as ed
from ..ops import ladder
from ..ops.verifier import PALLAS_BLOCK, Ed25519TorchVerifier

# Lanes per shard of a bucket. The port's kernels take any width; 128 is
# the reference's w4 lane. `kernel="pallas"` keeps the reference's 256-lane
# Pallas BLOCK (`ops/verifier.py` PALLAS_BLOCK), which K1 does not need.
LANE = 128


class DeviceMesh:
    """Devices laid out over named axes, row-major (the last axis varies
    fastest), as `jax.sharding.Mesh`: `devices` in that order, `axis_names`
    and `shape` ({axis name: size}). Every device is of one type."""

    def __init__(self, devices: Sequence[str | torch.device], axis_names: Sequence[str], sizes: Sequence[int]):
        devices = tuple(resolve_device(d) for d in devices)
        if len(axis_names) != len(sizes) or math.prod(sizes) != len(devices) or not devices:
            raise ValueError(f"{len(devices)} devices do not fill a mesh of {dict(zip(axis_names, sizes))}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type: {devices}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]})"


def _visible_gpus(n: int | None) -> list[torch.device]:
    """The first n visible GPUs (all when n is None); raises when fewer are
    visible (the port never runs on fewer devices than asked for)."""
    if not torch.cuda.is_available():
        resolve_device("cuda")  # raises: no CUDA device is available
    visible = torch.cuda.device_count()
    n = visible if n is None else n
    if n > visible:
        raise RuntimeError(f"{n} GPUs asked for, {visible} visible")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(
    n_devices: int | None = None, device: str | torch.device | None = None, axis: str = "dp"
) -> DeviceMesh:
    """1-D data-parallel mesh (`hotstuff_tpu/parallel/mesh.py:47-50`). With
    `device` None, the first `n_devices` visible GPUs (all of them when
    None); with a device (`"cpu"`, `"cuda:0"`), a virtual mesh of
    `n_devices` (default 1) shards on that one device."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, not {n_devices}")
    devs = _visible_gpus(n_devices) if device is None else [device] * (n_devices or 1)
    return DeviceMesh(devs, (axis,), (len(devs),))


def mesh_2d(n_qc: int, n_dp: int, devices: Sequence[str | torch.device] | None = None) -> DeviceMesh:
    """(qc, dp) mesh (`hotstuff_tpu/parallel/mesh.py:81-85`): independent
    QC batches x vote data-parallel, over the first n_qc * n_dp of
    `devices` (default the visible GPUs; a device may repeat)."""
    need = n_qc * n_dp
    devs = _visible_gpus(need) if devices is None else list(devices)[:need]
    if len(devs) < need:
        raise RuntimeError(f"a {n_qc} x {n_dp} mesh needs {need} devices, {len(devs)} given")
    return DeviceMesh(devs, ("qc", "dp"), (n_qc, n_dp))


def replicate(table: ed.CommitteeTable, devices: Sequence[torch.device]) -> ed.CommitteeTable:
    """Give `table` a replica on every device of `devices` it lacks
    (`CommitteeTable.to`: no host work redone). Returns the table."""
    for dev in devices:
        if dev not in table.replicas:
            table.replicas[dev] = table.to(dev)
    return table


def _lane_blocks(mesh: DeviceMesh, width: int) -> int:
    if width % mesh.size:
        raise ValueError(f"{width} lanes do not split evenly over {mesh.size} devices")
    return width // mesh.size


def sharded_packed(mesh: DeviceMesh, packed: torch.Tensor, device_hash: bool = False) -> torch.Tensor:
    """(128, W) uint8 wire array -> (W,) bool mask on the mesh's first
    device, lanes split evenly over the mesh (`sharded_packed_fn`,
    `hotstuff_tpu/parallel/mesh.py:160-191`); each device runs
    `ladder.verify_packed128(_dh)` on its block. The host s < L mask is the
    caller's, as in the reference."""
    verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
    w = _lane_blocks(mesh, packed.shape[-1])
    masks = [verify(packed[:, s * w : (s + 1) * w].to(dev).contiguous()) for s, dev in enumerate(mesh.devices)]
    return torch.cat([m.to(mesh.devices[0]) for m in masks])


def sharded_committee(
    mesh: DeviceMesh, table: ed.CommitteeTable, idx: torch.Tensor, packed: torch.Tensor, device_hash: bool = False
) -> torch.Tensor:
    """(96, W) uint8 committee wire array + (W,) int32 validator indices ->
    (W,) bool mask on the mesh's first device (`sharded_committee_fn`,
    `hotstuff_tpu/parallel/mesh.py:194-219`): each device verifies its block
    of lanes with `committee.verify_committee96(_dh)` against its replica of
    `table` (`replicate`), which must be there already."""
    verify = cm.verify_committee96_dh if device_hash else cm.verify_committee96
    w = _lane_blocks(mesh, packed.shape[-1])
    masks = []
    for s, dev in enumerate(mesh.devices):
        lanes = slice(s * w, (s + 1) * w)
        lane_idx, lane_rows = idx[lanes].to(dev).contiguous(), packed[:, lanes].to(dev).contiguous()
        masks.append(verify(table.replicas[dev], lane_idx, lane_rows))
    return torch.cat([m.to(mesh.devices[0]) for m in masks])


def sharded_verify(
    mesh: DeviceMesh, a_y, a_sign, r_enc, s, h, kernel: str = "w4"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32-argument form over a mesh (`sharded_verify_fn`,
    `hotstuff_tpu/parallel/mesh.py:96-119`): the port's uint8 arguments of
    `ladder.verify_args` ((32, W) a_y, (W,) a_sign, (32, W) r_enc, s and h
    as digits or bits), each split on lanes into one equal block per device
    of the mesh, in device order; each block is verified on its device by
    `ladder.verify_args`. Returns the (W,) bool mask, joined in lane order,
    and the () int32 `n_valid`, the sum of the devices' counts of their
    masks (the reference's `psum`), both on the mesh's first device. The
    host s < L mask is the caller's, as in the reference: `n_valid` counts
    the device mask before it."""
    args = [torch.as_tensor(t) for t in (a_y, a_sign, r_enc, s, h)]
    w = _lane_blocks(mesh, args[0].shape[-1])
    masks, counts = [], []
    for sh, dev in enumerate(mesh.devices):
        block = [t[..., sh * w : (sh + 1) * w].to(dev).contiguous() for t in args]
        mask = ladder.verify_args(*block, kernel=kernel)
        masks.append(mask)
        counts.append(mask.sum(dtype=torch.int32))
    first = mesh.devices[0]
    n_valid = torch.stack([c.to(first) for c in counts]).sum(dtype=torch.int32)
    return torch.cat([m.to(first) for m in masks]), n_valid


def sharded_qc_counts(
    mesh: DeviceMesh, packed: torch.Tensor | np.ndarray, s_ok: torch.Tensor | np.ndarray, device_hash: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-axis QC verification (`sharded_qc_verify_fn`,
    `hotstuff_tpu/parallel/mesh.py:122-157`) on a (qc, dp) mesh.

    `packed` is a QC-major (Q, 128, B) uint8 wire batch (rows 96-127 the
    32-byte messages with `device_hash`, else h), `s_ok` the (Q, B) host
    s < L mask. Q splits over "qc", each QC's B votes over "dp"; each device
    verifies its (Q / n_qc) x (B / n_dp) block as one batch of lanes.
    Returns the (Q, B) masks ANDed with `s_ok` and the (Q,) int32 valid-vote
    counts, both on the mesh's first device. A device's partial count is the
    sum of its mask; a QC's count is the sum of its row's partials on the
    row's first device (the reference's `psum` over "dp")."""
    if mesh.axis_names != ("qc", "dp"):
        raise ValueError(f"QC counts need a (qc, dp) mesh (`mesh_2d`), not {mesh}")
    packed, s_ok = torch.as_tensor(packed), torch.as_tensor(s_ok)
    n_qc, n_dp = mesh.shape["qc"], mesh.shape["dp"]
    n_q, rows, n_b = packed.shape
    if n_q % n_qc or n_b % n_dp or tuple(s_ok.shape) != (n_q, n_b):
        raise ValueError(f"a ({n_q}, {rows}, {n_b}) batch with s_ok {tuple(s_ok.shape)} does not split over {mesh}")
    q, w = n_q // n_qc, n_b // n_dp
    verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
    masks, counts = [], []
    for i in range(n_qc):
        qcs = slice(i * q, (i + 1) * q)
        row_masks, partials = [], []
        for j in range(n_dp):
            dev = mesh.devices[i * n_dp + j]
            lanes = slice(j * w, (j + 1) * w)
            wire = packed[qcs, :, lanes].to(dev).permute(1, 0, 2).reshape(rows, q * w).contiguous()
            mask = verify(wire).view(q, w) & s_ok[qcs, lanes].to(dev)
            row_masks.append(mask)
            partials.append(mask.sum(dim=1, dtype=torch.int32))
        first = mesh.devices[i * n_dp]
        counts.append(torch.stack([p.to(first) for p in partials]).sum(dim=0, dtype=torch.int32))
        masks.append(torch.cat([m.to(first) for m in row_masks], dim=1))
    out = mesh.devices[0]
    return torch.cat([m.to(out) for m in masks]), torch.cat([c.to(out) for c in counts])


class ShardedEd25519TorchVerifier(Ed25519TorchVerifier):
    """`Ed25519TorchVerifier` that splits every chunk over the devices of a
    mesh (`ShardedEd25519Verifier`, `hotstuff_tpu/parallel/mesh.py:222-374`).

    Each chunk's pooled shard-major wire buffer (and index vector) gives one
    block per shard; each block is uploaded `non_blocking` on its shard's
    stream, verified there by the port's kernels and its mask copied into
    its slice of the chunk's one pooled mask buffer; the readback waits on
    every shard's event (`Ed25519TorchVerifier._upload_dispatch`).

    Buckets stay multiples of `mesh_alignment` = 128 lanes x the mesh's
    size, so every shard gets whole 128-lane blocks (the reference's w4
    lane; 256 with `kernel="pallas"`, the reference's Pallas BLOCK):
    `min_bucket` rounds up to that grid, `max_bucket` rounds down (3
    devices: 8,192 -> 7,680), and `chunk` is clamped to `max_bucket`.

    `packed=False` runs the base class's f32-argument chunk loop, with each
    piece's arrays split over the mesh by `sharded_verify` (the
    reference's `_run_chunk`, :376-384).

    Registration (`set_committee`) decompresses the keys once on the host
    and makes one copy of the table per distinct device of the mesh; no
    replica decompresses again, and a chunk's task holds its table, with
    its replicas, until its readback (the snapshot-pinning contract of
    `Ed25519TorchVerifier.verify_batch_mask_committee`)."""

    def __init__(self, mesh: DeviceMesh | None = None, **kw):
        if "device" in kw:
            raise TypeError("a sharded verifier takes its devices from its mesh, not device=")
        self.mesh = mesh or default_mesh()
        super().__init__(device=self.mesh.devices[0], **kw)
        align = (PALLAS_BLOCK if self.kernel == "pallas" else LANE) * self.mesh.size
        self.mesh_alignment = align
        self.min_bucket = -(-max(self.min_bucket, align) // align) * align
        self.max_bucket = max(align, self.max_bucket // align * align)
        self.chunk = min(self.chunk, self.max_bucket)

    @property
    def shard_devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    def _build_committee_table(self, keys: list[bytes]) -> ed.CommitteeTable:
        return replicate(ed.CommitteeTable(keys, self.device), self.mesh.distinct)

    def _verify_args(self, args: tuple) -> torch.Tensor:
        return sharded_verify(self.mesh, *args, kernel=self.kernel)[0]
