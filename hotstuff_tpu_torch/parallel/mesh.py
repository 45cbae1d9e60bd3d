"""Device meshes for the crypto plane: verification batches split over
devices, committee tables replicated per device, per-QC quorum counts.

Counterpart of `hotstuff_tpu/parallel/mesh.py`.
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

A mesh may span processes (`init_multihost`, the reference's `:53-78`):
each entry then carries the rank of the process that owns it, and a
process runs only its own entries' blocks. The processes run one program
(SPMD): each is given the same batches in the same order, stages the whole
of each chunk and uploads, launches and reads back only its own blocks.
What crosses processes goes through the mesh's `comm`
(`HostCollectives`: gloo, on host tensors): the masks, one byte a lane,
gathered once a batch (`gather_chunks`), and the per-QC counts, summed by
one all-reduce (the reference's `psum` over "dp").

Deliberate departure: asking for more GPUs than are visible raises, where
the reference takes `jax.devices()[:n]` and runs on fewer.
"""

from __future__ import annotations

import math
import os
import time
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops import committee as cm
from ..ops import ed25519 as ed
from ..ops import ladder
from ..ops.verifier import PALLAS_BLOCK, Ed25519TorchVerifier
from ..utils import metrics

# Lanes per shard of a bucket. The port's kernels take any width; 128 is
# the reference's w4 lane. `kernel="pallas"` keeps the reference's 256-lane
# Pallas BLOCK (`ops/verifier.py` PALLAS_BLOCK), which K1 does not need.
LANE = 128

# Every gather of a multi-process mesh's masks, and its wall seconds.
_M_GATHERS = metrics.counter("mesh.gathers")
_M_GATHER_S = metrics.histogram("mesh.gather_s")


class DeviceMesh:
    """Devices laid out over named axes, row-major (the last axis varies
    fastest), as `jax.sharding.Mesh`: `devices` in that order, `axis_names`
    and `shape` ({axis name: size}). Every device is of one type.

    `ranks` gives the process that owns each entry (default: every entry
    is `rank`'s, a one-process mesh); `local` is the entries that are this
    process's, in mesh order. Only a local entry's device is resolved here:
    another process's `cuda:0` is its own card. A mesh over several
    processes needs their collectives, `comm` (`HostCollectives`)."""

    def __init__(
        self,
        devices: Sequence[str | torch.device],
        axis_names: Sequence[str],
        sizes: Sequence[int],
        ranks: Sequence[int] | None = None,
        rank: int = 0,
        comm: "HostCollectives | None" = None,
    ):
        ranks = tuple(ranks) if ranks is not None else (rank,) * len(devices)
        if len(ranks) != len(devices):
            raise ValueError(f"{len(ranks)} ranks for {len(devices)} devices")
        devices = tuple(resolve_device(d) if r == rank else torch.device(d) for d, r in zip(devices, ranks))
        if len(axis_names) != len(sizes) or math.prod(sizes) != len(devices) or not devices:
            raise ValueError(f"{len(devices)} devices do not fill a mesh of {dict(zip(axis_names, sizes))}")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type: {devices}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.ranks, self.rank = ranks, rank
        self.local = tuple(i for i, r in enumerate(ranks) if r == rank)
        if not self.local:
            raise ValueError(f"no entry of the mesh is rank {rank}'s: {ranks}")
        if self.multiprocess and comm is None:
            raise ValueError("a mesh over several processes needs their collectives (comm=)")
        self.comm = comm

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        return len(set(self.ranks)) > 1

    @property
    def local_devices(self) -> tuple[torch.device, ...]:
        """The devices of this process's entries, in mesh order."""
        return tuple(self.devices[i] for i in self.local)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each of this process's devices once, in mesh order."""
        return tuple(dict.fromkeys(self.local_devices))

    def __repr__(self) -> str:
        ranks = f", ranks {list(self.ranks)}, rank {self.rank}" if self.multiprocess else ""
        return f"DeviceMesh({self.shape}, {[str(d) for d in self.devices]}{ranks})"


class HostCollectives:
    """The collectives of a mesh over several processes: `torch.distributed`
    with gloo, over its default group, on host tensors.

    Gloo, not NCCL, for two reasons. What crosses processes is already on
    the host: each chunk's mask is read back into a page-locked host buffer
    by the verifier's readback, so a gather moves host bytes, one byte a
    lane, once a batch. And NCCL forms no communicator of two ranks on one
    device, the only layout a host with one card has. A gather on the
    devices over NCCL waits for several cards."""

    @property
    def world_size(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size()

    def all_gather(self, local: np.ndarray, lengths: Sequence[int]) -> list[np.ndarray]:
        """Every rank's uint8 array, rank r's `lengths[r]` bytes long (this
        rank's is `local`), in rank order."""
        import torch.distributed as dist

        width = max(lengths)
        buf = torch.zeros(width, dtype=torch.uint8)
        buf[: len(local)] = torch.from_numpy(np.ascontiguousarray(local))
        outs = [torch.empty(width, dtype=torch.uint8) for _ in lengths]
        dist.all_gather(outs, buf)
        return [o[:n].numpy() for o, n in zip(outs, lengths)]

    def all_reduce_sum(self, values: np.ndarray) -> np.ndarray:
        """The element-wise sum over the ranks of an int64 array."""
        import torch.distributed as dist

        t = torch.from_numpy(np.array(values, np.int64))
        dist.all_reduce(t)
        return t.numpy()


def gather_chunks(mesh: DeviceMesh, pieces: Sequence[np.ndarray], blocks: Sequence[int]) -> list[np.ndarray]:
    """Each chunk's whole lanes from this process's lanes of each, with ONE
    gather over the mesh's processes.

    `pieces[c]` holds, for chunk c, the blocks of this process's entries in
    mesh order, `blocks[c]` lanes each (bool or uint8). What a rank sends is
    its blocks of every chunk, one chunk after another; the chunks are
    rebuilt chunk by chunk on the block widths, entry by entry from its
    owner's bytes, not by cutting the gathered bytes at rank boundaries.
    Every rank reaches this with the same `blocks` (the bucket widths are
    the same on every rank), so the lengths it expects are the ones sent."""
    world = mesh.comm.world_size
    per_rank = [0] * world
    for r in mesh.ranks:
        per_rank[r] += 1
    lengths = [k * sum(blocks) for k in per_rank]
    local = np.concatenate([np.asarray(p).view(np.uint8) for p in pieces]) if pieces else np.empty(0, np.uint8)
    if len(local) != lengths[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {len(local)} lanes, {lengths[mesh.rank]} expected")
    t0 = time.perf_counter()
    gathered = mesh.comm.all_gather(local, lengths)
    _M_GATHERS.inc()
    _M_GATHER_S.record(time.perf_counter() - t0)
    cursor = [0] * world
    out = []
    for b in blocks:
        parts = []
        for r in mesh.ranks:
            parts.append(gathered[r][cursor[r] : cursor[r] + b])
            cursor[r] += b
        out.append(np.concatenate(parts).view(np.bool_))
    return out


def init_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
    local_shards: int | None = None,
) -> DeviceMesh:
    """Join a job of several processes and return its global 1-D "dp"
    mesh (the reference's `init_multihost`, `hotstuff_tpu/parallel/mesh.py:
    53-78`).

    `coordinator` ("host:port"), `num_processes` and `process_id` default to
    `torch.distributed`'s own `env://` variables (`MASTER_ADDR` and
    `MASTER_PORT`, `WORLD_SIZE`, `RANK`), which take the place of JAX's
    coordinator environment. The process group is gloo (`HostCollectives`
    says why). Each process's entries are its visible GPUs, or, with
    `device` (`"cpu"`, `"cuda:0"`), a virtual mesh of `local_shards`
    (default 1) on that one device, as `default_mesh`. The ranks exchange
    their devices once, so every process builds the same mesh: every
    process's entries in rank order, process 0's first, as JAX orders a
    job's global devices."""
    import torch.distributed as dist

    if coordinator is None:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    mine = default_mesh(local_shards, device=device).devices
    every: list = [None] * world
    dist.all_gather_object(every, [str(d) for d in mine])
    devices = [d for devs in every for d in devs]
    ranks = [r for r, devs in enumerate(every) for _ in devs]
    return DeviceMesh(devices, ("dp",), (len(devices),), ranks=ranks, rank=rank, comm=HostCollectives())


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


def _join(mesh: DeviceMesh, masks: list[torch.Tensor], w: int) -> torch.Tensor:
    """This process's entries' (w,) block masks, in mesh order -> the (W,)
    mask on its first device: joined in lane order on one process, else
    gathered from every process (`gather_chunks`, one gather)."""
    first = mesh.local_devices[0]
    if not mesh.multiprocess:
        return torch.cat([m.to(first) for m in masks])
    local = torch.cat([m.cpu() for m in masks]).numpy()
    return torch.from_numpy(gather_chunks(mesh, [local], [w])[0]).to(first)


def sharded_packed(mesh: DeviceMesh, packed: torch.Tensor, device_hash: bool = False) -> torch.Tensor:
    """(128, W) uint8 wire array -> (W,) bool mask on the mesh's first
    (local) device, lanes split evenly over the mesh (`sharded_packed_fn`,
    `hotstuff_tpu/parallel/mesh.py:160-191`); each of this process's
    devices runs `ladder.verify_packed128(_dh)` on its block. The host
    s < L mask is the caller's, as in the reference."""
    verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
    w = _lane_blocks(mesh, packed.shape[-1])
    masks = [verify(packed[:, s * w : (s + 1) * w].to(mesh.devices[s]).contiguous()) for s in mesh.local]
    return _join(mesh, masks, w)


def sharded_committee(
    mesh: DeviceMesh, table: ed.CommitteeTable, idx: torch.Tensor, packed: torch.Tensor, device_hash: bool = False
) -> torch.Tensor:
    """(96, W) uint8 committee wire array + (W,) int32 validator indices ->
    (W,) bool mask on the mesh's first (local) device
    (`sharded_committee_fn`, `hotstuff_tpu/parallel/mesh.py:194-219`): each
    of this process's devices verifies its block of lanes with
    `committee.verify_committee96(_dh)` against its replica of `table`
    (`replicate`), which must be there already."""
    verify = cm.verify_committee96_dh if device_hash else cm.verify_committee96
    w = _lane_blocks(mesh, packed.shape[-1])
    masks = []
    for s in mesh.local:
        dev, lanes = mesh.devices[s], slice(s * w, (s + 1) * w)
        lane_idx, lane_rows = idx[lanes].to(dev).contiguous(), packed[:, lanes].to(dev).contiguous()
        masks.append(verify(table.replicas[dev], lane_idx, lane_rows))
    return _join(mesh, masks, w)


def _verify_blocks(mesh: DeviceMesh, args: Sequence, kernel: str) -> tuple[list[torch.Tensor], int]:
    """The f32-argument arrays split on lanes into one equal block per
    entry of the mesh; each of this process's blocks verified on its device
    by `ladder.verify_args`. Returns the local blocks' masks, in mesh order,
    and the block width."""
    args = [torch.as_tensor(t) for t in args]
    w = _lane_blocks(mesh, args[0].shape[-1])
    masks = []
    for sh in mesh.local:
        block = [t[..., sh * w : (sh + 1) * w].to(mesh.devices[sh]).contiguous() for t in args]
        masks.append(ladder.verify_args(*block, kernel=kernel))
    return masks, w


def sharded_verify(
    mesh: DeviceMesh, a_y, a_sign, r_enc, s, h, kernel: str = "w4"
) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32-argument form over a mesh (`sharded_verify_fn`,
    `hotstuff_tpu/parallel/mesh.py:96-119`): the port's uint8 arguments of
    `ladder.verify_args` ((32, W) a_y, (W,) a_sign, (32, W) r_enc, s and h
    as digits or bits), each split on lanes into one equal block per device
    of the mesh, in device order; each of this process's blocks is verified
    on its device by `ladder.verify_args`. Returns the (W,) bool mask,
    joined in lane order (gathered once on a mesh over several processes),
    and the () int32 `n_valid`, the sum of the devices' counts of their
    masks (the reference's `psum`; an all-reduce across processes), both
    on the mesh's first (local) device. The host s < L mask is the
    caller's, as in the reference: `n_valid` counts the device mask before
    it."""
    masks, w = _verify_blocks(mesh, (a_y, a_sign, r_enc, s, h), kernel)
    first = mesh.local_devices[0]
    n_valid = torch.stack([m.sum(dtype=torch.int32).to(first) for m in masks]).sum(dtype=torch.int32)
    if mesh.multiprocess:
        total = mesh.comm.all_reduce_sum(np.array([n_valid.item()]))[0]
        n_valid = torch.tensor(total, dtype=torch.int32, device=first)
    return _join(mesh, masks, w), n_valid


def sharded_qc_counts(
    mesh: DeviceMesh, packed: torch.Tensor | np.ndarray, s_ok: torch.Tensor | np.ndarray, device_hash: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-axis QC verification (`sharded_qc_verify_fn`,
    `hotstuff_tpu/parallel/mesh.py:122-157`) on a (qc, dp) mesh.

    `packed` is a QC-major (Q, 128, B) uint8 wire batch (rows 96-127 the
    32-byte messages with `device_hash`, else h), `s_ok` the (Q, B) host
    s < L mask. Q splits over "qc", each QC's B votes over "dp"; each of
    this process's devices verifies its (Q / n_qc) x (B / n_dp) block as
    one batch of lanes. Returns the (Q, B) masks ANDed with `s_ok` and the
    (Q,) int32 valid-vote counts, both on the mesh's first (local) device.
    A device's partial count is the sum of its mask; a QC's count is the sum
    of its row's partials (the reference's `psum` over "dp"): on the row's
    first device on one process, by one all-reduce of every process's
    partials on a mesh over several. There the masks come back from one
    gather of every process's blocks (what reading the reference's sharded
    mask on the host takes)."""
    if mesh.axis_names != ("qc", "dp"):
        raise ValueError(f"QC counts need a (qc, dp) mesh (`mesh_2d`), not {mesh}")
    packed, s_ok = torch.as_tensor(packed), torch.as_tensor(s_ok)
    n_qc, n_dp = mesh.shape["qc"], mesh.shape["dp"]
    n_q, rows, n_b = packed.shape
    if n_q % n_qc or n_b % n_dp or tuple(s_ok.shape) != (n_q, n_b):
        raise ValueError(f"a ({n_q}, {rows}, {n_b}) batch with s_ok {tuple(s_ok.shape)} does not split over {mesh}")
    q, w = n_q // n_qc, n_b // n_dp
    verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
    blocks, partials = {}, {}
    for e in mesh.local:
        i, j = divmod(e, n_dp)
        dev = mesh.devices[e]
        qcs, lanes = slice(i * q, (i + 1) * q), slice(j * w, (j + 1) * w)
        wire = packed[qcs, :, lanes].to(dev).permute(1, 0, 2).reshape(rows, q * w).contiguous()
        blocks[e] = verify(wire).view(q, w) & s_ok[qcs, lanes].to(dev)
        partials[e] = blocks[e].sum(dim=1, dtype=torch.int32)
    out = mesh.local_devices[0]
    if mesh.multiprocess:
        local_counts = np.zeros(n_q, np.int64)
        for e, p in partials.items():
            i = e // n_dp
            local_counts[i * q : (i + 1) * q] += p.cpu().numpy()
        counts = torch.from_numpy(mesh.comm.all_reduce_sum(local_counts).astype(np.int32)).to(out)
        local = np.concatenate([blocks[e].cpu().numpy().reshape(-1) for e in mesh.local])
        every = gather_chunks(mesh, [local], [q * w])[0].reshape(n_qc, n_dp, q, w)
        masks = torch.from_numpy(np.ascontiguousarray(every.transpose(0, 2, 1, 3)).reshape(n_q, n_b)).to(out)
        return masks, counts
    masks, counts = [], []
    for i in range(n_qc):
        row = range(i * n_dp, (i + 1) * n_dp)
        first = mesh.devices[row[0]]
        counts.append(torch.stack([partials[e].to(first) for e in row]).sum(dim=0, dtype=torch.int32))
        masks.append(torch.cat([blocks[e].to(first) for e in row], dim=1))
    return torch.cat([m.to(out) for m in masks]), torch.cat([c.to(out) for c in counts])


class ShardedEd25519TorchVerifier(Ed25519TorchVerifier):
    """`Ed25519TorchVerifier` that splits every chunk over the devices of a
    mesh (`ShardedEd25519Verifier`, `hotstuff_tpu/parallel/mesh.py:222-374`).

    Each chunk's pooled shard-major wire buffer (and index vector) gives one
    block per shard; each of this process's blocks is uploaded
    `non_blocking` on its shard's stream, verified there by the port's
    kernels and its mask copied into its slice of the chunk's one pooled
    mask buffer; the readback waits on every local shard's event
    (`Ed25519TorchVerifier._upload_dispatch`).

    Buckets stay multiples of `mesh_alignment` = 128 lanes x the mesh's
    size, so every shard gets whole 128-lane blocks (the reference's w4
    lane; 256 with `kernel="pallas"`, the reference's Pallas BLOCK):
    `min_bucket` rounds up to that grid, `max_bucket` rounds down (3
    devices: 8,192 -> 7,680), and `chunk` is clamped to `max_bucket`. On a
    mesh over several processes the grid is the GLOBAL mesh's, so it comes
    out the same on every rank, as do the committee crossover floor and the
    bucket widths that the collectives follow.

    `packed=False` runs the base class's f32-argument chunk loop, with each
    piece's arrays split over the mesh (`_verify_blocks`, as
    `sharded_verify`; the reference's `_run_chunk`, :376-384).

    Registration (`set_committee`) decompresses the keys once on the host
    and makes one copy of the table per distinct device of this process's;
    no replica decompresses again, and a chunk's task holds its table, with
    its replicas, until its readback (the snapshot-pinning contract of
    `Ed25519TorchVerifier.verify_batch_mask_committee`).

    On a mesh over several processes (the reference's `:247-262`) the
    pipeline runs at depth 1, so every process issues its launches and
    collectives in one order, and readback is deferred: each chunk's local
    lanes are read back as it settles, and ONE gather a batch
    (`_materialize`, `gather_chunks`), issued on the calling thread after
    the pipeline's run returns, gives every process the batch's whole
    mask; the s < L mask is ANDed after it. Every process must be given
    the same batches in the same order, or a gather waits forever."""

    def __init__(self, mesh: DeviceMesh | None = None, **kw):
        if "device" in kw:
            raise TypeError("a sharded verifier takes its devices from its mesh, not device=")
        self.mesh = mesh or default_mesh()
        super().__init__(device=self.mesh.local_devices[0], **kw)
        align = (PALLAS_BLOCK if self.kernel == "pallas" else LANE) * self.mesh.size
        self.mesh_alignment = align
        self.min_bucket = -(-max(self.min_bucket, align) // align) * align
        self.max_bucket = max(align, self.max_bucket // align * align)
        self.chunk = min(self.chunk, self.max_bucket)
        if self.mesh.multiprocess:
            self.pipeline.set_depth(1)
            self._defer_readback = True

    @property
    def shard_devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    @property
    def local_shards(self) -> tuple[int, ...]:
        return self.mesh.local

    def _build_committee_table(self, keys: list[bytes]) -> ed.CommitteeTable:
        return replicate(ed.CommitteeTable(keys, self.device), self.mesh.distinct)

    def _verify_args(self, args: tuple) -> torch.Tensor:
        masks, _ = _verify_blocks(self.mesh, args, self.kernel)
        return torch.cat([m.to(self.device) for m in masks])

    def _materialize(self, pieces: list[np.ndarray], widths: list[int]) -> list[np.ndarray]:
        if not self.mesh.multiprocess:
            return pieces
        return gather_chunks(self.mesh, pieces, [w // self.mesh.size for w in widths])
