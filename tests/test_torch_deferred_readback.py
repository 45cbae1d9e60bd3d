"""Deferred readback and the multi-process lane order, in one process on the
CPU (`hotstuff_tpu_torch/ops/verifier.py`, `hotstuff_tpu_torch/parallel/
mesh.py`).

  * `_defer_readback` on a one-process verifier gives the streamed
    readback's masks bit for bit, with forged lanes in two chunks, on the
    generic path, the committee path and `packed=False` (the port's
    counterpart of tests/test_timeline.py's deferred-readback test, on the
    plain kernels).
  * Two ranks of a multi-process mesh, simulated by two threads whose
    collectives (`FakeCollectives`) swap arrays in memory: each rank runs
    only its own entries' blocks, and the batch's masks, rebuilt chunk by
    chunk from one gather a batch over chunks of different widths, equal
    a one-process mesh's. The kernels are stood in for by cheap functions
    of each lane's bytes, so every lane's verdict tells where it came from.
  * The plain split functions (`sharded_packed`, `sharded_committee`,
    `sharded_verify`) gather across ranks once, and `sharded_qc_counts`
    sums its per-QC counts across ranks with one all-reduce.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from hotstuff_tpu_torch.crypto import pysigner
from hotstuff_tpu_torch.ops import committee as cm
from hotstuff_tpu_torch.ops import ladder
from hotstuff_tpu_torch.ops.verifier import Ed25519TorchVerifier
from hotstuff_tpu_torch.parallel import DeviceMesh, ShardedEd25519TorchVerifier, mesh_2d, sharded_qc_counts
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_mesh import validators
from tests.common_torch_threads import one_torch_thread  # noqa: F401  (autouse)

_M_GATHERS = metrics.counter("mesh.gathers")


def _corpus():
    """tests/test_timeline.py's: 128 lanes over 8 signers, lane 5 (chunk 0
    at 64 lanes a chunk) and lane 100 (chunk 1) forged."""
    pool = []
    for i in range(8):
        pk, _ = pysigner.keypair_from_seed(bytes([i + 1]) * 32)
        m = (b"defer-%d" % i).ljust(32, b"\0")
        pool.append((m, pk, pysigner.sign(bytes([i + 1]) * 32, m, public_key=pk)))
    msgs, pks, sigs = ([pool[i % 8][k] for i in range(128)] for k in range(3))
    rng = np.random.default_rng(5)
    sigs[5] = rng.bytes(64)
    sigs[100] = rng.bytes(64)
    return msgs, pks, sigs


@pytest.mark.parametrize("path", ["generic", "committee", "unpacked"])
def test_deferred_readback_masks_bit_identical(path):
    """Streamed and deferred readback on one process: the same masks, bit
    for bit, valid and forged lanes alike."""
    msgs, pks, sigs = _corpus()
    kw = dict(device="cpu", min_bucket=128, max_bucket=128 if path != "unpacked" else 64, chunk=64,
              packed=path != "unpacked")
    masks = []
    for defer in (False, True):
        v = Ed25519TorchVerifier(**kw)
        v._defer_readback = defer
        try:
            if path == "committee":
                table = v.set_committee(sorted(set(pks)))
                masks.append(v.verify_batch_mask_committee(msgs, [table.index[k] for k in pks], sigs))
            else:
                masks.append(v.verify_batch_mask(msgs, pks, sigs))
        finally:
            v.close()
    want = [i not in (5, 100) for i in range(128)]
    assert masks[0].tolist() == masks[1].tolist() == want


class FakeCollectives:
    """`HostCollectives` for ranks that are threads of one process: each
    call waits for every rank's and swaps the arrays in memory. `calls`
    records (kind, rank) of each."""

    def __init__(self, world: int):
        self.world_size = world
        self._barrier = threading.Barrier(world, timeout=60)
        self._slots: list = [None] * world
        self.calls: list[tuple[str, int]] = []

    def rank(self, r: int) -> "FakeCollectives":
        view = object.__new__(FakeCollectives)
        view.__dict__.update(self.__dict__, _rank=r)
        return view

    def _swap(self, value) -> list:
        self._slots[self._rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()
        return out

    def all_gather(self, local: np.ndarray, lengths) -> list[np.ndarray]:
        assert len(local) == lengths[self._rank]
        self.calls.append(("gather", self._rank))
        return [np.array(x) for x in self._swap(np.array(local))]

    def all_reduce_sum(self, values: np.ndarray) -> np.ndarray:
        self.calls.append(("reduce", self._rank))
        return np.sum(self._swap(np.array(values, np.int64)), axis=0)


def _run_ranks(world: int, fn) -> list:
    """fn(rank) on one thread per rank; their results in rank order."""
    out, errors = [None] * world, []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


@pytest.fixture
def lane_kernels(monkeypatch):
    """Stand-ins for the kernels (generic, committee and f32 forms): each
    lane's verdict a function of its own bytes. Returns the names of the
    threads that ran each call."""
    calls: list[str] = []

    def mark(t: torch.Tensor) -> torch.Tensor:
        calls.append(threading.current_thread().name)
        return t.to(torch.int64).sum(dim=0) % 3 == 0

    monkeypatch.setattr(ladder, "verify_packed128_dh", lambda packed: mark(packed))
    monkeypatch.setattr(cm, "verify_committee96_dh", lambda table, idx, packed: mark(packed) ^ (idx.cpu() % 2 == 0))
    monkeypatch.setattr(ladder, "verify_args", lambda a_y, a_sign, r_enc, s, h, kernel="w4": mark(r_enc) ^ a_sign.bool())
    return calls


@pytest.mark.parametrize("ranks", [(0, 0, 1, 1), (1, 0, 0, 1)], ids=["ranks in order", "ranks interleaved"])
@pytest.mark.parametrize("path", ["generic", "committee", "unpacked"])
def test_two_ranks_rebuild_the_lane_order(lane_kernels, path, ranks):
    """A 4-entry mesh over two ranks, a 1,324-lane batch in chunks of 1,024
    and 512 lanes: each rank runs its two entries' blocks of each chunk
    alone, gathers once, and both rebuild the one-process mesh's masks."""
    rng = np.random.default_rng(11)
    n = 1324
    kps = validators(8)
    keys = [pk for pk, _ in kps]
    msgs = [rng.bytes(32) for _ in range(n)]
    sigs = [rng.bytes(32) + bytes(rng.bytes(31)) + bytes([0 if i % 7 else 0xFF]) for i in range(n)]
    idx = [int(i) for i in rng.integers(0, 8, n)]
    lane_keys = [keys[i] for i in idx]
    kw = dict(max_bucket=1024, packed=path != "unpacked")

    def verify(v):
        try:
            assert v.chunk == v.max_bucket == 1024 and v.min_bucket == 512
            if path == "committee":
                v.set_committee(keys)
                return v.verify_batch_mask_committee(msgs, idx, sigs)
            return v.verify_batch_mask(msgs, lane_keys, sigs)
        finally:
            v.close()

    want = verify(ShardedEd25519TorchVerifier(mesh=DeviceMesh(["cpu"] * 4, ("dp",), (4,)), **kw))
    assert len(lane_kernels) == 2 * 4  # two chunks (pieces) of four blocks
    assert 0 < want.sum() < n and not want[::7].any()  # s >= L on every seventh lane
    lane_kernels.clear()
    hub = FakeCollectives(2)

    def rank(r):
        threading.current_thread().name = f"rank{r}"
        mesh = DeviceMesh(["cpu"] * 4, ("dp",), (4,), ranks=ranks, rank=r, comm=hub.rank(r))
        v = ShardedEd25519TorchVerifier(mesh=mesh, **kw)
        assert v._defer_readback and v.pipeline.depth == 1
        return verify(v)

    got = _run_ranks(2, rank)
    assert got[0].tolist() == got[1].tolist() == want.tolist()
    assert sorted(hub.calls) == [("gather", 0), ("gather", 1)]
    assert sorted(lane_kernels) == ["rank0"] * 4 + ["rank1"] * 4  # each rank: 2 chunks x its 2 blocks


@pytest.mark.parametrize("fn", ["sharded_packed", "sharded_committee", "sharded_verify"])
def test_split_functions_gather_across_ranks(lane_kernels, fn):
    """The plain split functions on a 4-entry mesh over two ranks: each
    rank verifies its own blocks, one gather gives both the one-process
    mask, and `sharded_verify`'s `n_valid` is summed by one all-reduce."""
    from hotstuff_tpu_torch.ops import ed25519 as ted
    from hotstuff_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(13)
    w = 512
    table = ted.CommitteeTable([pk for pk, _ in validators(8)], "cpu")
    args = {
        "sharded_packed": (torch.from_numpy(rng.integers(0, 256, (128, w), np.uint8)),),
        "sharded_committee": (table, torch.from_numpy(rng.integers(0, 8, w).astype(np.int32)),
                              torch.from_numpy(rng.integers(0, 256, (96, w), np.uint8))),
        "sharded_verify": tuple(torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
                                for shape in ((32, w), (w,), (32, w), (64, w), (64, w))),
    }[fn]
    kw = {} if fn == "sharded_verify" else {"device_hash": True}

    def run(mesh):
        out = getattr(pmesh, fn)(mesh, *args, **kw)
        return out if fn == "sharded_verify" else (out, None)

    want, want_n = run(DeviceMesh(["cpu"] * 4, ("dp",), (4,)))
    assert 0 < int(want.sum()) < w
    hub = FakeCollectives(2)

    def rank(r):
        return run(DeviceMesh(["cpu"] * 4, ("dp",), (4,), ranks=(0, 1, 1, 0), rank=r, comm=hub.rank(r)))

    for mask, n_valid in _run_ranks(2, rank):
        assert torch.equal(mask, want)
        assert n_valid is None or int(n_valid) == int(want_n) == int(want.sum())
    kinds = ["gather", "reduce"] if fn == "sharded_verify" else ["gather"]
    assert sorted(hub.calls) == sorted((k, r) for k in kinds for r in (0, 1))


def test_sharded_qc_counts_sums_across_ranks(lane_kernels):
    """A (qc, dp) = (2, 2) mesh whose rows each span both ranks: the per-QC
    counts come from one all-reduce of each rank's partials and the masks
    from one gather, and both equal the one-process mesh's."""
    rng = np.random.default_rng(12)
    packed = rng.integers(0, 256, (4, 128, 6), np.uint8)
    s_ok = rng.random((4, 6)) < 0.8
    want_masks, want_counts = sharded_qc_counts(mesh_2d(2, 2, devices=["cpu"] * 4), packed, s_ok)
    assert 0 < int(want_counts.sum()) < 24
    hub = FakeCollectives(2)

    def rank(r):
        mesh = DeviceMesh(["cpu"] * 4, ("qc", "dp"), (2, 2), ranks=(0, 1, 0, 1), rank=r, comm=hub.rank(r))
        return sharded_qc_counts(mesh, packed, s_ok)

    for masks, counts in _run_ranks(2, rank):
        assert torch.equal(masks, want_masks) and torch.equal(counts, want_counts)
    assert sorted(hub.calls) == [("gather", 0), ("gather", 1), ("reduce", 0), ("reduce", 1)]


def test_gather_chunks_counts_one_gather():
    """`gather_chunks` counts each gather once in `mesh.gathers`; a
    one-process verifier never gathers."""
    from hotstuff_tpu_torch.parallel import gather_chunks

    hub = FakeCollectives(2)
    before = _M_GATHERS.value

    def rank(r):
        mesh = DeviceMesh(["cpu"] * 2, ("dp",), (2,), ranks=(0, 1), rank=r, comm=hub.rank(r))
        return gather_chunks(mesh, [np.full(3, r, bool), np.full(1, r, bool)], [3, 1])

    for chunks in _run_ranks(2, rank):
        assert [c.tolist() for c in chunks] == [[False] * 3 + [True] * 3, [False, True]]
    assert _M_GATHERS.value - before == 2  # one for each rank's call
