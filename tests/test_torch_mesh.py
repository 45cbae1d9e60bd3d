"""The port's sharded verifier (`hotstuff_tpu_torch/parallel/mesh.py`)
against the JAX package's mesh (`hotstuff_tpu/parallel/mesh.py`), on the CPU.

Virtual meshes of n shards on the CPU stand in for n devices, as the 8
virtual CPU devices of tests/conftest.py do for JAX:
  * bucket alignment and warmup sizes against `ShardedEd25519Verifier` /
    `TpuBackend(mesh=...)` built on the same arguments (nothing compiles);
  * one committee device-hash case against `ShardedEd25519Verifier` on a
    4-device JAX mesh (the fixture of tests/test_mesh_committee.py);
  * the meshes, the shard-major staging, the plain split functions, the
    replicas and the counters, and the sharded backend behind the sidecar.
The masks at 2 shards against the JAX single-chip mask are in
tests/test_torch_mesh_masks.py, and the QC counts against
`sharded_qc_verify_fn` in tests/test_torch_mesh_qc.py: each JAX trace costs
tens of seconds, and separate files let the suite's workers share them.
The port's plain kernels take about 1.3 s a call on the CPU, whatever the
width, and a sharded chunk makes one call per shard: the corpora are a
dozen lanes in one chunk.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from hotstuff_tpu.crypto.tpu_backend import TpuBackend
from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.parallel import mesh as jmesh
from hotstuff_tpu_torch import convert
from hotstuff_tpu_torch.crypto import remote
from hotstuff_tpu_torch.crypto.backend import make_backend
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.crypto.torch_backend import TorchBackend
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.parallel import (
    DeviceMesh,
    default_mesh,
    mesh_2d,
    replicate,
    sharded_committee,
    sharded_packed,
)
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_mesh import cpu_mesh_verifier, digest_corpus, validators
from tests.common_torch_threads import one_torch_thread  # noqa: F401

_M_DECOMP = metrics.counter("verifier.decompressions")
_M_BUILDS = metrics.counter("verifier.table_builds")
_M_CBATCHES = metrics.counter("verifier.committee_batches")
_M_PAD = metrics.counter("verifier.pad_lanes")


# -- meshes and bucket alignment -----------------------------------------------


@pytest.mark.parametrize("ndev", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("buckets", [(600, 4096, None), (128, 8192, None), (128, 512, None), (384, 3000, 1000)])
def test_alignment_and_warmup_sizes_match_the_reference(ndev, buckets):
    """`mesh_alignment`, `min_bucket` (rounded up), `max_bucket` (rounded
    down), `chunk`, the backend's bucket grid and its warmup sizes equal the
    reference's on the same arguments (ndev None: the single-device
    backends)."""
    mn, mx, chunk = buckets
    kw = dict(min_bucket=mn, max_bucket=mx, chunk=chunk)
    if ndev is None:
        ref, ours = TpuBackend(**kw), TorchBackend(device="cpu", **kw)
    else:
        ref = TpuBackend(mesh=jmesh.default_mesh(ndev), **kw)
        ours = make_backend("torch", mesh=default_mesh(ndev, device="cpu"), **kw)
        assert ours._verifier.mesh_alignment == ref._verifier.mesh_alignment == 128 * ndev
    rv, v = ref._verifier, ours._verifier
    try:
        assert (v.min_bucket, v.max_bucket, v.chunk) == (rv.min_bucket, rv.max_bucket, rv.chunk)
        assert ours.bucket_alignment == ref.bucket_alignment
        assert ours._warmup_widths() == ref._warmup_widths()
        widths = [v._bucket(n) for n in ours._warmup_widths()]
        assert len(set(widths)) == len(widths) and v.min_bucket in widths
        if ndev is not None:
            assert all(w % ours.bucket_alignment == 0 for w in widths)
    finally:
        ours.close()
        ref.close()


def test_meshes_never_run_on_fewer_devices_than_asked(monkeypatch):
    """Deliberate departure from the reference: too few GPUs raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (default_mesh, lambda: default_mesh(2), lambda: mesh_2d(1, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_backend("torch", sharded=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(RuntimeError, match="2 GPUs asked for, 1 visible"):
        default_mesh(2)
    with pytest.raises(RuntimeError, match="4 GPUs asked for, 1 visible"):
        mesh_2d(2, 2)
    with pytest.raises(RuntimeError, match="needs 4 devices, 3 given"):
        mesh_2d(2, 2, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="one type"):
        DeviceMesh(["cpu", "cuda:0"], ("dp",), (2,))
    with pytest.raises(ValueError):
        default_mesh(0, device="cpu")
    virtual = mesh_2d(2, 2, devices=["cpu"] * 4)
    assert virtual.shape == {"qc": 2, "dp": 2} and virtual.distinct == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="devices from its mesh"):
        TorchBackend(mesh=virtual, device="cpu")


# -- masks against the JAX single-chip reference ------------------------------


def test_committee_device_hash_equals_the_jax_mesh():
    """The one case against the JAX mesh itself: tests/test_mesh_committee.py's
    fixture (`ShardedEd25519Verifier(mesh=default_mesh(4), max_bucket=512,
    kernel="w4")`, 8 validators) against the port's verifier on a 4-shard
    virtual mesh, on the committee device-hash path."""
    kps = validators(8)
    committee = [pk for pk, _ in kps]
    msgs, idx, sigs, want = digest_corpus(kps)
    ref = jmesh.ShardedEd25519Verifier(mesh=jmesh.default_mesh(4), max_bucket=512, kernel="w4")
    ours = cpu_mesh_verifier(4, max_bucket=512)
    try:
        ref.set_committee(committee)
        ours.set_committee(committee)
        assert (ours.min_bucket, ours.max_bucket) == (ref.min_bucket, ref.max_bucket) == (512, 512)
        theirs = np.asarray(ref.verify_batch_mask_committee(msgs, idx, sigs)).tolist()
        got = ours.verify_batch_mask_committee(msgs, idx, sigs).tolist()
    finally:
        ref.close()
        ours.close()
    assert got == theirs == want


def test_pad_shards_lays_lanes_out_shard_major():
    """A chunk's (rows, n) wire array padded to `width` lanes in a pooled
    (shards, rows, width / shards) buffer: shard s holds lanes [s w,
    (s + 1) w), zeros past n, and one shard is the plain padded array."""
    from hotstuff_tpu_torch.ops.pipeline import StagingBufferPool
    from hotstuff_tpu_torch.ops.verifier import pad_shards

    pool = StagingBufferPool()
    arr = np.arange(15, dtype=np.uint8).reshape(3, 5) + 1
    out = pad_shards(pool, arr, 8, 2)
    assert out.shape == (2, 3, 4)
    assert np.array_equal(out[0], arr[:, :4]) and np.array_equal(out[1, :, 0], arr[:, 4])
    assert not out[1, :, 1:].any()
    pool.give(out)
    again = pad_shards(pool, arr[:, :2], 8, 4)  # a reused buffer is zeroed past n
    assert again.shape == (4, 3, 2) and np.array_equal(again[0], arr[:, :2]) and not again[1:].any()
    one = pad_shards(pool, arr, 8, 1)
    assert one.shape == (1, 3, 8) and np.array_equal(one[0, :, :5], arr) and not one[0, :, 5:].any()


def test_plain_sharded_functions_join_shard_masks_in_lane_order():
    """`sharded_packed` and `sharded_committee` on 2 shards of 8 lanes give
    the corpus's expected mask (before the host s < L check, which only the
    s + L lane fails)."""
    kps = validators(4)
    committee = [pk for pk, _ in kps]
    msgs, idx, sigs, want = digest_corpus(kps, n_valid=11)
    s_plus_l = len(msgs) - 1
    device_want = want[:s_plus_l] + [True]
    mesh = default_mesh(2, device="cpu")
    generic = ted.prepare_batch_packed_dh(msgs, [committee[i] for i in idx], sigs)
    got = sharded_packed(mesh, torch.from_numpy(generic["packed"]), device_hash=True)
    assert got.tolist() == device_want and (got.numpy() & generic["s_ok"]).tolist() == want
    table = replicate(ted.CommitteeTable(committee, device="cpu"), mesh.distinct)
    st = ted.prepare_batch_committee_dh(msgs, idx, sigs)
    got = sharded_committee(mesh, table, torch.from_numpy(st["idx"]), torch.from_numpy(st["packed"]), device_hash=True)
    assert got.tolist() == device_want
    with pytest.raises(ValueError, match="do not split evenly"):
        sharded_packed(mesh, torch.from_numpy(generic["packed"][:, :15]))


# -- counters and contracts ---------------------------------------------------


def test_registration_decompresses_once_and_replicas_equal_the_jax_table(monkeypatch):
    """A registration on a 4-shard mesh decompresses each key once on the
    host and counts no decompression or table build; its replicas (one per
    distinct device) equal the JAX table, and a copy to another device
    shares keys and index and redoes no host work."""
    committee = [pk for pk, _ in validators(8)]
    calls = []
    real = ted.decompress_int
    monkeypatch.setattr(ted, "decompress_int", lambda k: calls.append(k) or real(k))
    v = cpu_mesh_verifier(4)
    d0, b0 = _M_DECOMP.value, _M_BUILDS.value
    table = v.set_committee(committee)
    assert len(calls) == len(committee) and (_M_DECOMP.value, _M_BUILDS.value) == (d0, b0)
    assert v.set_committee(list(committee)) is table and len(calls) == len(committee)
    assert list(table.replicas) == [torch.device("cpu")] and table.replicas[torch.device("cpu")] is table
    entries, valid, keys_u8 = convert.committee_table_from_jax(jed.CommitteeTable(committee))
    for replica in table.replicas.values():
        assert torch.equal(replica.entries, entries) and torch.equal(replica.valid, valid)
        assert torch.equal(replica.keys_u8, keys_u8)
    meta = torch.device("meta")
    replicate(table, [meta, meta, torch.device("cpu")])
    assert list(table.replicas) == [torch.device("cpu"), meta] and len(calls) == len(committee)
    copy = table.replicas[meta]
    assert copy.keys is table.keys and copy.index is table.index and copy.entries.device == meta
    assert table.to("cpu") is table
    v.close()


def test_committee_batches_decompress_nothing_and_keep_a_pinned_snapshot():
    """tests/test_mesh_committee.py's steady-state, pad-lanes and pinning
    checks on a 2-shard mesh: after t2 (the keys reversed) replaces t1, a
    batch pinned to t1 keeps t1 and its replicas and gives the expected
    mask, counts no decompression and no table build, one committee batch,
    and pads its 13 lanes to the 256-lane mesh bucket; an identical key
    list rebuilds nothing."""
    kps = validators(4)
    committee = [pk for pk, _ in kps]
    msgs, idx, sigs, want = digest_corpus(kps)
    v = cpu_mesh_verifier(2, max_bucket=256)
    t1 = v.set_committee(committee)
    t2 = v.set_committee(list(reversed(committee)))
    assert t2 is not t1 and v.committee is t2 and t1.replicas[torch.device("cpu")] is t1
    d0, b0, c0, p0 = _M_DECOMP.value, _M_BUILDS.value, _M_CBATCHES.value, _M_PAD.value
    assert v.verify_batch_mask_committee(msgs, idx, sigs, table=t1).tolist() == want
    assert (_M_DECOMP.value, _M_BUILDS.value) == (d0, b0)
    assert _M_CBATCHES.value == c0 + 1 and _M_PAD.value == p0 + 256 - len(msgs)
    assert v.set_committee(list(reversed(committee))) is t2
    v.close()


# -- the sidecar --------------------------------------------------------------


def test_sharded_backend_behind_the_sidecar_answers_a_qc(run_async):
    """`TorchBackend` on a 2-shard CPU mesh behind `remote.start`, with the
    committee registered (one replica per distinct device): the port's
    client gets the QC's expected mask, every lane verified by the backend."""
    kps = validators(4)
    committee = [pk for pk, _ in kps]
    msgs, idx, sigs, want = digest_corpus(kps)
    backend = TorchBackend(mesh=default_mesh(2, device="cpu"), crossover=1, max_bucket=256)
    assert backend.register_committee(committee) == 4 and backend.bucket_alignment == 256
    assert len(backend._verifier.committee.replicas) == 1

    async def body():
        server, _ = await remote.start(("127.0.0.1", 0), backend)
        client = remote.RemoteBackend(("127.0.0.1", server.sockets[0].getsockname()[1]), crossover=1)
        try:
            return await asyncio.to_thread(
                client.verify_batch_mask, msgs, [PublicKey(committee[i]) for i in idx], [Signature(s) for s in sigs]
            )
        finally:
            client.close()
            server.close()

    assert run_async(body()) == want
    assert backend.stats["device_sigs"] == len(msgs) and backend.stats["host_sigs"] == 0
    backend.close()


def test_sidecar_cli_sharded_needs_the_card():
    with pytest.raises(SystemExit) as e:
        remote.main(["--port", "0", "--sharded", "--device", "cpu"])
    assert e.value.code == 2
