"""`sharded_qc_counts` (`hotstuff_tpu_torch/parallel/mesh.py`) against the
JAX package's `sharded_qc_verify_fn` at `dryrun_multichip(8)`'s shapes, on
the CPU: a (qc, dp) = 2 x 4 mesh (8 virtual CPU shards for the port, 8 of
tests/conftest.py's virtual CPU devices for JAX), 2 QCs of 8 votes.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from hotstuff_tpu.ops import ed25519 as jed
from hotstuff_tpu.parallel import mesh as jmesh
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.parallel import default_mesh, mesh_2d, sharded_qc_counts
from tests.common_torch_threads import one_torch_thread  # noqa: F401


def test_qc_counts_equal_sharded_qc_verify_fn():
    """`_signed_batch(16)` with a forged R, an s + L and a wrong message
    among the votes: masks and counts exact; a batch that does not split
    over the mesh, or a mesh without (qc, dp) axes, raises."""
    from __graft_entry__ import _signed_batch

    msgs, pks, sigs = _signed_batch(16)
    sigs[1] = bytes([sigs[1][0] ^ 1]) + sigs[1][1:]
    s_int = int.from_bytes(sigs[10][32:], "little") + ted.L_ORDER
    sigs[10] = sigs[10][:32] + s_int.to_bytes(32, "little")
    msgs[12] = bytes([msgs[12][0] ^ 1]) + msgs[12][1:]
    staged = jed.prepare_batch(msgs, pks, sigs)
    qc = lambda a: np.moveaxis(a.reshape(a.shape[:-1] + (2, 8)), -2, 0)
    fn = jmesh.sharded_qc_verify_fn(jmesh.mesh_2d(2, 4, devices=jax.devices()[:8]))
    jmask, jcounts = fn(*(qc(staged[k]) for k in ("a_y", "a_sign", "r_enc", "s_digits", "h_digits")),
                        qc(staged["s_ok"].astype(bool)))
    ours = ted.prepare_batch_packed_dh(msgs, pks, sigs)
    packed = ours["packed"].reshape(128, 2, 8).transpose(1, 0, 2)
    mesh = mesh_2d(2, 4, devices=["cpu"] * 8)
    mask, counts = sharded_qc_counts(mesh, packed, ours["s_ok"].reshape(2, 8))
    assert mask.tolist() == np.asarray(jmask).tolist()
    assert counts.dtype == torch.int32 and counts.tolist() == np.asarray(jcounts).tolist() == [7, 6]
    with pytest.raises(ValueError, match="does not split"):
        sharded_qc_counts(mesh, packed[:, :, :6], ours["s_ok"].reshape(2, 8)[:, :6])
    with pytest.raises(ValueError, match="qc, dp"):
        sharded_qc_counts(default_mesh(8, device="cpu"), packed, ours["s_ok"].reshape(2, 8))
