"""Device-mesh parallelism for the port's crypto plane: batches split over a
mesh of devices, committee tables replicated per device, per-QC quorum
counts (`hotstuff_tpu/parallel/__init__.py`, without `init_multihost` and
`sharded_verify_fn`, which are not ported)."""

from .mesh import (
    DeviceMesh,
    ShardedEd25519TorchVerifier,
    default_mesh,
    mesh_2d,
    replicate,
    sharded_committee,
    sharded_packed,
    sharded_qc_counts,
)

__all__ = [
    "DeviceMesh",
    "ShardedEd25519TorchVerifier",
    "default_mesh",
    "mesh_2d",
    "replicate",
    "sharded_committee",
    "sharded_packed",
    "sharded_qc_counts",
]
