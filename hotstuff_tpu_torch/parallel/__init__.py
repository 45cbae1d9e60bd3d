"""Device-mesh parallelism for the port's crypto plane: batches split over a
mesh of devices, committee tables replicated per device, per-QC quorum
counts, the f32-argument form (`sharded_verify`)
(`hotstuff_tpu/parallel/__init__.py`, without `init_multihost`, which is not
ported)."""

from .mesh import (
    DeviceMesh,
    ShardedEd25519TorchVerifier,
    default_mesh,
    mesh_2d,
    replicate,
    sharded_committee,
    sharded_packed,
    sharded_qc_counts,
    sharded_verify,
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
    "sharded_verify",
]
