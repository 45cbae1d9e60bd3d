"""Device-mesh parallelism for the port's crypto plane: batches split over a
mesh of devices, committee tables replicated per device, per-QC quorum
counts, the f32-argument form (`sharded_verify`), and meshes that span
processes (`init_multihost`, with their gloo collectives, `HostCollectives`)
(`hotstuff_tpu/parallel/__init__.py`)."""

from .mesh import (
    DeviceMesh,
    HostCollectives,
    ShardedEd25519TorchVerifier,
    default_mesh,
    gather_chunks,
    init_multihost,
    mesh_2d,
    replicate,
    sharded_committee,
    sharded_packed,
    sharded_qc_counts,
    sharded_verify,
)

__all__ = [
    "DeviceMesh",
    "HostCollectives",
    "ShardedEd25519TorchVerifier",
    "default_mesh",
    "gather_chunks",
    "init_multihost",
    "mesh_2d",
    "replicate",
    "sharded_committee",
    "sharded_packed",
    "sharded_qc_counts",
    "sharded_verify",
]
