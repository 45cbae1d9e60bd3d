"""The port's node: configuration files, the composition root (`Node`),
the benchmark client and the `node` binary (`python -m
hotstuff_tpu_torch.node.main`), as the reference's `hotstuff_tpu/node/`."""

from .config import Committee, NodeParameters, Secret
from .node import Node

__all__ = ["Committee", "NodeParameters", "Secret", "Node"]
