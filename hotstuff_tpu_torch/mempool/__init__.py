"""The port's copy of `hotstuff_tpu/mempool/__init__.py`, its imports rewritten to this
package."""

from .config import MempoolCommittee, MempoolParameters
from .mempool import Mempool
from .messages import Payload, PayloadRequest, Transaction

__all__ = [
    "MempoolCommittee",
    "MempoolParameters",
    "Mempool",
    "Payload",
    "PayloadRequest",
    "Transaction",
]
