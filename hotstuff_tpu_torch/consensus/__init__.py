"""The port's copy of `hotstuff_tpu/consensus/__init__.py`, its imports rewritten to this
package."""

from .config import Authority, Committee, Parameters
from .consensus import Consensus
from .messages import (
    QC,
    TC,
    Block,
    LoopBack,
    Round,
    SyncRangeReply,
    SyncRangeRequest,
    SyncRequest,
    Timeout,
    Vote,
)
from .reconfig import EpochChange, EpochManager, EpochSchedule

__all__ = [
    "Authority",
    "Committee",
    "Parameters",
    "Consensus",
    "EpochChange",
    "EpochManager",
    "EpochSchedule",
    "QC",
    "TC",
    "Block",
    "LoopBack",
    "Round",
    "SyncRangeReply",
    "SyncRangeRequest",
    "SyncRequest",
    "Timeout",
    "Vote",
]
