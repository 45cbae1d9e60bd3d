"""Typed mempool errors (reference mempool/src/error.rs).

The reference rejects Byzantine payloads with `MempoolError` variants via
`bail!`/`ensure!`; mirroring that here makes the ingress behaviour testable
by assertion (a dropped payload carries WHY it was dropped, not just a log
line). The consensus plane has the same pattern in consensus/errors.py.

The port's copy of `hotstuff_tpu/mempool/errors.py`, its imports rewritten to this
package.
"""

from __future__ import annotations


class MempoolError(Exception):
    """Base for every typed mempool rejection."""


class UnknownAuthorityError(MempoolError):
    def __init__(self, author) -> None:
        self.author = author
        super().__init__(f"payload from unknown authority {author}")


class PayloadTooBigError(MempoolError):
    def __init__(self, size: int, cap: int) -> None:
        self.size = size
        self.cap = cap
        super().__init__(f"payload size {size} exceeds cap {cap}")


class InvalidPayloadSignatureError(MempoolError):
    def __init__(self, author) -> None:
        self.author = author
        super().__init__(f"invalid payload signature from {author}")


class QueueFullError(MempoolError):
    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        super().__init__(f"mempool queue full (capacity {capacity})")


def ensure(condition: bool, error: MempoolError) -> None:
    """The reference's ensure! macro (mempool/src/error.rs)."""
    if not condition:
        raise error
