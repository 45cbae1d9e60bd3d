"""Consensus error types (reference consensus/src/error.rs:24-65).

The port's copy of `hotstuff_tpu/consensus/errors.py`, its imports rewritten to this
package.
"""

from __future__ import annotations


class ConsensusError(Exception):
    pass


class InvalidSignatureError(ConsensusError):
    pass


class WrongLeaderError(ConsensusError):
    def __init__(self, block_round: int, author, leader) -> None:
        super().__init__(
            f"wrong leader for round {block_round}: got {author}, expected {leader}"
        )


class AuthorityReuseError(ConsensusError):
    def __init__(self, name) -> None:
        super().__init__(f"authority {name} appears twice in certificate")


class UnknownAuthorityError(ConsensusError):
    def __init__(self, name) -> None:
        super().__init__(f"unknown authority {name}")


class QCRequiresQuorumError(ConsensusError):
    pass


class TCRequiresQuorumError(ConsensusError):
    pass


class MalformedBlockError(ConsensusError):
    pass


class ReconfigError(ConsensusError):
    """An EpochChange that violates the epoch-commit rule's admission
    checks (sequence, activation margin, empty successor set)."""


def ensure(cond: bool, err: ConsensusError) -> None:
    """The reference's ensure! macro (consensus/src/error.rs)."""
    if not cond:
        raise err
