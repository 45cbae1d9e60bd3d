"""Commit-proof serving plane: per-node registry indexing the
commit path, the O(1) CommitProof wire object, and the framed-TCP
serving front-end. Closes the submit→commit→proof loop: the same
clients the ingress plane admits get finality certificates back.

The port's copy of `hotstuff_tpu/proofs/__init__.py`, its imports rewritten to this
package.
"""

from .messages import (
    MODE_QUERY,
    MODE_SUBSCRIBE,
    PROOF_OK,
    PROOF_PENDING,
    PROOF_SHED,
    PROOF_UNKNOWN,
    CommitProof,
    ProofQuery,
    ProofReply,
    ProofVerificationError,
    decode_proof_message,
    encode_proof_message,
)
from .registry import ProofRegistry
from .server import ProofClient, ProofServer, ProofService

__all__ = [
    "MODE_QUERY",
    "MODE_SUBSCRIBE",
    "PROOF_OK",
    "PROOF_PENDING",
    "PROOF_SHED",
    "PROOF_UNKNOWN",
    "CommitProof",
    "ProofQuery",
    "ProofReply",
    "ProofVerificationError",
    "decode_proof_message",
    "encode_proof_message",
    "ProofRegistry",
    "ProofClient",
    "ProofServer",
    "ProofService",
]
