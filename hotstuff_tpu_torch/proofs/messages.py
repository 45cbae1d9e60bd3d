"""Commit-proof wire messages: the O(1) finality certificate a client
gets back for a committed transaction, and the query/reply envelopes the
proof port speaks.

A `CommitProof` is the minimal statement a STATELESS client can check
with nothing but the committee's public keys: the committed block's
digest preimage fields (author, round, payload digests, parent link) and
the CERTIFYING certificate — the quorum certificate carried by the
block's successor, whose `hash` field IS the committed block's digest.
Verification recomputes the block digest from the header fields and then
verifies the certificate against it, so a proof cannot be grafted onto a
different payload set without breaking 2f+1 signatures. With aggregate
certificates (AggQC) the whole proof is ~300 B at ANY committee size —
the constant-size-quorums payoff served to clients.

What a proof claims (and honestly does not): the certificate proves
2f+1 of the committee CERTIFIED the block — by HotStuff safety at most
one certified block per round exists, and the serving node only ever
constructs proofs for blocks on its locally COMMITTED 2-chain. A client
that trusts at least one honest committee member to serve proofs gets
commit finality; a client trusting nobody still gets certification
(no conflicting block at that round can also reach quorum).

The codec is versioned like the certificate plane: one leading version
byte. Version 1 (current) carries an optional epoch-change digest and
either certificate form behind the `encode_any_qc` tag; version 0 is
the pre-reconfig legacy layout (no epoch field, bare entry-list QC) and
still decodes — the same forward-compat discipline AggQC introduced.

The port's copy of `hotstuff_tpu/proofs/messages.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..consensus.messages import (
    QC,
    AggQC,
    decode_any_qc,
    encode_any_qc,
)
from ..crypto import Digest, PublicKey, sha512_32
from ..utils.serde import Reader, SerdeError, Writer

PROOF_VERSION = 1  # current layout; version 0 = legacy (bare QC, no epoch)

# Reply statuses (ProofReply.status).
PROOF_OK = 0  # proof attached
PROOF_PENDING = 1  # (client, nonce) admitted, not yet committed: poll later
PROOF_SHED = 2  # subscription table full / unknown-nonce subscribe: back off
PROOF_UNKNOWN = 3  # (client, nonce) never admitted here
PROOF_MALFORMED = 4  # undecodable frame / unknown shape

PROOF_STATUS_NAMES = {
    PROOF_OK: "ok",
    PROOF_PENDING: "pending",
    PROOF_SHED: "shed",
    PROOF_UNKNOWN: "unknown",
    PROOF_MALFORMED: "malformed",
}

# Query modes (ProofQuery.mode).
MODE_QUERY = 0  # answer immediately (OK / PENDING / UNKNOWN)
MODE_SUBSCRIBE = 1  # hold until commit; shed with a retry hint when bounded out

TAG_PROOF_QUERY = 0
TAG_PROOF_REPLY = 1


class ProofVerificationError(Exception):
    """The proof's internal binding failed BEFORE certificate crypto:
    certificate hash does not match the recomputed block digest, wrong
    round, or the queried payload digest is not in the block."""


@dataclass(frozen=True, slots=True)
class CommitProof:
    """One committed block's finality certificate, self-contained.

    `payload` is the block's ordered payload digests; `parent_hash` and
    `parent_round` are the block's OWN embedded QC link (part of the
    digest preimage, so they must travel); `cert` is the SUCCESSOR
    block's certificate over this block's digest — the 2-chain edge that
    certified it. `reconfig_digest` is the carried epoch change's digest
    when the block had one (committed-to only when present, mirroring
    Block.make_digest)."""

    author: PublicKey
    round: int
    payload: tuple[Digest, ...]
    parent_hash: Digest
    parent_round: int
    cert: QC | AggQC
    reconfig_digest: Digest | None = None

    def block_digest(self) -> Digest:
        """Recompute the committed block's digest from the header fields
        — byte-for-byte the Block.make_digest preimage, rebuilt here so
        a stateless client needs no Block object (and no payload
        bodies), only this proof."""
        # graftlint: allow[wire-schema] deliberate SAME-artifact recomputation: a proof binds to the consensus Block digest, byte-for-byte the Block.make_digest preimage
        h = b"HSBLOCK" + self.author.data + struct.pack("<Q", self.round)
        for d in self.payload:
            h += d.data
        h += self.parent_hash.data + struct.pack("<Q", self.parent_round)
        if self.reconfig_digest is not None:
            h += b"HSEPOCH" + self.reconfig_digest.data
        return Digest(sha512_32(h))

    def verify(self, committee, payload_digest: Digest | None = None) -> None:
        """Stateless verification: recompute the block digest, check the
        certificate binds to it (same hash, certificate round = block
        round — the vote digest domain-separates both), then verify the
        certificate's quorum + signatures against `committee`. With
        `payload_digest`, additionally require the queried transaction's
        digest to be IN the committed payload set. Raises on failure."""
        digest = self.block_digest()
        if self.cert.hash != digest:
            raise ProofVerificationError(
                "certificate does not bind the recomputed block digest"
            )
        if self.cert.round != self.round:
            raise ProofVerificationError(
                f"certificate round {self.cert.round} != block round {self.round}"
            )
        if payload_digest is not None and payload_digest not in self.payload:
            raise ProofVerificationError(
                "queried payload digest not in the committed block"
            )
        self.cert.verify(committee)

    def encode(self, w: Writer, version: int = PROOF_VERSION) -> None:
        w.u8(version)
        w.fixed(self.author.data, 32)
        w.u64(self.round)
        w.seq(list(self.payload), lambda wr, d: wr.fixed(d.data, 32))
        w.fixed(self.parent_hash.data, 32)
        w.u64(self.parent_round)
        if version == 0:
            # Legacy layout: reconfig-free, entry-list certificate only.
            if self.reconfig_digest is not None:
                raise ValueError("version-0 proofs cannot carry an epoch change")
            if not isinstance(self.cert, QC):
                raise ValueError("version-0 proofs carry entry-list QCs only")
            self.cert.encode(w)
            return
        if version != PROOF_VERSION:
            raise ValueError(f"unknown proof version {version}")
        if self.reconfig_digest is None:
            w.u8(0)
        else:
            w.u8(1)
            w.fixed(self.reconfig_digest.data, 32)
        encode_any_qc(w, self.cert)

    @staticmethod
    def decode(r: Reader) -> "CommitProof":
        version = r.u8()
        if version > PROOF_VERSION:
            raise SerdeError(f"unknown proof version {version}")
        author = PublicKey(r.fixed(32))
        round_ = r.u64()
        payload = tuple(r.seq(lambda rd: Digest(rd.fixed(32))))
        parent_hash = Digest(r.fixed(32))
        parent_round = r.u64()
        if version == 0:
            return CommitProof(
                author, round_, payload, parent_hash, parent_round, QC.decode(r)
            )
        reconfig_digest = Digest(r.fixed(32)) if r.u8() else None
        cert = decode_any_qc(r)
        return CommitProof(
            author, round_, payload, parent_hash, parent_round, cert,
            reconfig_digest,
        )

    def encoded_size(self) -> int:
        w = Writer()
        self.encode(w)
        return len(w.bytes())

    def __str__(self) -> str:
        return (
            f"CommitProof(B{self.round}, {len(self.payload)} payloads, "
            f"cert={self.cert})"
        )


@dataclass(frozen=True, slots=True)
class ProofQuery:
    """One finality question: has (client, nonce)'s transaction
    committed? `MODE_QUERY` answers immediately; `MODE_SUBSCRIBE` parks
    the reply until the commit lands (bounded — see server.py)."""

    client: PublicKey
    nonce: int
    mode: int = MODE_QUERY

    def encode(self, w: Writer) -> None:
        w.fixed(self.client.data, 32)
        w.u64(self.nonce)
        w.u8(self.mode)

    @staticmethod
    def decode(r: Reader) -> "ProofQuery":
        return ProofQuery(PublicKey(r.fixed(32)), r.u64(), r.u8())


@dataclass(frozen=True, slots=True)
class ProofReply:
    """Per-query outcome, correlated by the echoed nonce (same
    discipline as IngressResponse). SHED and PENDING carry
    `retry_after_ms` — the node's estimate of when asking again has a
    real chance; OK carries the proof itself."""

    nonce: int
    status: int
    retry_after_ms: int = 0
    proof: CommitProof | None = None

    @property
    def status_name(self) -> str:
        return PROOF_STATUS_NAMES.get(self.status, f"status-{self.status}")

    def encode(self, w: Writer) -> None:
        w.u64(self.nonce)
        w.u8(self.status)
        w.u32(self.retry_after_ms)
        if self.proof is None:
            w.u8(0)
        else:
            w.u8(1)
            self.proof.encode(w)

    @staticmethod
    def decode(r: Reader) -> "ProofReply":
        nonce = r.u64()
        status = r.u8()
        retry = r.u32()
        proof = CommitProof.decode(r) if r.u8() else None
        return ProofReply(nonce, status, retry, proof)


def encode_proof_message(msg) -> bytes:
    w = Writer()
    if isinstance(msg, ProofQuery):
        w.u8(TAG_PROOF_QUERY)
    elif isinstance(msg, ProofReply):
        w.u8(TAG_PROOF_REPLY)
    else:
        raise TypeError(f"not a proof message: {msg!r}")
    msg.encode(w)
    return w.bytes()


def decode_proof_message(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_PROOF_QUERY:
        out = ProofQuery.decode(r)
    elif tag == TAG_PROOF_REPLY:
        out = ProofReply.decode(r)
    else:
        raise SerdeError(f"unknown proof tag {tag}")
    r.expect_done()
    return out
