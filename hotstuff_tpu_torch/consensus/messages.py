"""Quorum certificates on the wire: the entry-list `QC` and the
constant-size `AggQC`.

A trimmed copy of `hotstuff_tpu/consensus/messages.py` (`QC` `:89-168`,
`AggQC` `:270-330`, the vote digest and the vote and bitmap codecs) for
the bench's `--aggregate-ab` leg: `signed_digest`, `encode` and `decode`,
byte for byte the reference's. A QC carries 2f+1 (public key, signature)
entries over one vote digest; an AggQC carries one BLS12-381 signature
over the same digest and a fixed 64-byte bitmap of the signing members.

Not copied: the other messages (Block, Vote, Timeout, TC, AggTC, ...),
the committee and epoch resolution, and the `check_quorum` / `verify`
methods, which need the reference's `Committee`. The bench verifies each
form itself: the QC's entries with `pysigner`, the AggQC through
`ops/bls.py` `CommitteeTable.verify_aggregate`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..crypto.primitives import Digest, PublicKey, Signature, sha512_32
from ..utils.serde import Reader, Writer

Round = int  # u64

# The committee bitmap of an aggregate certificate: bit i is member i of
# the round's committee in sorted key order (`hotstuff_tpu/crypto/aggsig.py:98`).
AGG_BITMAP_BYTES = 64


def _vote_digest(hash_: Digest, round_: Round) -> Digest:
    """Digest signed by a Vote and verified by a QC (must coincide)."""
    return Digest(sha512_32(b"HSVOTE" + hash_.data + struct.pack("<Q", round_)))


def _encode_votes(w: Writer, votes: list[tuple[PublicKey, Signature]]) -> None:
    w.seq(votes, lambda wr, v: (wr.fixed(v[0].data, 32), wr.fixed(v[1].data, 64)))


def _decode_votes(r: Reader) -> list[tuple[PublicKey, Signature]]:
    return r.seq(lambda rd: (PublicKey(rd.fixed(32)), Signature(rd.fixed(64))))


def _encode_bitmap(w: Writer, bitmap: int) -> None:
    w.fixed(bitmap.to_bytes(AGG_BITMAP_BYTES, "little"), AGG_BITMAP_BYTES)


def _decode_bitmap(r: Reader) -> int:
    return int.from_bytes(r.fixed(AGG_BITMAP_BYTES), "little")


@dataclass(frozen=True, slots=True)
class QC:
    """Quorum certificate: 2f+1 vote signatures over one block digest
    (consensus/src/messages.rs:150-226)."""

    hash: Digest
    round: Round
    votes: tuple[tuple[PublicKey, Signature], ...]

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def encode(self, w: Writer) -> None:
        w.fixed(self.hash.data, 32)
        w.u64(self.round)
        _encode_votes(w, list(self.votes))

    @staticmethod
    def decode(r: Reader) -> "QC":
        return QC(Digest(r.fixed(32)), r.u64(), tuple(_decode_votes(r)))


@dataclass(frozen=True, slots=True)
class AggQC:
    """Constant-size quorum certificate: one aggregate signature over
    `_vote_digest(hash, round)` plus the bitmap of signing members."""

    hash: Digest
    round: Round
    bitmap: int
    agg_sig: bytes

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def encode(self, w: Writer) -> None:
        w.fixed(self.hash.data, 32)
        w.u64(self.round)
        _encode_bitmap(w, self.bitmap)
        w.var_bytes(self.agg_sig)

    @staticmethod
    def decode(r: Reader) -> "AggQC":
        return AggQC(Digest(r.fixed(32)), r.u64(), _decode_bitmap(r), r.var_bytes())
