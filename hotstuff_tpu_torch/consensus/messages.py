"""Consensus wire messages: Block, Vote, QC, Timeout, TC.

Capability parity with reference consensus/src/messages.rs:
  * Block{qc, tc?, author, round, payload: [Digest], signature}  (:22-76)
  * Vote{hash, round, author, signature}                         (:120-146)
  * QC{hash, round, votes: [(pk, sig)]} + quorum verify_batch    (:150-226)
  * Timeout{high_qc, round, author, signature}                   (:230-265)
  * TC{round, votes: [(pk, sig, high_qc_round)]}                 (:270-315)

Every signed artifact commits to a domain-separated SHA-512/32 digest of its
semantic content. A Vote signs the SAME digest a QC later verifies, so 2f+1
Vote signatures aggregate directly into a QC whose batch verification is the
device hot path (QC.verify -> Signature.verify_batch).

Aggregate certificate plane (§5.5o): AggQC/AggTC are the constant-size
forms — ONE aggregatable signature (crypto/aggsig seam) plus a fixed
64-byte committee bitmap instead of a per-author entry list, signing the
SAME `_vote_digest`/`_timeout_digest` preimages as the legacy forms, so
the cert FORM is a transport choice and never a new trust domain. Bit i
of a bitmap is member i of `_committee_at(committee, round).sorted_keys()`
— epoch-resolved, so a bitmap is meaningless outside its own round's
committee. Legacy entry-list forms still decode everywhere (mixed-fleet
interop); aggregate-carrying frames ride NEW envelope tags, which old
peers drop at `unknown consensus tag` — the same graceful-degradation
path Ping/Pong established.

The port's copy of `hotstuff_tpu/consensus/messages.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..crypto import Digest, PublicKey, SecretKey, Signature, aggsig, sha512_32
from ..utils.serde import Reader, SerdeError, Writer
from .config import Committee
from .errors import (
    AuthorityReuseError,
    InvalidSignatureError,
    QCRequiresQuorumError,
    TCRequiresQuorumError,
    UnknownAuthorityError,
    ensure,
)
from .reconfig import EpochChange

Round = int  # u64

# Upper bound on blocks per SyncRangeReply: bounds the serve-side store
# walk, the reply frame size, and what a receiver will decode from an
# unauthenticated peer (the blocks themselves are self-verifying).
MAX_RANGE_BATCH = 64


def _committee_at(committee, round_: Round) -> Committee:
    """Resolve the committee governing `round_`. Verification paths accept
    either a bare Committee (static, the pre-reconfig behaviour) or an
    epoch resolver (reconfig.EpochManager / EpochSchedule): with dynamic
    reconfiguration, a certificate's quorum is judged against the
    committee of the certificate's OWN epoch — a boundary block's
    embedded QC may belong to the epoch before the block's."""
    resolver = getattr(committee, "committee_for_round", None)
    return committee if resolver is None else resolver(round_)


def _vote_digest(hash_: Digest, round_: Round) -> Digest:
    """Digest signed by a Vote and verified by a QC (must coincide)."""
    return Digest(sha512_32(b"HSVOTE" + hash_.data + struct.pack("<Q", round_)))


def _timeout_digest(round_: Round, high_qc_round: Round) -> Digest:
    """Digest signed by a Timeout and verified by a TC (must coincide)."""
    return Digest(
        sha512_32(b"HSTMO" + struct.pack("<QQ", round_, high_qc_round))
    )


def _encode_votes(w: Writer, votes: list[tuple[PublicKey, Signature]]) -> None:
    w.seq(
        votes,
        lambda wr, v: (wr.fixed(v[0].data, 32), wr.fixed(v[1].data, 64)),
    )


def _decode_votes(r: Reader) -> list[tuple[PublicKey, Signature]]:
    return r.seq(lambda rd: (PublicKey(rd.fixed(32)), Signature(rd.fixed(64))))


@dataclass(frozen=True, slots=True)
class QC:
    """Quorum certificate: 2f+1 vote signatures over one block digest
    (consensus/src/messages.rs:150-226)."""

    hash: Digest
    round: Round
    votes: tuple[tuple[PublicKey, Signature], ...]

    @staticmethod
    def genesis() -> "QC":
        return QC(Digest.zero(), 0, ())

    def is_genesis(self) -> bool:
        """Full equality with QC.genesis(): a forged round-0 QC with a
        non-zero hash must NOT bypass verification (the reference compares
        against QC::genesis() exactly, consensus/src/messages.rs)."""
        return self == QC.genesis()

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def check_quorum(self, committee: Committee) -> None:
        """Structural checks only: authority uniqueness, known stake, 2f+1
        weight (messages.rs:180-196) — against the committee of THIS QC's
        round/epoch (`_committee_at`). Signature checks are separate so the
        async path can batch them through the verification service."""
        committee = _committee_at(committee, self.round)
        weight = 0
        used: set[PublicKey] = set()
        for name, _ in self.votes:
            ensure(name not in used, AuthorityReuseError(name))
            stake = committee.stake(name)
            ensure(stake > 0, UnknownAuthorityError(name))
            used.add(name)
            weight += stake
        ensure(weight >= committee.quorum_threshold(), QCRequiresQuorumError())

    def verify(self, committee: Committee) -> None:
        """Quorum + uniqueness checks, then BATCH signature verification --
        the per-block crypto hot spot (messages.rs:180-198). Raises on failure."""
        self.check_quorum(committee)
        ok = Signature.verify_batch(self.signed_digest(), list(self.votes))
        ensure(ok, InvalidSignatureError("QC batch verification failed"))

    def signed_items(self) -> tuple[list[bytes], list[tuple[PublicKey, Signature]]]:
        """(messages, (pk, sig)) triples for batched service verification."""
        d = self.signed_digest().data
        return [d] * len(self.votes), list(self.votes)

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        """verify() with the signature batch routed through the
        BatchVerificationService (off-loop, coalesced with other pending
        requests) instead of a synchronous backend call in the actor loop.
        Tagged `committee=True`: every vote is signed by a registered
        validator key, so the batch rides the committee-resident kernel
        (and dedup-cached votes skip the backend entirely). `trace` tags
        the service group with the block's trace id (utils/tracing.py)."""
        self.check_quorum(committee)
        msgs, pairs = self.signed_items()
        mask = await service.verify_group(
            msgs, pairs, urgent=True, committee=True, trace=trace,
            source="consensus"
        )
        ensure(all(mask), InvalidSignatureError("QC batch verification failed"))

    def encode(self, w: Writer) -> None:
        w.fixed(self.hash.data, 32)
        w.u64(self.round)
        _encode_votes(w, list(self.votes))

    @staticmethod
    def decode(r: Reader) -> "QC":
        return QC(Digest(r.fixed(32)), r.u64(), tuple(_decode_votes(r)))

    def __str__(self) -> str:
        return f"QC(B{self.round}({self.hash.short()}), {len(self.votes)} votes)"


@dataclass(frozen=True, slots=True)
class TC:
    """Timeout certificate: 2f+1 timeout signatures for one round; each vote
    carries the author's high_qc round (consensus/src/messages.rs:270-315)."""

    round: Round
    votes: tuple[tuple[PublicKey, Signature, Round], ...]

    def high_qc_rounds(self) -> list[Round]:
        return [r for _, _, r in self.votes]

    def check_quorum(self, committee: Committee) -> None:
        committee = _committee_at(committee, self.round)
        weight = 0
        used: set[PublicKey] = set()
        for name, _, _ in self.votes:
            ensure(name not in used, AuthorityReuseError(name))
            stake = committee.stake(name)
            ensure(stake > 0, UnknownAuthorityError(name))
            used.add(name)
            weight += stake
        ensure(weight >= committee.quorum_threshold(), TCRequiresQuorumError())

    def signed_items(self) -> tuple[list[bytes], list[tuple[PublicKey, Signature]]]:
        # Distinct messages (each binds its own high_qc_round): verify_batch_alt.
        msgs = [_timeout_digest(self.round, hr).data for _, _, hr in self.votes]
        pairs = [(pk, sig) for pk, sig, _ in self.votes]
        return msgs, pairs

    def verify(self, committee: Committee) -> None:
        self.check_quorum(committee)
        msgs, pairs = self.signed_items()
        ok = Signature.verify_batch_alt(msgs, pairs)
        ensure(ok, InvalidSignatureError("TC batch verification failed"))

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        self.check_quorum(committee)
        msgs, pairs = self.signed_items()
        mask = await service.verify_group(
            msgs, pairs, urgent=True, committee=True, trace=trace,
            source="consensus"
        )
        ensure(all(mask), InvalidSignatureError("TC batch verification failed"))

    def encode(self, w: Writer) -> None:
        w.u64(self.round)
        w.seq(
            list(self.votes),
            lambda wr, v: (
                wr.fixed(v[0].data, 32),
                wr.fixed(v[1].data, 64),
                wr.u64(v[2]),
            ),
        )

    @staticmethod
    def decode(r: Reader) -> "TC":
        round_ = r.u64()
        votes = r.seq(
            lambda rd: (PublicKey(rd.fixed(32)), Signature(rd.fixed(64)), rd.u64())
        )
        return TC(round_, tuple(votes))

    def __str__(self) -> str:
        return f"TC(round {self.round}, {len(self.votes)} votes)"


def _resolve_agg_keys(members: list[PublicKey]) -> list[bytes]:
    """Committee identity -> aggregate public key, via the aggsig
    registry (certificates carry no keys — that is the O(1) point). A
    member without a registered aggregate key fails verification: the
    registry is the proof-of-possession boundary."""
    pks: list[bytes] = []
    for member in members:
        agg_pk = aggsig.agg_key_of(member.data)
        ensure(
            agg_pk is not None,
            InvalidSignatureError(f"no aggregate key registered for {member}"),
        )
        pks.append(agg_pk)
    return pks


def _bitmap_members(bitmap: int, committee: Committee) -> list[PublicKey]:
    try:
        return aggsig.members_of(bitmap, committee.sorted_keys())
    except ValueError as exc:
        raise UnknownAuthorityError(f"aggregate bitmap: {exc}") from None


def _encode_bitmap(w: Writer, bitmap: int) -> None:
    w.fixed(aggsig.bitmap_to_bytes(bitmap), aggsig.AGG_BITMAP_BYTES)


def _decode_bitmap(r: Reader) -> int:
    return aggsig.bitmap_from_bytes(r.fixed(aggsig.AGG_BITMAP_BYTES))


@dataclass(frozen=True, slots=True)
class AggQC:
    """Constant-size quorum certificate: ONE aggregate signature over
    `_vote_digest(hash, round)` plus the bitmap of signing members.
    Duck-type-compatible with QC everywhere the core reads certificates
    (.hash/.round/.is_genesis()/check_quorum/verify) — genesis itself
    stays the legacy QC.genesis() sentinel."""

    hash: Digest
    round: Round
    bitmap: int
    agg_sig: bytes

    def is_genesis(self) -> bool:
        return False

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def signers(self) -> int:
        return self.bitmap.bit_count()

    def check_quorum(self, committee: Committee) -> None:
        """Structural checks: bitmap within the round's committee,
        2f+1 stake. Uniqueness is free — a bitmap cannot name a member
        twice."""
        committee = _committee_at(committee, self.round)
        members = _bitmap_members(self.bitmap, committee)
        weight = sum(committee.stake(m) for m in members)
        ensure(weight >= committee.quorum_threshold(), QCRequiresQuorumError())

    def verify(self, committee: Committee) -> None:
        self.check_quorum(committee)
        own = _committee_at(committee, self.round)
        pks = _resolve_agg_keys(_bitmap_members(self.bitmap, own))
        ok = aggsig.active_agg_scheme().verify(
            pks, self.signed_digest().data, self.agg_sig
        )
        ensure(ok, InvalidSignatureError("aggregate QC verification failed"))

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        """Aggregate verification is ONE combine-and-compare (stub) or
        one multi-pairing (exact) — there is no per-entry batch to
        coalesce, so it runs inline rather than through the
        verification service."""
        self.verify(committee)

    def encode(self, w: Writer) -> None:
        w.fixed(self.hash.data, 32)
        w.u64(self.round)
        _encode_bitmap(w, self.bitmap)
        w.var_bytes(self.agg_sig)

    @staticmethod
    def decode(r: Reader) -> "AggQC":
        return AggQC(
            Digest(r.fixed(32)), r.u64(), _decode_bitmap(r), r.var_bytes()
        )

    def __str__(self) -> str:
        return f"AggQC(B{self.round}({self.hash.short()}), {self.signers()} signers)"


@dataclass(frozen=True, slots=True)
class AggTC:
    """Constant-size timeout certificate: ONE aggregate signature
    spanning one signing GROUP per distinct high-qc round (members in
    group (hqr, bitmap) signed `_timeout_digest(round, hqr)`). Groups
    must be bitmap-disjoint; quorum is their combined stake. Group
    count is bounded by distinct hqr values among 2f+1 signers, so the
    certificate is O(#distinct hqrs) — in practice a handful — never
    O(n)."""

    round: Round
    groups: tuple[tuple[Round, int], ...]  # (high_qc_round, bitmap)
    agg_sig: bytes

    def high_qc_rounds(self) -> list[Round]:
        return [hqr for hqr, _ in self.groups]

    def signers(self) -> int:
        return sum(bm.bit_count() for _, bm in self.groups)

    def check_quorum(self, committee: Committee) -> None:
        committee = _committee_at(committee, self.round)
        weight = 0
        seen = 0
        for _, bm in self.groups:
            overlap = bm & seen
            if overlap:
                idx = (overlap & -overlap).bit_length() - 1
                raise AuthorityReuseError(committee.sorted_keys()[idx])
            seen |= bm
            weight += sum(
                committee.stake(m) for m in _bitmap_members(bm, committee)
            )
        ensure(weight >= committee.quorum_threshold(), TCRequiresQuorumError())

    def verify(self, committee: Committee) -> None:
        self.check_quorum(committee)
        own = _committee_at(committee, self.round)
        groups = [
            (
                _resolve_agg_keys(_bitmap_members(bm, own)),
                _timeout_digest(self.round, hqr).data,
            )
            for hqr, bm in self.groups
        ]
        ok = aggsig.active_agg_scheme().verify_groups(groups, self.agg_sig)
        ensure(ok, InvalidSignatureError("aggregate TC verification failed"))

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        self.verify(committee)

    def encode(self, w: Writer) -> None:
        w.u64(self.round)
        w.seq(
            list(self.groups),
            lambda wr, g: (wr.u64(g[0]), _encode_bitmap(wr, g[1])),
        )
        w.var_bytes(self.agg_sig)

    @staticmethod
    def decode(r: Reader) -> "AggTC":
        round_ = r.u64()
        groups = tuple(r.seq(lambda rd: (rd.u64(), _decode_bitmap(rd))))
        if len(groups) > aggsig.MAX_AGG_COMMITTEE:
            raise SerdeError(f"aggregate TC over group cap: {len(groups)}")
        return AggTC(round_, groups, r.var_bytes())

    def __str__(self) -> str:
        return (
            f"AggTC(round {self.round}, {len(self.groups)} groups, "
            f"{self.signers()} signers)"
        )


# Versioned certificate codec: aggregate-carrying containers (v2 blocks,
# stored blobs, agg timeout bundles) prefix each certificate with one
# version byte so either form round-trips.
def encode_any_qc(w: Writer, qc) -> None:
    if isinstance(qc, AggQC):
        w.u8(1)
    else:
        w.u8(0)
    qc.encode(w)


def decode_any_qc(r: Reader):
    return AggQC.decode(r) if r.u8() else QC.decode(r)


def encode_any_tc(w: Writer, tc) -> None:
    if isinstance(tc, AggTC):
        w.u8(1)
    else:
        w.u8(0)
    tc.encode(w)


def decode_any_tc(r: Reader):
    return AggTC.decode(r) if r.u8() else TC.decode(r)


@dataclass(frozen=True, slots=True)
class Block:
    """A proposal: orders payload DIGESTS only (32 B each); payload bytes are
    disseminated by the mempool plane (consensus/src/messages.rs:22-117).

    Certificates may be legacy (QC/TC) or aggregate (AggQC/AggTC) forms;
    the block DIGEST commits to (qc.hash, qc.round) only, so it is
    independent of the certificate form — certificates are self-verifying
    and the form is a transport choice (module docstring)."""

    qc: QC | AggQC
    tc: TC | AggTC | None
    author: PublicKey
    round: Round
    payload: tuple[Digest, ...]
    signature: Signature
    # Optional committee-succession payload (consensus/reconfig.py): the
    # block digest commits to it, and the new committee activates only
    # once THIS block is 2-chain committed (the epoch-commit rule). A
    # carrying block is an EPOCH-FINAL POSITION: honest nodes that
    # admitted it refuse to certify rounds at or past the declared
    # activation until the commit lands, so the old committee certifies
    # through the boundary minus one and the successor owns everything
    # after — no certificate in the committed chain can ever be judged
    # by the wrong epoch's committee (§5.5j).
    reconfig: EpochChange | None = None
    # digest cache: read on every vote/store/commit/sync touch
    _digest: Digest | None = field(
        default=None, init=False, repr=False, compare=False
    )

    @staticmethod
    def genesis() -> "Block":
        return Block(
            QC.genesis(),
            None,
            PublicKey(bytes(32)),
            0,
            (),
            Signature(bytes(64)),
        )

    def is_genesis(self) -> bool:
        return self.round == 0

    def digest(self) -> Digest:
        if self._digest is None:
            object.__setattr__(
                self,
                "_digest",
                Block.make_digest(
                    self.author, self.round, self.payload, self.qc, self.reconfig
                ),
            )
        return self._digest

    def parent(self) -> Digest:
        return self.qc.hash

    @staticmethod
    def make_digest(
        author: PublicKey,
        round_: Round,
        payload: list[Digest],
        qc: QC | AggQC,
        reconfig: EpochChange | None = None,
    ) -> Digest:
        # graftlint: allow[wire-schema] proofs/messages.py recomputes this SAME artifact (CommitProof.block_digest) by design — one preimage, two sites
        h = b"HSBLOCK" + author.data + struct.pack("<Q", round_)
        for d in payload:
            h += d.data
        h += qc.hash.data + struct.pack("<Q", qc.round)
        if reconfig is not None:
            # Committed-to ONLY when present: reconfig-free blocks keep the
            # historical preimage byte-for-byte, and a relay can neither
            # strip nor alter a carried change without breaking the
            # author's signature over this digest.
            h += b"HSEPOCH" + reconfig.digest().data
        return Digest(sha512_32(h))

    @staticmethod
    def new_from_key(
        qc: QC,
        tc: TC | None,
        author: PublicKey,
        round_: Round,
        payload: list[Digest],
        secret: SecretKey,
        reconfig: EpochChange | None = None,
    ) -> "Block":
        """Sync constructor bypassing the SignatureService, as the reference
        test fixtures do (consensus/src/tests/common.rs:44-61)."""
        digest = Block.make_digest(author, round_, payload, qc, reconfig)
        return Block(
            qc, tc, author, round_, tuple(payload),
            Signature.new(digest, secret), reconfig,
        )

    def verify(self, committee: Committee) -> None:
        """Ingress checks (consensus/src/messages.rs:55-76): known author with
        stake, author signature, embedded QC, embedded TC, carried epoch
        change. Author stake resolves against the committee of THIS
        block's round; the certificates resolve against their own rounds
        inside their check_quorum."""
        own = _committee_at(committee, self.round)
        ensure(own.stake(self.author) > 0, UnknownAuthorityError(self.author))
        ok = self.signature.verify(self.digest(), self.author)
        ensure(ok, InvalidSignatureError(f"bad block signature B{self.round}"))
        if not self.qc.is_genesis():
            self.qc.verify(committee)
        if self.tc is not None:
            self.tc.verify(committee)
        if self.reconfig is not None:
            ensure(
                own.stake(self.reconfig.author) > 0,
                UnknownAuthorityError(self.reconfig.author),
            )
            ok = self.reconfig.signature.verify(
                self.reconfig.digest(), self.reconfig.author
            )
            ensure(
                ok, InvalidSignatureError(f"bad epoch-change signature B{self.round}")
            )

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        """verify() with ALL signature checks (author + embedded QC + embedded
        TC + carried epoch change) submitted as ONE group to the
        BatchVerificationService: a single coalesced backend dispatch per
        block instead of synchronous calls in the consensus actor loop."""
        own = _committee_at(committee, self.round)
        ensure(own.stake(self.author) > 0, UnknownAuthorityError(self.author))
        msgs: list[bytes] = [self.digest().data]
        pairs: list[tuple[PublicKey, Signature]] = [(self.author, self.signature)]
        qc_lo = qc_hi = tc_lo = tc_hi = len(msgs)
        if isinstance(self.qc, AggQC):
            # One combine-and-compare (or one multi-pairing): no entry
            # batch to coalesce through the service — verified inline.
            self.qc.verify(committee)
        elif not self.qc.is_genesis():
            self.qc.check_quorum(committee)
            m, p = self.qc.signed_items()
            qc_lo, qc_hi = len(msgs), len(msgs) + len(m)
            msgs += m
            pairs += p
        if isinstance(self.tc, AggTC):
            self.tc.verify(committee)
        elif self.tc is not None:
            self.tc.check_quorum(committee)
            m, p = self.tc.signed_items()
            tc_lo, tc_hi = len(msgs), len(msgs) + len(m)
            msgs += m
            pairs += p
        ec_lo = len(msgs)
        if self.reconfig is not None:
            # The change must be signed by a CURRENT (block-round) epoch
            # authority; the successor committee governs nothing until the
            # carrying block commits and the activation round arrives.
            ensure(
                own.stake(self.reconfig.author) > 0,
                UnknownAuthorityError(self.reconfig.author),
            )
            msgs.append(self.reconfig.digest().data)
            pairs.append((self.reconfig.author, self.reconfig.signature))
        mask = await service.verify_group(
            msgs, pairs, urgent=True, committee=True, trace=trace,
            source="consensus"
        )
        ensure(mask[0], InvalidSignatureError(f"bad block signature B{self.round}"))
        ensure(
            all(mask[qc_lo:qc_hi]),
            InvalidSignatureError("QC batch verification failed"),
        )
        ensure(
            all(mask[tc_lo:tc_hi]),
            InvalidSignatureError("TC batch verification failed"),
        )
        ensure(
            all(mask[ec_lo:]),
            InvalidSignatureError(f"bad epoch-change signature B{self.round}"),
        )

    def has_agg_certs(self) -> bool:
        return isinstance(self.qc, AggQC) or isinstance(self.tc, AggTC)

    def encode(self, w: Writer) -> None:
        """LEGACY wire layout — byte-identical to every committed
        artifact. Blocks carrying aggregate certificates must use
        encode_v2 (the envelope and store helpers route on
        has_agg_certs)."""
        if self.has_agg_certs():
            raise TypeError(
                "aggregate-certificate block needs the v2 encoding"
            )
        self.qc.encode(w)
        if self.tc is None:
            w.u8(0)
        else:
            w.u8(1)
            self.tc.encode(w)
        w.fixed(self.author.data, 32)
        w.u64(self.round)
        w.seq(list(self.payload), lambda wr, d: wr.fixed(d.data, 32))
        w.fixed(self.signature.data, 64)
        if self.reconfig is None:
            w.u8(0)
        else:
            w.u8(1)
            self.reconfig.encode(w)

    @staticmethod
    def decode(r: Reader) -> "Block":
        qc = QC.decode(r)
        tc = TC.decode(r) if r.u8() else None
        author = PublicKey(r.fixed(32))
        round_ = r.u64()
        payload = tuple(r.seq(lambda rd: Digest(rd.fixed(32))))
        sig = Signature(r.fixed(64))
        reconfig = EpochChange.decode(r) if r.u8() else None
        return Block(qc, tc, author, round_, payload, sig, reconfig)

    def encode_v2(self, w: Writer) -> None:
        """Same field order as the legacy layout with each certificate
        behind a one-byte version prefix (encode_any_qc/tc) — the form
        aggregate-carrying frames and store blobs use."""
        encode_any_qc(w, self.qc)
        if self.tc is None:
            w.u8(0)
        else:
            w.u8(1)
            encode_any_tc(w, self.tc)
        w.fixed(self.author.data, 32)
        w.u64(self.round)
        w.seq(list(self.payload), lambda wr, d: wr.fixed(d.data, 32))
        w.fixed(self.signature.data, 64)
        if self.reconfig is None:
            w.u8(0)
        else:
            w.u8(1)
            self.reconfig.encode(w)

    @staticmethod
    def decode_v2(r: Reader) -> "Block":
        qc = decode_any_qc(r)
        tc = decode_any_tc(r) if r.u8() else None
        author = PublicKey(r.fixed(32))
        round_ = r.u64()
        payload = tuple(r.seq(lambda rd: Digest(rd.fixed(32))))
        sig = Signature(r.fixed(64))
        reconfig = EpochChange.decode(r) if r.u8() else None
        return Block(qc, tc, author, round_, payload, sig, reconfig)

    def size(self) -> int:
        w = Writer()
        if self.has_agg_certs():
            self.encode_v2(w)
        else:
            self.encode(w)
        return len(w.bytes())

    def certificate_bytes(self) -> int:
        """Encoded size of the certificates this block carries (QC plus
        TC if any) — the quantity the `bytes_per_committed_round` matrix
        column accounts per commit. Uses each certificate's own wire
        encoding, so legacy forms report O(96·quorum) and aggregate
        forms report a committee-size-independent constant."""
        w = Writer()
        self.qc.encode(w)
        if self.tc is not None:
            self.tc.encode(w)
        return len(w.bytes())

    def __str__(self) -> str:
        return f"B{self.round}({self.digest().short()})"


def _encode_any_block(w: Writer, block: Block) -> None:
    if block.has_agg_certs():
        w.u8(1)
        block.encode_v2(w)
    else:
        w.u8(0)
        block.encode(w)


def _decode_any_block(r: Reader) -> Block:
    return Block.decode_v2(r) if r.u8() else Block.decode(r)


def encode_stored_block(block: Block) -> bytes:
    """Store-blob form: one version byte then the matching block layout.
    Every store read/write goes through this pair so a store can hold
    legacy and aggregate-certificate blocks side by side (stores are
    per-run; no cross-version migration concern)."""
    w = Writer()
    _encode_any_block(w, block)
    return w.bytes()


def decode_stored_block(data: bytes) -> Block:
    r = Reader(data)
    block = _decode_any_block(r)
    r.expect_done()
    return block


@dataclass(frozen=True, slots=True)
class Vote:
    """A vote on a block, sent to the NEXT leader
    (consensus/src/messages.rs:120-146)."""

    hash: Digest
    round: Round
    author: PublicKey
    signature: Signature

    @staticmethod
    def new_from_key(
        hash_: Digest, round_: Round, author: PublicKey, secret: SecretKey
    ) -> "Vote":
        return Vote(hash_, round_, author, Signature.new(_vote_digest(hash_, round_), secret))

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def verify(self, committee: Committee) -> None:
        committee = _committee_at(committee, self.round)
        ensure(committee.stake(self.author) > 0, UnknownAuthorityError(self.author))
        ok = self.signature.verify(self.signed_digest(), self.author)
        ensure(ok, InvalidSignatureError(f"bad vote signature V{self.round}"))

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        committee = _committee_at(committee, self.round)
        ensure(committee.stake(self.author) > 0, UnknownAuthorityError(self.author))
        ok = await service.verify(
            self.signed_digest().data, self.author, self.signature,
            committee=True, trace=trace,
        )
        ensure(ok, InvalidSignatureError(f"bad vote signature V{self.round}"))

    def encode(self, w: Writer) -> None:
        w.fixed(self.hash.data, 32)
        w.u64(self.round)
        w.fixed(self.author.data, 32)
        w.fixed(self.signature.data, 64)

    @staticmethod
    def decode(r: Reader) -> "Vote":
        return Vote(
            Digest(r.fixed(32)), r.u64(), PublicKey(r.fixed(32)), Signature(r.fixed(64))
        )

    def __str__(self) -> str:
        return f"V{self.round}({self.hash.short()})"


@dataclass(frozen=True, slots=True)
class Timeout:
    """Signed claim that a round timed out, carrying the author's highest QC
    (consensus/src/messages.rs:230-265)."""

    high_qc: QC
    round: Round
    author: PublicKey
    signature: Signature

    @staticmethod
    def new_from_key(
        high_qc: QC, round_: Round, author: PublicKey, secret: SecretKey
    ) -> "Timeout":
        digest = _timeout_digest(round_, high_qc.round)
        return Timeout(high_qc, round_, author, Signature.new(digest, secret))

    def signed_digest(self) -> Digest:
        return _timeout_digest(self.round, self.high_qc.round)

    def verify(self, committee: Committee) -> None:
        own = _committee_at(committee, self.round)
        ensure(own.stake(self.author) > 0, UnknownAuthorityError(self.author))
        ok = self.signature.verify(self.signed_digest(), self.author)
        ensure(ok, InvalidSignatureError(f"bad timeout signature T{self.round}"))
        if not self.high_qc.is_genesis():
            self.high_qc.verify(committee)

    async def verify_async(
        self, committee: Committee, service, trace: str | None = None
    ) -> None:
        """Timeout signature + embedded high_qc votes as one service group."""
        own = _committee_at(committee, self.round)
        ensure(own.stake(self.author) > 0, UnknownAuthorityError(self.author))
        msgs: list[bytes] = [self.signed_digest().data]
        pairs: list[tuple[PublicKey, Signature]] = [(self.author, self.signature)]
        if not self.high_qc.is_genesis():
            self.high_qc.check_quorum(committee)
            m, p = self.high_qc.signed_items()
            msgs += m
            pairs += p
        mask = await service.verify_group(
            msgs, pairs, urgent=True, committee=True, trace=trace,
            source="consensus"
        )
        ensure(mask[0], InvalidSignatureError(f"bad timeout signature T{self.round}"))
        ensure(
            all(mask[1:]),
            InvalidSignatureError("QC batch verification failed"),
        )

    def encode(self, w: Writer) -> None:
        self.high_qc.encode(w)
        w.u64(self.round)
        w.fixed(self.author.data, 32)
        w.fixed(self.signature.data, 64)

    @staticmethod
    def decode(r: Reader) -> "Timeout":
        return Timeout(
            QC.decode(r), r.u64(), PublicKey(r.fixed(32)), Signature(r.fixed(64))
        )

    def __str__(self) -> str:
        return f"T{self.round}(high_qc round {self.high_qc.round})"


# ---------------------------------------------------------------------------
# Wire envelope (the reference's ConsensusMessage enum, consensus/src/core.rs).

TAG_PROPOSE = 0
TAG_VOTE = 1
TAG_TIMEOUT = 2
TAG_TC = 3
TAG_SYNC_REQUEST = 4
TAG_SYNC_RANGE_REQUEST = 5
TAG_SYNC_RANGE_REPLY = 6
# Aggregation-overlay partial-quorum bundles (consensus/overlay.py).
TAG_VOTE_BUNDLE = 7
TAG_TIMEOUT_BUNDLE = 8
# Network-observatory RTT probes (network/net.py peer ledger). Probe
# frames ride the normal consensus framing, so a peer that predates them
# hits `unknown consensus tag` in decode, counts one net.decode_errors,
# and drops the frame — the graceful-degradation path for mixed fleets.
TAG_PING = 9
TAG_PONG = 10
# Aggregate certificate plane (§5.5o): only frames that actually carry
# an aggregate form use these tags — a mixed fleet keeps full interop on
# the legacy tags, and aggregate frames degrade at old peers exactly
# like Ping/Pong (unknown tag, one decode_errors count, frame dropped).
TAG_PROPOSE_V2 = 11
TAG_AGG_VOTE_BUNDLE = 12
TAG_AGG_TIMEOUT_BUNDLE = 13
TAG_AGG_TC = 14
TAG_SYNC_RANGE_REPLY_V2 = 15

# Defensive cap on entries per partial bundle: an unauthenticated peer
# must not make a receiver decode (and batch-verify) an unbounded entry
# list per frame. Real bundles carry at most one committee's worth.
MAX_BUNDLE_ENTRIES = 4096


def encode_consensus_message(msg) -> bytes:
    w = Writer()
    if isinstance(msg, Block):
        if msg.has_agg_certs():
            w.u8(TAG_PROPOSE_V2)
            msg.encode_v2(w)
        else:
            w.u8(TAG_PROPOSE)
            msg.encode(w)
    elif isinstance(msg, Vote):
        w.u8(TAG_VOTE)
        msg.encode(w)
    elif isinstance(msg, Timeout):
        w.u8(TAG_TIMEOUT)
        msg.encode(w)
    elif isinstance(msg, TC):
        w.u8(TAG_TC)
        msg.encode(w)
    elif isinstance(msg, AggTC):
        w.u8(TAG_AGG_TC)
        msg.encode(w)
    elif isinstance(msg, SyncRequest):
        w.u8(TAG_SYNC_REQUEST)
        w.fixed(msg.digest.data, 32)
        w.fixed(msg.requester.data, 32)
    elif isinstance(msg, SyncRangeRequest):
        w.u8(TAG_SYNC_RANGE_REQUEST)
        w.fixed(msg.target.data, 32)
        w.u64(msg.from_round)
        w.fixed(msg.requester.data, 32)
    elif isinstance(msg, SyncRangeReply):
        if len(msg.blocks) > MAX_RANGE_BATCH:
            raise ValueError(f"range reply over batch cap: {len(msg.blocks)}")
        if any(b.has_agg_certs() for b in msg.blocks):
            w.u8(TAG_SYNC_RANGE_REPLY_V2)
            w.fixed(msg.target.data, 32)
            w.seq(list(msg.blocks), _encode_any_block)
        else:
            w.u8(TAG_SYNC_RANGE_REPLY)
            w.fixed(msg.target.data, 32)
            w.seq(list(msg.blocks), lambda wr, b: b.encode(wr))
    elif isinstance(msg, VoteBundle):
        if len(msg.votes) > MAX_BUNDLE_ENTRIES:
            raise ValueError(f"vote bundle over entry cap: {len(msg.votes)}")
        w.u8(TAG_VOTE_BUNDLE)
        w.u64(msg.round)
        w.fixed(msg.hash.data, 32)
        _encode_votes(w, list(msg.votes))
    elif isinstance(msg, TimeoutBundle):
        if len(msg.timeouts) > MAX_BUNDLE_ENTRIES:
            raise ValueError(
                f"timeout bundle over entry cap: {len(msg.timeouts)}"
            )
        w.u8(TAG_TIMEOUT_BUNDLE)
        w.u64(msg.round)
        msg.high_qc.encode(w)
        w.seq(
            list(msg.timeouts),
            lambda wr, v: (
                wr.fixed(v[0].data, 32),
                wr.fixed(v[1].data, 64),
                wr.u64(v[2]),
            ),
        )
    elif isinstance(msg, AggVoteBundle):
        w.u8(TAG_AGG_VOTE_BUNDLE)
        w.u64(msg.round)
        w.fixed(msg.hash.data, 32)
        _encode_bitmap(w, msg.bitmap)
        w.var_bytes(msg.agg_sig)
        w.u8(min(msg.depth, 255))
    elif isinstance(msg, AggTimeoutBundle):
        w.u8(TAG_AGG_TIMEOUT_BUNDLE)
        w.u64(msg.round)
        encode_any_qc(w, msg.high_qc)
        w.seq(
            list(msg.groups),
            lambda wr, g: (wr.u64(g[0]), _encode_bitmap(wr, g[1])),
        )
        w.var_bytes(msg.agg_sig)
        w.u8(min(msg.depth, 255))
    elif isinstance(msg, Ping):
        w.u8(TAG_PING)
        w.fixed(msg.origin.data, 32)
        w.u64(msg.seq)
        w.u64(msg.sent_at_us)
    elif isinstance(msg, Pong):
        w.u8(TAG_PONG)
        w.fixed(msg.origin.data, 32)
        w.fixed(msg.responder.data, 32)
        w.u64(msg.seq)
        w.u64(msg.sent_at_us)
    else:
        raise TypeError(f"not a consensus message: {msg!r}")
    return w.bytes()


def decode_consensus_message(data: bytes):
    r = Reader(data)
    tag = r.u8()
    if tag == TAG_PROPOSE:
        out = Block.decode(r)
    elif tag == TAG_VOTE:
        out = Vote.decode(r)
    elif tag == TAG_TIMEOUT:
        out = Timeout.decode(r)
    elif tag == TAG_TC:
        out = TC.decode(r)
    elif tag == TAG_SYNC_REQUEST:
        out = SyncRequest(Digest(r.fixed(32)), PublicKey(r.fixed(32)))
    elif tag == TAG_SYNC_RANGE_REQUEST:
        out = SyncRangeRequest(
            Digest(r.fixed(32)), r.u64(), PublicKey(r.fixed(32))
        )
    elif tag == TAG_SYNC_RANGE_REPLY:
        target = Digest(r.fixed(32))
        blocks = tuple(r.seq(Block.decode))
        if len(blocks) > MAX_RANGE_BATCH:
            # Defensive cap BEFORE anything downstream trusts the batch:
            # an unauthenticated peer must not make us buffer an
            # arbitrarily long chain segment per frame.
            raise SerdeError(f"range reply over batch cap: {len(blocks)}")
        out = SyncRangeReply(target, blocks)
    elif tag == TAG_VOTE_BUNDLE:
        round_ = r.u64()
        hash_ = Digest(r.fixed(32))
        votes = tuple(_decode_votes(r))
        if len(votes) > MAX_BUNDLE_ENTRIES:
            raise SerdeError(f"vote bundle over entry cap: {len(votes)}")
        out = VoteBundle(round_, hash_, votes)
    elif tag == TAG_TIMEOUT_BUNDLE:
        round_ = r.u64()
        high_qc = QC.decode(r)
        timeouts = tuple(
            r.seq(
                lambda rd: (
                    PublicKey(rd.fixed(32)),
                    Signature(rd.fixed(64)),
                    rd.u64(),
                )
            )
        )
        if len(timeouts) > MAX_BUNDLE_ENTRIES:
            raise SerdeError(f"timeout bundle over entry cap: {len(timeouts)}")
        out = TimeoutBundle(round_, high_qc, timeouts)
    elif tag == TAG_PROPOSE_V2:
        out = Block.decode_v2(r)
    elif tag == TAG_AGG_TC:
        out = AggTC.decode(r)
    elif tag == TAG_SYNC_RANGE_REPLY_V2:
        target = Digest(r.fixed(32))
        blocks = tuple(r.seq(_decode_any_block))
        if len(blocks) > MAX_RANGE_BATCH:
            raise SerdeError(f"range reply over batch cap: {len(blocks)}")
        out = SyncRangeReply(target, blocks)
    elif tag == TAG_AGG_VOTE_BUNDLE:
        out = AggVoteBundle(
            r.u64(), Digest(r.fixed(32)), _decode_bitmap(r),
            r.var_bytes(), r.u8(),
        )
    elif tag == TAG_AGG_TIMEOUT_BUNDLE:
        round_ = r.u64()
        high_qc = decode_any_qc(r)
        groups = tuple(r.seq(lambda rd: (rd.u64(), _decode_bitmap(rd))))
        if len(groups) > aggsig.MAX_AGG_COMMITTEE:
            raise SerdeError(
                f"aggregate timeout bundle over group cap: {len(groups)}"
            )
        out = AggTimeoutBundle(round_, high_qc, groups, r.var_bytes(), r.u8())
    elif tag == TAG_PING:
        out = Ping(PublicKey(r.fixed(32)), r.u64(), r.u64())
    elif tag == TAG_PONG:
        out = Pong(
            PublicKey(r.fixed(32)), PublicKey(r.fixed(32)), r.u64(), r.u64()
        )
    else:
        raise SerdeError(f"unknown consensus tag {tag}")
    r.expect_done()
    return out


@dataclass(frozen=True, slots=True)
class SyncRequest:
    """Ask peers to re-send a missing block (consensus/src/core.rs:418-436)."""

    digest: Digest
    requester: PublicKey


@dataclass(frozen=True, slots=True)
class SyncRangeRequest:
    """Batched catch-up fetch: ask for the ancestor chain of `target`
    down to (exclusive) `from_round` — the requester's committed round,
    below which the chains must coincide. The serving peer walks its
    store back from `target` and answers with ONE SyncRangeReply of up
    to MAX_RANGE_BATCH blocks, OLDEST first, so the receiver can verify
    and commit progressively (each block's parent precedes it)."""

    target: Digest
    from_round: Round
    requester: PublicKey


@dataclass(frozen=True, slots=True)
class SyncRangeReply:
    """Ancestor batch for a SyncRangeRequest (oldest-first, capped).
    Unauthenticated as a message — each carried block is independently
    verified through the normal proposal path, with QC quorums judged
    against the committee of the QC's own epoch."""

    target: Digest
    blocks: tuple[Block, ...]


@dataclass(frozen=True, slots=True)
class VoteBundle:
    """Aggregation-overlay partial quorum for one (round, block digest):
    a mergeable set of individually signed votes (consensus/overlay.py).
    Unauthenticated as a CONTAINER — each (author, signature) entry is
    batch-verified against `_vote_digest(hash, round)` by the receiver
    before it merges, and an invalid entry is dropped alone (it cannot
    poison the rest of the bundle)."""

    round: Round
    hash: Digest
    votes: tuple[tuple[PublicKey, Signature], ...]

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def __str__(self) -> str:
        return f"VB{self.round}({self.hash.short()}, {len(self.votes)} votes)"


@dataclass(frozen=True, slots=True)
class TimeoutBundle:
    """Aggregation-overlay partial quorum for one timed-out round: a
    mergeable set of (author, signature, high_qc_round) timeout entries
    plus the highest QC any merged author reported (ONE certificate per
    bundle instead of one per timeout — the storm-shrinking payload).
    Entries verify individually against `_timeout_digest(round, hqr)`;
    the carried high_qc is quorum-checked and batch-verified before
    adoption, exactly like a Timeout's."""

    round: Round
    high_qc: QC
    timeouts: tuple[tuple[PublicKey, Signature, Round], ...]

    def __str__(self) -> str:
        return (
            f"TB{self.round}(high_qc round {self.high_qc.round}, "
            f"{len(self.timeouts)} timeouts)"
        )


@dataclass(frozen=True, slots=True)
class AggVoteBundle:
    """Handel-style PARTIAL aggregate for one (round, block digest): an
    aggregate signature over `_vote_digest(hash, round)` covering the
    bitmap's members. A single node's vote is the singleton-bitmap case;
    interior overlay nodes merge bitmap-DISJOINT partials by one
    combine() plus a bitmap OR — gossip carries aggregates, never entry
    lists. Verification is ATOMIC: the partial verifies as a whole or is
    dropped as a whole (there is no per-entry salvage in an aggregate —
    Handel's atomic-partial rule), so a forged member poisons only the
    partial it rides in, and only until the sender's next window.
    `depth` is telemetry-only (merge-tree height for the CERTS scrape):
    it never participates in verification."""

    round: Round
    hash: Digest
    bitmap: int
    agg_sig: bytes
    depth: int = 0

    def signed_digest(self) -> Digest:
        return _vote_digest(self.hash, self.round)

    def signers(self) -> int:
        return self.bitmap.bit_count()

    def __str__(self) -> str:
        return (
            f"AVB{self.round}({self.hash.short()}, {self.signers()} signers, "
            f"depth {self.depth})"
        )


@dataclass(frozen=True, slots=True)
class AggTimeoutBundle:
    """Handel-style partial aggregate for one timed-out round: one
    aggregate signature spanning `groups` (one (high_qc_round, bitmap)
    group per distinct claimed hqr, AggTC-shaped), plus the highest QC
    the contributing members could back their claims with. Atomicity
    replaces the legacy `filter_backed` per-entry salvage: a bundle
    whose max claimed hqr exceeds its carried certificate's round is
    rejected WHOLE (an honest sender never produces one), so the
    TC-poisoning guard holds without per-entry signatures to fall back
    on."""

    round: Round
    high_qc: QC | AggQC
    groups: tuple[tuple[Round, int], ...]
    agg_sig: bytes
    depth: int = 0

    def signers(self) -> int:
        return sum(bm.bit_count() for _, bm in self.groups)

    def __str__(self) -> str:
        return (
            f"ATB{self.round}(high_qc round {self.high_qc.round}, "
            f"{len(self.groups)} groups, {self.signers()} signers)"
        )


@dataclass(frozen=True, slots=True)
class Ping:
    """RTT probe (network observatory): `origin` broadcasts one Ping per
    probe interval; every receiver answers a Pong directly to the origin.
    Timestamps are MICROSECONDS of the ORIGIN's loop clock (`loop.time()`
    — the virtual clock under chaos, so measured RTTs replay
    bit-identically); the responder echoes them opaquely, never
    interprets them. Unsigned by design: a probe carries no protocol
    authority, and a forged one costs its victim exactly one reply
    frame. The origin key is carried in-frame because the receive path
    does not authenticate frame senders."""

    origin: PublicKey
    seq: int
    sent_at_us: int

    def __str__(self) -> str:
        return f"Ping(seq {self.seq})"


@dataclass(frozen=True, slots=True)
class Pong:
    """Echo of a Ping, addressed back to its origin. `responder`
    identifies the measured peer; `sent_at_us` is the origin's own
    send stamp echoed back, so RTT = now - sent_at_us needs no clock
    agreement between the two nodes."""

    origin: PublicKey
    responder: PublicKey
    seq: int
    sent_at_us: int

    def __str__(self) -> str:
        return f"Pong(seq {self.seq})"


@dataclass(frozen=True, slots=True)
class LoopBack:
    """Internal-only: re-inject a block whose dependencies arrived
    (consensus/src/synchronizer.rs:68-76). Never serialized."""

    block: Block
