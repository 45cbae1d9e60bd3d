"""Vote/timeout aggregation into QCs/TCs (reference consensus/src/aggregator.rs).

QCMaker/TCMaker accumulate stake-weighted signatures, reject duplicate
authors, and fire EXACTLY ONCE when the quorum threshold is reached
(aggregator.rs:74-94,113-138). The Aggregator keys makers per (round, digest)
and drops state for old rounds on cleanup (aggregator.rs:52-70).

This accumulate-then-batch-verify structure is precisely the seam the card
backend exploits: a full QC's signatures are verified as one batch.

The port's copy of `hotstuff_tpu/consensus/aggregator.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import time

from ..crypto import Digest, PublicKey, Signature, aggsig
from ..utils import metrics, tracing
from .config import Committee
from .errors import UnknownAuthorityError, ensure
from .messages import (
    QC,
    TC,
    AggQC,
    AggTC,
    AggVoteBundle,
    Round,
    Timeout,
    Vote,
    _timeout_digest,
    _vote_digest,
)
from .reconfig import as_manager

# qc_form_s / tc_form_s: first vote (or timeout) appended -> quorum fired —
# the vote->QC leg of the proposal->vote->QC->commit latency chain.
_M_QCS = metrics.counter("consensus.qcs")
_M_TCS = metrics.counter("consensus.tcs")
_M_QC_FORM = metrics.histogram("consensus.qc_form_s")
_M_TC_FORM = metrics.histogram("consensus.tc_form_s")
# Aggregate certificate plane: certificates formed from Handel partial
# sets, and partial merges performed while packing them.
_M_AGG_QCS = metrics.counter("agg.qcs_formed")
_M_AGG_TCS = metrics.counter("agg.tcs_formed")
_M_AGG_MERGES = metrics.counter("agg.partials_merged")


class QCMaker:
    """Accumulates votes for one (block digest, round) into a QC."""

    def __init__(self) -> None:
        self.weight = 0
        self.votes: list[tuple[PublicKey, Signature]] = []
        self.used: set[PublicKey] = set()
        self._first_at: float | None = None

    def append(self, vote: Vote, committee: Committee) -> QC | None:
        return self.add(
            vote.author, vote.signature, vote.round, vote.hash, committee
        )

    def add(
        self,
        author: PublicKey,
        signature: Signature,
        round_: Round,
        hash_: Digest,
        committee: Committee,
    ) -> QC | None:
        """Entry-level accumulation: the shape partial bundles arrive in
        (consensus/overlay.py) — a Vote is just one entry."""
        if author in self.used:
            return None  # redelivery (retries rebroadcast); not Byzantine
        stake = committee.stake(author)
        ensure(stake > 0, UnknownAuthorityError(author))
        if self._first_at is None:
            self._first_at = time.perf_counter()
        self.used.add(author)
        self.votes.append((author, signature))
        self.weight += stake
        if self.weight >= committee.quorum_threshold():
            self.weight = 0  # fire exactly once (aggregator.rs:88)
            _M_QCS.inc()
            form_s = time.perf_counter() - self._first_at
            _M_QC_FORM.record(form_s)
            if tracing.enabled():
                tracing.event(
                    "qc",
                    tracing.trace_id(round_, hash_.data),
                    form_s,
                    votes=len(self.votes),
                )
            return QC(hash_, round_, tuple(self.votes))
        return None


class TCMaker:
    """Accumulates timeouts for one round into a TC."""

    def __init__(self) -> None:
        self.weight = 0
        self.votes: list[tuple[PublicKey, Signature, Round]] = []
        self.used: set[PublicKey] = set()
        self._first_at: float | None = None

    def append(self, timeout: Timeout, committee: Committee) -> TC | None:
        return self.add(
            timeout.author,
            timeout.signature,
            timeout.high_qc.round,
            timeout.round,
            committee,
        )

    def add(
        self,
        author: PublicKey,
        signature: Signature,
        high_qc_round: Round,
        round_: Round,
        committee: Committee,
    ) -> TC | None:
        """Entry-level accumulation for partial timeout bundles: only the
        (author, signature, high_qc_round) triple is needed to weigh and
        assemble the TC — the full high_qc rides the bundle once, not
        once per author (consensus/overlay.py)."""
        if author in self.used:
            return None  # redelivery (nodes re-timeout the same round)
        stake = committee.stake(author)
        ensure(stake > 0, UnknownAuthorityError(author))
        if self._first_at is None:
            self._first_at = time.perf_counter()
        self.used.add(author)
        self.votes.append((author, signature, high_qc_round))
        self.weight += stake
        if self.weight >= committee.quorum_threshold():
            self.weight = 0
            _M_TCS.inc()
            _M_TC_FORM.record(time.perf_counter() - self._first_at)
            return TC(round_, tuple(self.votes))
        return None


class Aggregator:
    def __init__(self, committee: Committee, verification_service=None) -> None:
        # Committee or reconfig.EpochManager: stake weights and quorum
        # thresholds resolve against the committee of the VOTE's round, so
        # a QC forming across an epoch boundary counts the right epoch's
        # validators on each side.
        self.epochs = as_manager(committee)
        self.votes_aggregators: dict[tuple[Round, Digest], QCMaker] = {}
        self.timeouts_aggregators: dict[Round, TCMaker] = {}
        # Votes/timeouts reaching the aggregator were already verified by
        # the core; seeding their triples into the service's dedup cache
        # means the QC/TC assembled from them re-verifies ZERO signatures
        # (each signature is otherwise checked 2-3x over its lifetime).
        self.verification_service = verification_service

    @property
    def committee(self) -> Committee:
        return self.epochs.current()

    def _seed(self, digest: Digest, author: PublicKey, sig: Signature) -> None:
        svc = self.verification_service
        if svc is not None and hasattr(svc, "seed_verified"):
            svc.seed_verified(digest.data, author, sig)

    def add_vote(self, vote: Vote) -> QC | None:
        """May raise ConsensusError on Byzantine input (duplicate author).
        Parity note: like the reference (its aggregator.rs:29-30 TODO), a
        bad node could grow this map; cleanup() bounds it per round
        advance."""
        key = (vote.round, vote.hash)
        maker = self.votes_aggregators.setdefault(key, QCMaker())
        qc = maker.append(vote, self.epochs.committee_for_round(vote.round))
        self._seed(vote.signed_digest(), vote.author, vote.signature)
        return qc

    def add_timeout(self, timeout: Timeout) -> TC | None:
        maker = self.timeouts_aggregators.setdefault(timeout.round, TCMaker())
        tc = maker.append(timeout, self.epochs.committee_for_round(timeout.round))
        self._seed(
            timeout.signed_digest(), timeout.author, timeout.signature
        )
        return tc

    # -- partial-bundle entries (consensus/overlay.py) -----------------------

    def add_vote_entry(
        self, round_: Round, hash_: Digest, author: PublicKey, sig: Signature
    ) -> QC | None:
        """One verified vote entry from a partial bundle: same maker (and
        exactly-once quorum firing) as a full Vote for the same key."""
        maker = self.votes_aggregators.setdefault((round_, hash_), QCMaker())
        qc = maker.add(
            author, sig, round_, hash_, self.epochs.committee_for_round(round_)
        )
        self._seed(_vote_digest(hash_, round_), author, sig)
        return qc

    def add_timeout_entry(
        self, round_: Round, author: PublicKey, sig: Signature, high_qc_round: Round
    ) -> TC | None:
        """One verified timeout entry from a partial bundle."""
        maker = self.timeouts_aggregators.setdefault(round_, TCMaker())
        tc = maker.add(
            author,
            sig,
            high_qc_round,
            round_,
            self.epochs.committee_for_round(round_),
        )
        self._seed(_timeout_digest(round_, high_qc_round), author, sig)
        return tc

    def cleanup(self, round_: Round) -> None:
        self.votes_aggregators = {
            k: v for k, v in self.votes_aggregators.items() if k[0] >= round_
        }
        self.timeouts_aggregators = {
            k: v for k, v in self.timeouts_aggregators.items() if k >= round_
        }


# ---------------------------------------------------------------------------
# Aggregate certificate plane (§5.5o): Handel-style partial sets.


class AggPartialSet:
    """Windowed, scored set of VERIFIED partials for one aggregation key
    (Handel, arXiv:1906.05132 §4, collapsed to the parts this plane
    needs): each entry is (coverage bitmap, opaque payload, depth).

    * Scoring: an incoming partial whose coverage is a SUBSET of an
      existing entry scores zero and is dropped — it can never extend
      the best packing.
    * Merging: on every insert, one greedy best-first pass combines the
      newcomer with every bitmap-DISJOINT entry (`merge` is the scheme's
      public combine — point add / stub XOR — plus the payload-specific
      bookkeeping); both the raw partial and the merged packing are
      retained so later arrivals can pack differently.
    * Windowing: entries are kept best-coverage-first and truncated to
      `window` — bounded state per key no matter what an adversary
      floods (unverified junk never reaches this set at all: partials
      verify atomically BEFORE insertion).

    Determinism: ordering is (coverage desc, bitmap asc) — pure
    functions of the entries, so same-seed fleets pack identically."""

    __slots__ = ("window", "entries", "_merge")

    def __init__(self, merge, window: int = 8) -> None:
        self._merge = merge
        self.window = max(1, int(window))
        self.entries: list[tuple[int, object, int]] = []

    def add(self, bitmap: int, payload, depth: int) -> None:
        for bm, _, _ in self.entries:
            if bitmap | bm == bm:
                return  # subset: score 0
        merged_bm, merged_payload, merged_depth = bitmap, payload, depth
        merged = False
        for bm, pl, dp in self.entries:
            if not merged_bm & bm:
                merged_bm |= bm
                merged_payload = self._merge(merged_payload, pl)
                merged_depth = max(merged_depth, dp) + 1
                merged = True
                _M_AGG_MERGES.inc()
        self.entries.append((bitmap, payload, depth))
        if merged:
            self.entries.append((merged_bm, merged_payload, merged_depth))
        self.entries.sort(key=lambda e: (-e[0].bit_count(), e[0]))
        del self.entries[self.window:]

    def best(self) -> tuple[int, object, int] | None:
        return self.entries[0] if self.entries else None


def _bitmap_stake(bitmap: int, committee: Committee) -> int:
    keys = committee.sorted_keys()
    return sum(
        committee.stake(keys[i])
        for i in range(bitmap.bit_length())
        if bitmap >> i & 1
    )


class AggQCMaker:
    """Packs verified vote partials for one (round, digest) into an
    AggQC; fires exactly once, like QCMaker."""

    def __init__(self, scheme, window: int) -> None:
        self.partials = AggPartialSet(scheme.combine, window)
        self.done = False

    def add(
        self,
        bitmap: int,
        agg_sig: bytes,
        depth: int,
        hash_: Digest,
        round_: Round,
        committee: Committee,
    ) -> AggQC | None:
        if self.done:
            return None
        self.partials.add(bitmap, agg_sig, depth)
        best = self.partials.best()
        if best is None:
            return None
        bm, sig, _ = best
        if _bitmap_stake(bm, committee) >= committee.quorum_threshold():
            self.done = True
            _M_QCS.inc()
            _M_AGG_QCS.inc()
            return AggQC(hash_, round_, bm, sig)
        return None


def _merge_timeout_payload(a, b):
    """Payloads are ((hqr, bitmap) groups sorted by hqr, agg_sig): union
    same-hqr groups bitwise, keep the combined signature alongside."""
    groups_a, sig_a, scheme = a
    groups_b, sig_b, _ = b
    merged: dict[Round, int] = dict(groups_a)
    for hqr, bm in groups_b:
        merged[hqr] = merged.get(hqr, 0) | bm
    return (tuple(sorted(merged.items())), scheme.combine(sig_a, sig_b), scheme)


class AggTCMaker:
    """Packs verified timeout partials for one round into an AggTC."""

    def __init__(self, scheme, window: int) -> None:
        self.partials = AggPartialSet(_merge_timeout_payload, window)
        self.done = False
        self._scheme = scheme

    def add(
        self,
        groups: tuple[tuple[Round, int], ...],
        agg_sig: bytes,
        depth: int,
        round_: Round,
        committee: Committee,
    ) -> AggTC | None:
        if self.done:
            return None
        coverage = 0
        for _, bm in groups:
            coverage |= bm
        self.partials.add(
            coverage,
            (tuple(sorted(groups)), agg_sig, self._scheme),
            depth,
        )
        best = self.partials.best()
        if best is None:
            return None
        bm, payload, _ = best
        if _bitmap_stake(bm, committee) >= committee.quorum_threshold():
            self.done = True
            _M_TCS.inc()
            _M_AGG_TCS.inc()
            best_groups, sig, _ = payload
            return AggTC(round_, best_groups, sig)
        return None


class AggCertAggregator:
    """Aggregate-plane sibling of Aggregator: per-(round, digest) vote
    makers and per-round timeout makers over Handel partial sets. The
    caller (core / overlay router) verifies every partial atomically
    BEFORE it reaches this state — nothing here re-checks signatures."""

    def __init__(self, committee, window: int = 8) -> None:
        self.epochs = as_manager(committee)
        self.window = window
        self.vote_makers: dict[tuple[Round, Digest], AggQCMaker] = {}
        self.timeout_makers: dict[Round, AggTCMaker] = {}

    def add_vote_partial(self, bundle: AggVoteBundle) -> AggQC | None:
        key = (bundle.round, bundle.hash)
        maker = self.vote_makers.get(key)
        if maker is None:
            maker = AggQCMaker(aggsig.active_agg_scheme(), self.window)
            self.vote_makers[key] = maker
        return maker.add(
            bundle.bitmap,
            bundle.agg_sig,
            bundle.depth,
            bundle.hash,
            bundle.round,
            self.epochs.committee_for_round(bundle.round),
        )

    def add_timeout_partial(
        self,
        round_: Round,
        groups: tuple[tuple[Round, int], ...],
        agg_sig: bytes,
        depth: int,
    ) -> AggTC | None:
        maker = self.timeout_makers.get(round_)
        if maker is None:
            maker = AggTCMaker(aggsig.active_agg_scheme(), self.window)
            self.timeout_makers[round_] = maker
        return maker.add(
            groups,
            agg_sig,
            depth,
            round_,
            self.epochs.committee_for_round(round_),
        )

    def cleanup(self, round_: Round) -> None:
        self.vote_makers = {
            k: v for k, v in self.vote_makers.items() if k[0] >= round_
        }
        self.timeout_makers = {
            k: v for k, v in self.timeout_makers.items() if k >= round_
        }
