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

from ..crypto import Digest, PublicKey, Signature
from ..utils import metrics, tracing
from .config import Committee
from .errors import UnknownAuthorityError, ensure
from .messages import (
    QC,
    TC,
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
