"""Byzantine adversary policies: wire-level misbehaviour for a real node.

A Byzantine chaos node runs the UNMODIFIED consensus stack (so it forms
QCs, rotates leadership and keeps protocol state like any replica) while
an AdversaryPolicy attached to its transport edges mutates, suppresses,
or fabricates its wire traffic. The adversary legitimately owns the
node's signing seed, so equivocating proposals are properly signed — the
attack is on protocol semantics, not on the signature scheme — while the
forgery policies deliberately emit garbage signatures to exercise the
verification rejection lanes (and prove the dedup cache never caches a
rejected triple).

Policies work on the consensus-plane codec (decode_consensus_message /
encode_consensus_message); frames they cannot decode (another plane, or
future message types) pass through untouched.
"""

from __future__ import annotations

import logging

from ..consensus.messages import (
    QC,
    TC,
    Block,
    Timeout,
    TimeoutBundle,
    Vote,
    VoteBundle,
    decode_consensus_message,
    encode_consensus_message,
)
from ..crypto.primitives import Digest, PublicKey, Signature
from ..crypto import pysigner
from ..utils import metrics

log = logging.getLogger("hotstuff.chaos")

_M_FORGED_VOTES = metrics.counter("chaos.forged_votes")
_M_FORGED_TIMEOUTS = metrics.counter("chaos.forged_timeouts")
_M_EQUIVOCATIONS = metrics.counter("chaos.equivocations")
_M_STALE_REPLAYS = metrics.counter("chaos.stale_replays")
_M_WITHHELD = metrics.counter("chaos.withheld_votes")


class AdversaryPolicy:
    """Base policy: observe/forward everything unchanged.

    `on_send(src, dst, data)` returns a list of unframed payloads to send
    in place of `data` (empty = suppress, None = pass through unchanged);
    `on_receive(src, dst, data)` observes inbound traffic to the Byzantine
    node. `attach(transport)` hands the policy its injection handle."""

    def __init__(self, node: int, seed: bytes, committee, rng) -> None:
        self.node = node
        self.seed = seed
        self.committee = committee
        self.rng = rng
        self.transport = None
        self.names = sorted(committee.authorities.keys())
        self.pk = self.names[node]

    def attach(self, transport) -> None:
        self.transport = transport

    def on_send(self, src: int, dst: int, data: bytes):
        return None

    def on_receive(self, src: int | None, dst: int, data: bytes) -> None:
        return None

    # -- helpers -------------------------------------------------------------

    def _decode(self, data: bytes):
        try:
            return decode_consensus_message(data)
        except Exception:
            return None  # not consensus-plane traffic; leave it alone

    def _broadcast_honest(self, msg) -> None:
        data = encode_consensus_message(msg)
        for i in range(len(self.names)):
            if i != self.node:
                self.transport.inject(i, data)


class Equivocator(AdversaryPolicy):
    """Equivocating leader: when this node broadcasts its own proposal,
    each recipient gets one of TWO conflicting, correctly signed blocks
    for the same round (split by destination parity). Safety must hold:
    at most one branch can gather a quorum."""

    def on_send(self, src: int, dst: int, data: bytes):
        msg = self._decode(data)
        if not isinstance(msg, Block) or msg.author != self.pk:
            return None
        variant = dst % 2
        payload = [Digest.of(f"equivocation-{msg.round}-{variant}".encode())]
        digest = Block.make_digest(self.pk, msg.round, payload, msg.qc)
        twin = Block(
            msg.qc,
            msg.tc,
            self.pk,
            msg.round,
            tuple(payload),
            Signature(pysigner.sign(self.seed, digest.data)),
        )
        _M_EQUIVOCATIONS.inc()
        log.debug(
            "equivocating leader: round %d variant %d -> node %d",
            msg.round,
            variant,
            dst,
        )
        return [encode_consensus_message(twin)]


class SigForger(AdversaryPolicy):
    """Forged-signature flood: every proposal this node observes triggers
    a burst of votes and timeouts with garbage signatures, claiming BOTH
    its own and honest authorities as authors. Every one of them must die
    in the verification rejection lanes — zero false accepts, zero dedup
    cache entries."""

    def __init__(self, node, seed, committee, rng, burst: int = 2) -> None:
        super().__init__(node, seed, committee, rng)
        self.burst = burst
        self.forged: list[tuple[bytes, PublicKey, Signature]] = []

    def on_receive(self, src, dst, data) -> None:
        msg = self._decode(data)
        if not isinstance(msg, Block):
            return
        for author in self.names[: self.burst + 1]:
            sig = Signature(self.rng.randbytes(64))
            vote = Vote(msg.digest(), msg.round, author, sig)
            self.forged.append((vote.signed_digest().data, author, sig))
            _M_FORGED_VOTES.inc()
            self._broadcast_honest(vote)
        # A forged timeout (garbage signature over the timeout digest) with
        # a replayed-but-valid high_qc: the timeout signature must reject.
        tsig = Signature(self.rng.randbytes(64))
        timeout = Timeout(msg.qc, msg.round, self.pk, tsig)
        self.forged.append((timeout.signed_digest().data, self.pk, tsig))
        _M_FORGED_TIMEOUTS.inc()
        self._broadcast_honest(timeout)


class StaleReplayer(AdversaryPolicy):
    """Stale-QC replay: remembers blocks and TCs it sees, and re-broadcasts
    old ones whenever a newer proposal arrives. Honest nodes must discard
    stale rounds without state damage or double commits."""

    KEEP = 16

    def __init__(self, node, seed, committee, rng) -> None:
        super().__init__(node, seed, committee, rng)
        self._old: list = []

    def on_receive(self, src, dst, data) -> None:
        msg = self._decode(data)
        if isinstance(msg, (Block, TC)):
            if self._old and self.rng.random() < 0.5:
                stale = self._old[self.rng.randrange(len(self._old))]
                _M_STALE_REPLAYS.inc()
                self._broadcast_honest(stale)
            self._old.append(msg)
            del self._old[: -self.KEEP]


class VoteWithholder(AdversaryPolicy):
    """Withholds every vote and timeout this node would have sent. With
    n = 3f+1 the remaining 2f+1 honest replicas must keep committing
    (at timeout pace through the Byzantine node's leader rounds)."""

    def on_send(self, src: int, dst: int, data: bytes):
        msg = self._decode(data)
        if isinstance(msg, (Vote, Timeout)):
            _M_WITHHELD.inc()
            return []
        return None


class BundlePoisoner(AdversaryPolicy):
    """Byzantine aggregator for the overlay plane (consensus/overlay.py):
    POISONS every outbound partial bundle with a forged entry claiming an
    honest authority (garbage signature — it must reject alone, without
    suppressing the honest entries it rides beside), and WITHHOLDS a
    fraction of the bundles it should have forwarded up the tree (the
    silent-aggregator shape the gossip fallback exists to bound). The
    node legitimately signs its own entries — the attack is on the
    aggregation relay, not the signature scheme.

    Deterministic by COUNT, not probability: every WITHHOLD_EVERY-th
    bundle is dropped, every other one is poisoned — a short run (the
    tier-1 sweep early-stops on its commit floor) still exercises both
    behaviours as soon as a handful of bundles flow."""

    WITHHOLD_EVERY = 3

    def __init__(self, node, seed, committee, rng) -> None:
        super().__init__(node, seed, committee, rng)
        self.forged: list[tuple[bytes, PublicKey, Signature]] = []
        self._bundles_seen = 0

    def on_send(self, src: int, dst: int, data: bytes):
        from ..consensus.messages import _timeout_digest, _vote_digest

        msg = self._decode(data)
        if not isinstance(msg, (VoteBundle, TimeoutBundle)):
            return None
        self._bundles_seen += 1
        if self._bundles_seen % self.WITHHOLD_EVERY == 0:
            _M_WITHHELD.inc()
            return []
        author = self.names[(self.node + 1) % len(self.names)]
        sig = Signature(self.rng.randbytes(64))
        if isinstance(msg, VoteBundle):
            self.forged.append(
                (_vote_digest(msg.hash, msg.round).data, author, sig)
            )
            _M_FORGED_VOTES.inc()
            poisoned = VoteBundle(
                msg.round, msg.hash, msg.votes + ((author, sig),)
            )
        else:
            # Two attack classes per timeout bundle: (a) a garbage
            # signature under an honest authority (dies in signature
            # verification), and (b) the TC-poisoning shape
            # overlay.filter_backed exists for — this node's OWN entry
            # re-signed with a LEGITIMATE signature over an absurd
            # high_qc_round claim the carried QC cannot back. Honest
            # receivers must drop (b) unmerged (agg.invalid_entries), or
            # any TC including it would fail every future proposal's
            # justification check: permanent liveness loss.
            fake_hqr = msg.round + 1_000_000
            fake_sig = Signature(
                pysigner.sign(
                    self.seed, _timeout_digest(msg.round, fake_hqr).data
                )
            )
            entries = tuple(
                (self.pk, fake_sig, fake_hqr) if pk == self.pk else (pk, s, hqr)
                for pk, s, hqr in msg.timeouts
            )
            hqr = msg.high_qc.round
            self.forged.append(
                (_timeout_digest(msg.round, hqr).data, author, sig)
            )
            _M_FORGED_TIMEOUTS.inc()
            poisoned = TimeoutBundle(
                msg.round, msg.high_qc, entries + ((author, sig, hqr),)
            )
        return [encode_consensus_message(poisoned)]
