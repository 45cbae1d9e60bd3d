"""Region-aware aggregation overlay for the vote/timeout plane.

The all-to-all control plane is the measured blocker on the road to
100-1000-node committees: a stalled round costs O(n²) timeout frames
(every node re-broadcasts its Timeout to every peer at pacemaker pace —
the 64-node lossy@seed2 storm in CHAOS_MATRIX_r01). Handel
(arXiv:1906.05132) and aggregated-signature gossip BFT (arXiv:1911.04698)
show the fix: aggregate partial quorums along a tree so each node ships
ONE frame up instead of n-1 frames out.

Pieces:

  * `AggregationTree` — the pure derivation. For (epoch committee, round,
    kind) the tree is a deterministic function every honest node computes
    identically: members are permuted by a round-keyed hash (load
    rotates across rounds), grouped by WAN region, each region forms a
    `fanout`-ary heap rooted at its region head, and region heads make
    ONE cross-region hop to the round's collector. The collector is the
    next round's leader for the vote plane (it needs the QC to propose)
    and a plurality-region member for the timeout plane (region-aware
    placement — ROADMAP item 5 residue (c): the TC can form anywhere and
    is broadcast, so the root belongs where most of the committee is
    cheap to reach). Epoch boundaries rotate the tree automatically:
    membership resolves per round through the EpochManager schedule.

  * `OverlayRouter` — a node's runtime: per-(round, kind) merge state,
    hold timers (an interior node briefly waits to merge its children's
    partials into one upward frame), bounded re-forwards, and the
    GOSSIP FALLBACK: if the round has not advanced `agg_fallback_ms`
    after this node shipped its own entry, it gossips its merged partial
    to `agg_fanout` deterministic peers — a crashed aggregator degrades
    to bounded fan-out instead of silence.

Partial bundles (`consensus/messages.py` VoteBundle / TimeoutBundle) are
UNAUTHENTICATED containers like SyncRangeReply: every carried entry is an
individually signed vote/timeout, batch-verified by the receiver through
the BatchVerificationService on the scheduler's dedicated `aggregate`
lane (crypto/scheduler.py — priority between consensus and sync) before
it is merged. An invalid entry is dropped and counted
(`agg.invalid_entries`) WITHOUT poisoning the rest of the bundle, so a
Byzantine aggregator can waste one lie per frame but cannot suppress the
honest entries it relays — and withholding entirely is what the fallback
bounds. A bundle's carried high_qc is quorum-checked and batch-verified
before adoption, like a Timeout's.

Frame accounting: `agg.vote_frames` / `agg.timeout_frames` count every
vote-/timeout-plane frame SENT (bundles here, unicast votes and broadcast
timeouts on the legacy path in core.py), so frames-per-timeout is
computable in both modes — the committed `timeout_storm` vs
`timeout_storm_legacy` matrix cells are exactly that ratio, O(fanout)
vs O(n).

Determinism: no wall-clock reads, hold/fallback timers ride the event
loop (virtual under chaos), and the tree is a pure hash of
(round, kind, committee) — a same-seed chaos replay reproduces identical
bundle traffic bit for bit.

The port's copy of `hotstuff_tpu/consensus/overlay.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import asyncio
import logging
import struct

from ..crypto import Digest, PublicKey, aggsig, sha512_32
from ..utils import metrics, tracing
from ..utils.actors import spawn
from .aggregator import AggPartialSet, _merge_timeout_payload
from .errors import ConsensusError
from .messages import (
    QC,
    AggQC,
    AggTimeoutBundle,
    AggVoteBundle,
    Round,
    TimeoutBundle,
    VoteBundle,
)

log = logging.getLogger("hotstuff.consensus")

KIND_VOTE = 0
KIND_TIMEOUT = 1

_M_BUNDLES_SENT = metrics.counter("agg.bundles_sent")
_M_BUNDLES_RECEIVED = metrics.counter("agg.bundles_received")
_M_ENTRIES_MERGED = metrics.counter("agg.entries_merged")
_M_INVALID = metrics.counter("agg.invalid_entries")
_M_FALLBACKS = metrics.counter("agg.fallbacks")
_M_VOTE_FRAMES = metrics.counter("agg.vote_frames")
_M_TIMEOUT_FRAMES = metrics.counter("agg.timeout_frames")

# How many (round, kind) trees the router memoizes: the active round plus
# a little slack for late traffic (trees are cheap to rebuild; the cache
# only bounds repeated derivation inside one round's message burst).
_TREE_CACHE = 8


def note_plane_frames(kind: int, n: int) -> None:
    """Count `n` vote-/timeout-plane frames sent. Called by the router
    for bundle traffic and by core.py for the legacy unicast/broadcast
    paths, so the storm metric is mode-independent."""
    if n <= 0:
        return
    (_M_VOTE_FRAMES if kind == KIND_VOTE else _M_TIMEOUT_FRAMES).inc(n)


class AggregationTree:
    """Deterministic region-aware aggregation tree for one (round, kind).

    Derivation rule (documented in COMPONENTS.md §5.5l):
      1. `seed = sha512_32("HSAGGTREE" || round || kind)`; members sort
         by `sha512_32(seed || pk)` — a per-round permutation, so
         interior/aggregator duty rotates with the round.
      2. Members group by WAN region (unknown region -> "").
      3. The collector is `collector` when given (vote plane: the next
         leader), else the first permuted member of the PLURALITY region
         (most members; ties break on the smaller region label).
      4. Each region's permuted members form a `fanout`-ary heap:
         `parent(list[j]) = list[(j-1)//fanout]`; the region head is
         `list[0]` (the collector, in its own region).
      5. Region heads make ONE cross-region hop to the collector; every
         other edge is intra-region.
    """

    __slots__ = (
        "round", "kind", "fanout", "collector", "order",
        "_parent", "_children", "_region", "_subtree",
    )

    def __init__(
        self,
        members: list[PublicKey],
        region_of: dict[PublicKey, str],
        round_: Round,
        kind: int,
        fanout: int,
        collector: PublicKey | None = None,
    ) -> None:
        if not members:
            raise ValueError("aggregation tree needs at least one member")
        self.round = round_
        self.kind = kind
        self.fanout = max(1, fanout)
        seed = sha512_32(b"HSAGGTREE" + struct.pack("<QB", round_, kind))
        self.order = sorted(members, key=lambda pk: sha512_32(seed + pk.data))
        self._region = {pk: region_of.get(pk, "") for pk in self.order}
        by_region: dict[str, list[PublicKey]] = {}
        for pk in self.order:
            by_region.setdefault(self._region[pk], []).append(pk)
        if collector is None:
            # Plurality-region placement (timeout plane): the region with
            # the most members wins, ties break on the smaller label, and
            # the collector is its first permuted member — the subtree's
            # plurality region hosts the root (ROADMAP 5 residue (c)).
            plurality = min(
                by_region.items(), key=lambda kv: (-len(kv[1]), kv[0])
            )[0]
            collector = by_region[plurality][0]
        # A vote-plane collector outside this round's committee (the next
        # epoch's leader at a boundary) owns no intra-region subtree:
        # every region head simply hops to it.
        self.collector = collector
        self._parent: dict[PublicKey, PublicKey | None] = {}
        self._children: dict[PublicKey, list[PublicKey]] = {}
        for _region, group in sorted(by_region.items()):
            if collector in group:
                group = [collector] + [pk for pk in group if pk != collector]
            for j, pk in enumerate(group):
                if j == 0:
                    self._parent[pk] = None if pk == collector else collector
                else:
                    self._parent[pk] = group[(j - 1) // self.fanout]
        self._parent[collector] = None
        for pk, parent in self._parent.items():
            if parent is not None:
                self._children.setdefault(parent, []).append(pk)
        # Subtree sizes precomputed bottom-up (reverse BFS from the
        # collector): subtree_size is read on EVERY merge, and a per-call
        # recursive walk would cost O(subtree) per inbound bundle.
        bfs = [collector]
        i = 0
        while i < len(bfs):
            bfs.extend(self._children.get(bfs[i], ()))
            i += 1
        self._subtree: dict[PublicKey, int] = {}
        for pk in reversed(bfs):
            self._subtree[pk] = 1 + sum(
                self._subtree[c] for c in self._children.get(pk, ())
            )

    def parent(self, pk: PublicKey) -> PublicKey | None:
        return self._parent.get(pk)

    def children(self, pk: PublicKey) -> list[PublicKey]:
        return self._children.get(pk, [])

    def subtree_size(self, pk: PublicKey) -> int:
        """Members in pk's subtree, pk included (the coverage target an
        interior node forwards at without waiting out its hold timer)."""
        return self._subtree.get(pk, 1)

    def fallback_peers(self, pk: PublicKey, k: int) -> list[PublicKey]:
        """The k members after pk in permuted order (cyclic, self
        excluded): the bounded gossip set a fallback degrades to."""
        others = [m for m in self.order if m != pk]
        if not others:
            return []
        try:
            start = self.order.index(pk)
        except ValueError:
            start = 0
        rotated = self.order[start + 1 :] + self.order[: start + 1]
        return [m for m in rotated if m != pk][:k]

    def cross_region_edges(self) -> int:
        """Count of tree edges whose endpoints sit in different regions —
        by construction at most one per region (head -> collector)."""
        return sum(
            1
            for pk, parent in self._parent.items()
            if parent is not None
            and self._region.get(pk) != self._region.get(parent)
        )

    def depth(self, pk: PublicKey) -> int:
        d, cur = 0, pk
        while True:
            parent = self._parent.get(cur)
            if parent is None:
                return d
            d, cur = d + 1, parent


class _Pending:
    """Merge state for one (round, kind[, digest]) key. Legacy mode
    accumulates per-author entries; aggregate mode (Parameters.
    aggregate_certs) accumulates bitmap-disjoint partials in a Handel
    AggPartialSet instead — `agg_set` is created on first aggregate
    merge and the two never mix under one key."""

    __slots__ = (
        "entries", "best_qc", "forwards", "hold_task", "fallback_task",
        "agg_set",
    )

    def __init__(self) -> None:
        self.entries: dict[PublicKey, tuple] = {}
        self.best_qc: QC | None = None  # best carried cert (QC or AggQC)
        self.forwards = 0
        self.hold_task: asyncio.Task | None = None
        self.fallback_task: asyncio.Task | None = None
        self.agg_set: AggPartialSet | None = None

    def cancel_hold(self) -> None:
        if self.hold_task is not None and not self.hold_task.done():
            self.hold_task.cancel()
        self.hold_task = None

    def cancel(self) -> None:
        self.cancel_hold()
        if self.fallback_task is not None and not self.fallback_task.done():
            self.fallback_task.cancel()
        self.fallback_task = None


class OverlayRouter:
    """A node's overlay runtime. Owned by the consensus Core (which does
    the verification and certificate assembly); the router owns tree
    derivation, merge state, hold/fallback timers, and bundle egress.

    Always constructed — `enabled` (Parameters.aggregation_overlay)
    gates only whether this node's OWN votes/timeouts ride the tree;
    inbound bundles merge and count either way, so a mixed fleet
    degrades gracefully."""

    def __init__(self, core, region_of: dict[PublicKey, str] | None = None) -> None:
        self.core = core
        self.enabled = bool(core.parameters.aggregation_overlay)
        self.region_of = dict(region_of or {})
        p = core.parameters
        self.fanout = p.agg_fanout
        self.hold_s = p.agg_hold_ms / 1000.0
        self.fallback_s = p.agg_fallback_ms / 1000.0
        self.max_forwards = p.agg_max_forwards
        # Aggregate-certificate mode: partials are one signature + bitmap
        # and interior merges are combine()+OR — never entry lists.
        self.agg = bool(p.aggregate_certs)
        self.window = p.agg_window
        self._trees: dict[tuple[Round, int], AggregationTree] = {}
        self._state: dict[tuple, _Pending] = {}

    # -- tree derivation -----------------------------------------------------

    def tree(self, round_: Round, kind: int) -> AggregationTree:
        key = (round_, kind)
        t = self._trees.get(key)
        if t is None:
            epochs = self.core.epochs
            members = epochs.schedule.sorted_keys_for_round(round_)
            # Vote-plane root: the NEXT leader needs the QC to propose —
            # the baseline roots the tree there. Leader-collector mode
            # (§5.5p) roots it at the CURRENT leader instead (collector
            # == leader's region head by construction); the certificate
            # then rides one explicit handoff frame to the next proposer
            # (core._handoff_qc).
            collector = (
                self.core.leader_elector.get_leader(
                    round_
                    if self.core.parameters.leader_collector
                    else round_ + 1
                )
                if kind == KIND_VOTE
                else None
            )
            t = AggregationTree(
                members, self.region_of, round_, kind, self.fanout, collector
            )
            if len(self._trees) >= _TREE_CACHE:
                # Evict the entry FARTHEST from the requested round, not
                # the lowest: a staked peer signing entries for far-future
                # rounds could otherwise pin the cache with junk trees
                # while the ACTIVE round's tree gets evicted per bundle.
                farthest = max(
                    self._trees, key=lambda k: abs(k[0] - round_)
                )
                del self._trees[farthest]
            self._trees[key] = t
        return t

    # -- merge state ---------------------------------------------------------

    @staticmethod
    def vote_key(round_: Round, hash_: Digest) -> tuple:
        return (KIND_VOTE, round_, hash_)

    @staticmethod
    def timeout_key(round_: Round) -> tuple:
        return (KIND_TIMEOUT, round_)

    def _pending(self, key: tuple) -> _Pending:
        # Parity note: like the Aggregator's maker maps (aggregator.py),
        # a Byzantine peer holding real stake can sign future-round
        # entries and grow this map ahead of the round; cleanup() bounds
        # it on every round advance, same as the reference's aggregator.
        st = self._state.get(key)
        if st is None:
            st = self._state[key] = _Pending()
        return st

    def fresh(self, key: tuple, entries) -> list:
        """Entries whose author this key has not merged yet — the dedup
        applied BEFORE verification so redelivered bundles cost nothing."""
        seen = self._pending(key).entries
        out, dup = [], set()
        for entry in entries:
            if entry[0] not in seen and entry[0] not in dup:
                dup.add(entry[0])
                out.append(entry)
        return out

    def merge(self, key: tuple, entries, high_qc: QC | None = None) -> list:
        """Merge VERIFIED entries; returns the genuinely new ones. Keeps
        the highest-round high_qc seen for timeout keys (the one the
        forwarded bundle carries up)."""
        st = self._pending(key)
        new = []
        for entry in entries:
            if entry[0] not in st.entries:
                st.entries[entry[0]] = entry
                new.append(entry)
        if new:
            _M_ENTRIES_MERGED.inc(len(new))
        if high_qc is not None and not high_qc.is_genesis():
            if st.best_qc is None or high_qc.round > st.best_qc.round:
                st.best_qc = high_qc
        return new

    def note_invalid(self, n: int) -> None:
        if n > 0:
            _M_INVALID.inc(n)

    # -- aggregate merges (Parameters.aggregate_certs) -----------------------

    def merge_agg_vote(
        self, key: tuple, bitmap: int, agg_sig: bytes, depth: int
    ) -> None:
        """Merge one VERIFIED vote partial: Handel windowed insert —
        combine() + bitmap OR against every disjoint entry."""
        st = self._pending(key)
        if st.agg_set is None:
            st.agg_set = AggPartialSet(
                aggsig.active_agg_scheme().combine, self.window
            )
        st.agg_set.add(bitmap, agg_sig, depth)
        _M_ENTRIES_MERGED.inc(bitmap.bit_count())

    def merge_agg_timeout(
        self,
        key: tuple,
        groups: tuple[tuple[Round, int], ...],
        agg_sig: bytes,
        depth: int,
        carried_cert=None,
    ) -> None:
        """Merge one VERIFIED timeout partial. Keeps the highest-round
        carried certificate: every accepted partial's claims were backed
        by its own carried cert, so the max over contributors backs the
        merged bundle's claims too (the atomic analogue of
        filter_backed's invariant)."""
        st = self._pending(key)
        if st.agg_set is None:
            st.agg_set = AggPartialSet(_merge_timeout_payload, self.window)
        coverage = 0
        for _, bm in groups:
            coverage |= bm
        st.agg_set.add(
            coverage,
            (tuple(sorted(groups)), agg_sig, aggsig.active_agg_scheme()),
            depth,
        )
        _M_ENTRIES_MERGED.inc(coverage.bit_count())
        if carried_cert is not None and not carried_cert.is_genesis():
            if st.best_qc is None or carried_cert.round > st.best_qc.round:
                st.best_qc = carried_cert

    def covered(self, key: tuple) -> int:
        """Members this key's merged state covers — entry count in legacy
        mode, best-packing popcount in aggregate mode (the forward-policy
        quantity)."""
        st = self._pending(key)
        if st.agg_set is not None:
            best = st.agg_set.best()
            return best[0].bit_count() if best else 0
        return len(st.entries)

    def quorum_certificate(self, key: tuple, committee) -> QC | AggQC | None:
        """The complete certificate this vote key's merged state can
        assemble, or None below quorum stake. The leader-collector
        quorum watch (§5.5p): under Parameters.leader_collector the
        NEXT leader is an ordinary interior node of the round's tree —
        the collector is the round's own leader — so it cannot sink
        partials into an aggregator without starving the collector's
        subtree. Instead it assembles straight from merged state the
        moment coverage reaches quorum, which the collector's explicit
        handoff frame (core._handoff_qc, a whole-QC bundle) delivers in
        one merge. Entries here are already verified (only verified
        partials merge), so the check is structural stake arithmetic."""
        st = self._state.get(key)
        if st is None or key[0] != KIND_VOTE:
            return None
        if st.agg_set is not None:
            best = st.agg_set.best()
            if best is None:
                return None
            bitmap, sig, _depth = best
            qc: QC | AggQC = AggQC(key[2], key[1], bitmap, sig)
        elif st.entries:
            qc = QC(key[2], key[1], tuple(st.entries.values()))
        else:
            return None
        try:
            qc.check_quorum(committee)
        except ConsensusError:
            return None
        return qc

    # -- egress --------------------------------------------------------------

    def _bundle(self, key: tuple):
        st = self._pending(key)
        if st.agg_set is not None:
            best = st.agg_set.best()
            if best is None:
                return None
            if key[0] == KIND_VOTE:
                bitmap, sig, depth = best
                return AggVoteBundle(key[1], key[2], bitmap, sig, depth)
            _, payload, depth = best
            groups, sig, _ = payload
            return AggTimeoutBundle(
                key[1], st.best_qc or QC.genesis(), groups, sig, depth
            )
        entries = tuple(st.entries.values())
        if key[0] == KIND_VOTE:
            return VoteBundle(key[1], key[2], entries)
        return TimeoutBundle(key[1], st.best_qc or QC.genesis(), entries)

    async def _send(self, key: tuple, to: PublicKey, urgent: bool) -> None:
        bundle = self._bundle(key)
        if bundle is None or not bundle_weight(bundle):
            return
        _M_BUNDLES_SENT.inc()
        note_plane_frames(key[0], 1)
        tracing.RECORDER.record(
            "agg.bundle",
            None,
            None,
            {
                "round": key[1],
                "kind": "vote" if key[0] == KIND_VOTE else "timeout",
                "entries": bundle_weight(bundle),
            },
        )
        await self.core._transmit(bundle, to, urgent=urgent)

    async def on_own_vote(self, vote) -> None:
        """This node's vote enters the tree (never called when this node
        is the collector — the core feeds its own aggregator directly)."""
        key = self.vote_key(vote.round, vote.hash)
        self.merge(key, [(vote.author, vote.signature)])
        self._arm_fallback(key)
        await self.after_merge(key)

    async def on_own_timeout(self, timeout) -> None:
        key = self.timeout_key(timeout.round)
        self.merge(
            key,
            [(timeout.author, timeout.signature, timeout.high_qc.round)],
            high_qc=timeout.high_qc,
        )
        self._arm_fallback(key)
        await self.after_merge(key)

    async def on_own_vote_agg(self, bundle: AggVoteBundle) -> None:
        """This node's own singleton vote partial enters the tree."""
        key = self.vote_key(bundle.round, bundle.hash)
        self.merge_agg_vote(key, bundle.bitmap, bundle.agg_sig, bundle.depth)
        self._arm_fallback(key)
        await self.after_merge(key)

    async def on_own_timeout_agg(self, bundle: AggTimeoutBundle) -> None:
        key = self.timeout_key(bundle.round)
        self.merge_agg_timeout(
            key, bundle.groups, bundle.agg_sig, bundle.depth,
            carried_cert=bundle.high_qc,
        )
        self._arm_fallback(key)
        await self.after_merge(key)

    async def after_merge(self, key: tuple) -> None:
        """Forward policy after any merge: ship immediately once this
        node's whole subtree is covered (nothing left to wait for), else
        arm the hold timer so nearby children coalesce into one frame."""
        if not self.enabled:
            return
        round_ = key[1]
        if self.core.round > round_:
            return
        st = self._pending(key)
        if st.forwards >= self.max_forwards:
            return  # _forward would no-op: don't churn hold tasks
        tree = self.tree(round_, key[0])
        if tree.parent(self.core.name) is None:
            return  # collector: the core's aggregator is the sink
        if self.covered(key) >= tree.subtree_size(self.core.name):
            st.cancel_hold()
            await self._forward(key)
        elif st.hold_task is None or st.hold_task.done():
            st.hold_task = spawn(self._hold(key), name="agg-hold")

    async def _forward(self, key: tuple) -> None:
        st = self._pending(key)
        if self.core.round > key[1] or st.forwards >= self.max_forwards:
            return
        tree = self.tree(key[1], key[0])
        parent = tree.parent(self.core.name)
        if parent is None:
            return
        st.forwards += 1
        await self._send(key, parent, urgent=key[0] == KIND_TIMEOUT)

    async def _hold(self, key: tuple) -> None:
        try:
            await asyncio.sleep(self.hold_s)
        except asyncio.CancelledError:
            return
        st = self._state.get(key)
        if st is not None:
            st.hold_task = None
        await self._forward(key)

    def _arm_fallback(self, key: tuple) -> None:
        """(Re-)arm the gossip fallback each time this node contributes
        its OWN entry: if the round is still stalled `agg_fallback_ms`
        later (dead parent, dead collector, partition), the merged
        partial gossips to `fanout` deterministic peers — bounded
        fan-out instead of silence."""
        if not self.enabled:
            return
        st = self._pending(key)
        if st.fallback_task is not None and not st.fallback_task.done():
            return
        st.fallback_task = spawn(self._fallback(key), name="agg-fallback")

    async def _fallback(self, key: tuple) -> None:
        try:
            await asyncio.sleep(self.fallback_s)
        except asyncio.CancelledError:
            return
        st = self._state.get(key)
        if st is not None:
            st.fallback_task = None
        if self.core.round > key[1]:
            return  # the round advanced: the tree worked
        tree = self.tree(key[1], key[0])
        peers = tree.fallback_peers(self.core.name, self.fanout)
        if not peers:
            return
        st = self._pending(key)
        _M_FALLBACKS.inc()
        note_plane_frames(key[0], len(peers))
        _M_BUNDLES_SENT.inc(len(peers))
        covered = self.covered(key)
        tracing.RECORDER.record(
            "agg.fallback",
            None,
            None,
            {"round": key[1], "peers": len(peers), "entries": covered},
        )
        # NOTE: parsed by the benchmark LogParser (+ AGG section).
        log.info(
            "Agg fallback round %s: %s entries to %s peers",
            key[1],
            covered,
            len(peers),
        )
        bundle = self._bundle(key)
        if bundle is None:
            return
        for peer in peers:
            await self.core._transmit(bundle, peer, urgent=key[0] == KIND_TIMEOUT)

    def note_received(self) -> None:
        _M_BUNDLES_RECEIVED.inc()

    # -- lifecycle -----------------------------------------------------------

    def cleanup(self, round_: Round) -> None:
        """Drop merge state and trees for rounds below `round_` (called
        beside Aggregator.cleanup on every round advance)."""
        for key in [k for k in self._state if k[1] < round_]:
            self._state.pop(key).cancel()
        for key in [k for k in self._trees if k[0] < round_ - 1]:
            del self._trees[key]


def bundle_entries(bundle) -> tuple:
    """The entry tuple of either bundle kind (votes or timeouts)."""
    return bundle.votes if isinstance(bundle, VoteBundle) else bundle.timeouts


def bundle_weight(bundle) -> int:
    """Members a bundle speaks for: entry count for legacy bundles,
    bitmap popcount for aggregate partials."""
    if isinstance(bundle, (AggVoteBundle, AggTimeoutBundle)):
        return bundle.signers()
    return len(bundle_entries(bundle))


def filter_backed(entries, backed_round: Round) -> tuple[list, int]:
    """Timeout entries whose high_qc_round CLAIM is backed by the
    bundle's carried QC: claim <= the verified carried QC's round
    (genesis claims, hqr 0, are self-backing). Returns (accepted,
    rejected_count).

    This is the bundle-path equivalent of what the legacy Timeout plane
    gets for free: `Timeout.verify` binds the signed hqr to the carried
    high_qc AND verifies that QC, so a TC's `high_qc_rounds()` only ever
    names rounds a real QC exists for. A bundle carries ONE best QC for
    many entries, so the binding must be explicit — otherwise a staked
    Byzantine author could sign an entry with an absurd hqr, and any TC
    including it would fail every future proposal's justification check
    (`block.qc.round >= max(tc.high_qc_rounds())`): permanent liveness
    loss. Honest bundles always pass: the merge keeps the MAX-round
    carried QC, so every honestly merged entry's claim stays covered."""
    ok = [e for e in entries if e[2] <= backed_round]
    return ok, len(entries) - len(ok)
