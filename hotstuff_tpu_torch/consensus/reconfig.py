"""Dynamic validator reconfiguration: signed epoch changes, the
epoch-commit rule, the EPOCH-FINAL HANDOFF, and per-round committee
resolution.

The operator set is no longer frozen at genesis (ROADMAP item 5). A
committee change travels THROUGH the chain as a signed `EpochChange`
carried by a proposal, and follows the epoch-commit rule of
deterministic-finality designs (PAPERS.md, arXiv:2512.09409): the new
committee takes effect only once the block carrying the change is
2-chain COMMITTED, and then only from the change's declared
`activation_round` onward. That gives every honest node the identical
round -> committee mapping (it is a pure function of committed chain
content), which is exactly what lets QC/TC quorums be verified against
the committee of the certificate's OWN epoch on both sides of a
boundary.

THE EPOCH-FINAL HANDOFF (COMPONENTS.md §5.5j). The carrying block is an
epoch-final position: the old committee certifies THROUGH the declared
boundary minus one and owns nothing at or past it. Without it there
was a named hazard — a 2-chain commit delayed past the declared activation meant
rounds in the gap [activation, commit] had already been certified by the
OLD committee but were re-judged by the new one once the late apply
landed (`reconfig.late_applies`, then only a warning). The handoff makes
that impossible BY CONSTRUCTION rather than merely observable:

  * every honest node that PROCESSES a carrier records the change as a
    PENDING HANDOFF (`note_pending`, persisted with the epoch state so a
    crash at the boundary cannot forget it);
  * while a next-epoch handoff is pending, the node refuses to vote for
    or propose blocks at rounds >= the declared activation round — the
    certification WALL (`handoff_blocks`, enforced in Core._make_vote /
    _generate_proposal, counted in `reconfig.handoff_holds`). A carrier
    that got CERTIFIED was voted by >= quorum nodes, so >= f+1 honest
    nodes hold the wall and no old-committee quorum can form in the gap;
  * the commit therefore completes strictly below the boundary (the
    chain stalls at activation-1 until it does — Core._try_handoff_commit
    unwedges the one edge where the completing QC can no longer ride a
    block), and `reconfig.late_applies` is now a HARD invariant: the
    chaos SafetyChecker derives the same epoch-final schedule from chain
    content alone and flags any chain where a carrier was not
    2-chain-final before its activation round;
  * a pending whose carrier fork DIES (the chain commits past the
    carrier round without it) is dropped (`note_commit`,
    `reconfig.handoff_abandoned`) so a never-committed change cannot
    wall liveness forever.

Pieces:

  * `EpochChange` — the wire payload: target epoch, activation round,
    the full successor member list (key, stake, consensus address,
    MEMPOOL address — the payload plane crosses the boundary with the
    same change), signed by a current-epoch authority over a
    domain-separated digest. The block digest commits to it (see
    `Block.make_digest`), so a relay cannot strip or alter the change
    without invalidating the proposal.
  * `EpochSchedule` — the pure round -> committee map: an ordered list
    of (activation_round, committee) entries. Also used standalone by
    the chaos SafetyChecker, which re-derives its OWN schedule from the
    committed chain so invariant checking never trusts a node's state.
  * `EpochManager` — a node's live view: schedule + pending handoffs +
    validation of proposed changes (epoch sequencing, activation
    margin), apply-on-commit with store persistence (a restarted node
    must rebuild the same mapping AND the same wall), current-committee
    resolution for transmit paths, the per-epoch mempool address
    registry the MempoolEpochView resolves through, and the device-side
    hook: at a switch the active crypto backend's committee table is
    re-registered (`register_committee`), whose snapshot-pinned tables
    let in-flight chunks finish on the OLD epoch (ops/ed25519
    CommitteeTable, COMPONENTS.md §5.5c).

Liveness note: `activation_round` must trail the carrying block by at
least `MIN_ACTIVATION_MARGIN` rounds so the 2-chain commit lands before
the boundary under normal operation. Under the wall a margin violation
costs LIVENESS at the boundary (rounds stall at activation-1 until the
commit completes via sync), never safety — the explicit trade the
epoch-final contract makes.

The port's copy of `hotstuff_tpu/consensus/reconfig.py`, its imports rewritten to this
package.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..crypto import Digest, PublicKey, Signature, sha512_32
from ..network.net import Address
from ..utils import metrics, tracing
from ..utils.serde import Reader, SerdeError, Writer
from .config import Committee
from .errors import ReconfigError, ensure

log = logging.getLogger("hotstuff.consensus")

Round = int

# A proposed change must place its boundary at least this many rounds
# past the carrying block, so the 2-chain commit normally lands first.
MIN_ACTIVATION_MARGIN = 3

# Decode cap on successor members: an EpochChange rides unauthenticated
# proposal frames, and a receiver must not materialize an unbounded
# member list (each entry costs a key + stake + two addresses).
MAX_WIRE_MEMBERS = 4_096

_STORE_KEY = b"epoch-state"

_M_SWITCHES = metrics.counter("reconfig.epoch_switches")
_M_REJECTED = metrics.counter("reconfig.rejected")
_M_LATE_APPLIES = metrics.counter("reconfig.late_applies")
_M_EPOCH = metrics.gauge("reconfig.epoch")
_M_HANDOFF_HOLDS = metrics.counter("reconfig.handoff_holds")
_M_HANDOFF_ABANDONED = metrics.counter("reconfig.handoff_abandoned")
# Rounds the commit trigger landed past the LAST old-committee round
# (activation-1): 0 on every healthy handoff, >=1 exactly when the
# epoch-final contract was violated — the telemetry SLO row keys on it.
_M_HANDOFF_LAG = metrics.histogram(
    "reconfig.handoff_lag_rounds", (0.5, 2.0, 8.0, 32.0)
)

# (key, stake, consensus address, mempool address). The mempool address
# is what makes the payload plane's succession possible: a joiner's
# payloads are fetchable only once peers can resolve its mempool port,
# and that fact must travel in the SAME chain content as the committee
# change (a side channel could desynchronize the two planes).
Member = tuple[PublicKey, int, Address, Address]


def _normalize_members(members: Sequence) -> tuple[Member, ...]:
    """Accept (key, stake, address) triples for single-plane callers and
    tests — the mempool address then mirrors the consensus address —
    while the wire format always carries the full 4-tuple."""
    out: list[Member] = []
    for m in members:
        if len(m) == 3:
            pk, stake, addr = m
            out.append((pk, stake, addr, addr))
        else:
            pk, stake, addr, maddr = m
            out.append((pk, stake, addr, maddr))
    return tuple(out)


@dataclass(frozen=True, slots=True)
class EpochChange:
    """Signed committee-succession payload carried by a Block.

    `members` is the FULL successor set (join = new key present, leave =
    old key absent); stake and both plane addresses ride along so quorum
    thresholds, broadcast fan-out AND payload-gossip fan-out recompute
    from the change alone. Signed by a current-epoch authority over a
    domain-separated digest."""

    new_epoch: int
    activation_round: Round
    members: tuple[Member, ...]
    author: PublicKey
    signature: Signature

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "members", _normalize_members(self.members)
        )

    def digest(self) -> Digest:
        h = b"HSEPOCH" + _member_bytes(self.new_epoch, self.activation_round, self.members)
        return Digest(sha512_32(h + self.author.data))

    def committee(self) -> Committee:
        """The successor CONSENSUS committee (quorum threshold recomputes
        from the member stakes via Committee.quorum_threshold)."""
        return Committee.new(
            [(pk, stake, addr) for pk, stake, addr, _maddr in self.members],
            epoch=self.new_epoch,
        )

    def mempool_addresses(self) -> dict[PublicKey, Address]:
        """The successor's payload-plane ports (MempoolEpochView feed)."""
        return {pk: maddr for pk, _stake, _addr, maddr in self.members}

    @staticmethod
    def new_from_seed(
        new_epoch: int,
        activation_round: Round,
        members: Sequence,
        author: PublicKey,
        seed: bytes,
    ) -> "EpochChange":
        """Construct + sign with a raw ed25519 seed (pysigner — the
        dependency-free path chaos and tests use)."""
        from ..crypto import pysigner

        change = EpochChange(
            new_epoch, activation_round, tuple(members), author, Signature(bytes(64))
        )
        sig = Signature(pysigner.sign(seed, change.digest().data))
        return EpochChange(new_epoch, activation_round, change.members, author, sig)

    def encode(self, w: Writer) -> None:
        w.u64(self.new_epoch)
        w.u64(self.activation_round)
        w.seq(
            list(self.members),
            lambda wr, m: (
                wr.fixed(m[0].data, 32),
                wr.u64(m[1]),
                wr.var_bytes(m[2][0].encode()),
                wr.u32(m[2][1]),
                wr.var_bytes(m[3][0].encode()),
                wr.u32(m[3][1]),
            ),
        )
        w.fixed(self.author.data, 32)
        w.fixed(self.signature.data, 64)

    @staticmethod
    def decode(r: Reader) -> "EpochChange":
        new_epoch = r.u64()
        activation_round = r.u64()
        # Cap checked on the COUNT, before materializing a single member:
        # an unauthenticated proposal frame must not make the receiver
        # allocate an oversized member list only to throw it away.
        count = r.u32()
        if count > MAX_WIRE_MEMBERS:
            raise SerdeError(f"epoch change over member cap: {count}")
        members = tuple(
            (
                PublicKey(r.fixed(32)),
                r.u64(),
                (r.var_bytes().decode(), r.u32()),
                (r.var_bytes().decode(), r.u32()),
            )
            for _ in range(count)
        )
        return EpochChange(
            new_epoch,
            activation_round,
            members,
            PublicKey(r.fixed(32)),
            Signature(r.fixed(64)),
        )

    def __str__(self) -> str:
        return (
            f"EpochChange(epoch {self.new_epoch} @ round "
            f"{self.activation_round}, {len(self.members)} validators)"
        )


def _member_bytes(epoch: int, activation: Round, members: tuple[Member, ...]) -> bytes:
    w = Writer()
    w.u64(epoch)
    w.u64(activation)
    for pk, stake, addr, maddr in members:
        w.fixed(pk.data, 32)
        w.u64(stake)
        w.var_bytes(f"{addr[0]}:{addr[1]}".encode())
        w.var_bytes(f"{maddr[0]}:{maddr[1]}".encode())
    return w.bytes()


class EpochSchedule:
    """Pure round -> committee map: ordered (activation_round, committee)
    entries, genesis at round 0. Appending is idempotent per epoch and
    strictly sequenced (epoch e+1 only extends epoch e)."""

    __slots__ = ("_entries",)

    def __init__(self, genesis: Committee) -> None:
        # (activation_round, committee, sorted keys) — keys cached: the
        # leader elector resolves every round through this list.
        self._entries: list[tuple[Round, Committee, list[PublicKey]]] = [
            (0, genesis, genesis.sorted_keys())
        ]

    @property
    def latest(self) -> Committee:
        return self._entries[-1][1]

    @property
    def latest_epoch(self) -> int:
        return self._entries[-1][1].epoch

    def entries(self) -> list[tuple[Round, Committee]]:
        return [(r, c) for r, c, _ in self._entries]

    def committee_for_round(self, round_: Round) -> Committee:
        for activation, committee, _keys in reversed(self._entries):
            if round_ >= activation:
                return committee
        return self._entries[0][1]

    def sorted_keys_for_round(self, round_: Round) -> list[PublicKey]:
        for activation, _committee, keys in reversed(self._entries):
            if round_ >= activation:
                return keys
        return self._entries[0][2]

    def epoch_for_round(self, round_: Round) -> int:
        return self.committee_for_round(round_).epoch

    def apply(self, activation_round: Round, committee: Committee) -> bool:
        """Append a boundary; False when already applied (idempotent) or
        out of sequence (an epoch may only succeed its predecessor)."""
        if committee.epoch != self.latest_epoch + 1:
            return False
        if activation_round <= self._entries[-1][0]:
            return False
        self._entries.append(
            (activation_round, committee, committee.sorted_keys())
        )
        return True


def as_manager(committee) -> "EpochManager":
    """Accept a Committee or an EpochManager wherever consensus components
    take one: a bare Committee wraps into a static single-epoch manager
    (the pre-reconfig behaviour, and what most unit tests pass)."""
    if isinstance(committee, EpochManager):
        return committee
    return EpochManager(committee)


@dataclass(slots=True)
class _PendingHandoff:
    """One admitted-but-uncommitted EpochChange: the wall's unit of
    state. `carriers` is the set of block rounds observed carrying this
    change (one change can ride several leaders' proposals); the pending
    dies only when the committed chain passes EVERY carrier without the
    change applying — that fork lost, the boundary is void."""

    change: EpochChange
    carriers: set = field(default_factory=set)


class EpochManager:
    """A node's live epoch view: schedule + pending handoffs +
    validation + apply-on-commit.

    One instance is shared by the Core, LeaderElector, Aggregator and
    Synchronizer of a node (consensus/consensus.py wires it) AND by the
    mempool plane's MempoolEpochView (mempool/config.py), so a committed
    epoch change atomically moves leader rotation, quorum accounting,
    broadcast fan-out and payload-gossip fan-out to the successor
    committee at the same activation boundary."""

    def __init__(
        self,
        genesis: Committee,
        on_switch: Callable[[Committee, Round], None] | None = None,
        register_backend: bool = True,
    ) -> None:
        self.schedule = EpochSchedule(genesis)
        self._on_switch = [on_switch] if on_switch is not None else []
        self._register_backend = register_backend
        self._round_hint: Round = 1  # newest round the core has reached
        # Pending epoch-final handoffs, keyed by change digest bytes.
        self._pending: dict[bytes, _PendingHandoff] = {}
        # Payload-plane address registry: genesis entries seeded by the
        # MempoolEpochView, successors learned from applied EpochChanges
        # (and persisted with the epoch state). Addresses accumulate —
        # a DEPARTED member stays resolvable so its stored payloads can
        # still be fetched for old blocks.
        self._mempool_addrs: dict[PublicKey, Address] = {}

    # -- resolution ---------------------------------------------------------

    @property
    def applied_epoch(self) -> int:
        return self.schedule.latest_epoch

    def committee_for_round(self, round_: Round) -> Committee:
        return self.schedule.committee_for_round(round_)

    def epoch_for_round(self, round_: Round) -> int:
        return self.schedule.epoch_for_round(round_)

    def current(self) -> Committee:
        """The committee governing the newest round the core reported
        (note_round) — what transmit paths broadcast against."""
        return self.schedule.committee_for_round(self._round_hint)

    def note_round(self, round_: Round) -> None:
        if round_ > self._round_hint:
            self._round_hint = round_

    def address(self, name: PublicKey) -> Address | None:
        """Resolve an authority address across every known epoch, newest
        first — a boundary-round reply may target a peer that is only in
        the adjacent epoch's committee."""
        for _activation, committee in reversed(self.schedule.entries()):
            addr = committee.address(name)
            if addr is not None:
                return addr
        return None

    def on_switch(self, hook: Callable[[Committee, Round], None]) -> None:
        self._on_switch.append(hook)

    # -- payload-plane address registry -------------------------------------

    def seed_mempool_addresses(self, addrs: dict[PublicKey, Address]) -> None:
        """Install genesis payload-plane ports (MempoolEpochView calls
        this once at wiring time); applied EpochChanges extend the map."""
        for pk, addr in addrs.items():
            self._mempool_addrs.setdefault(pk, addr)

    def mempool_address(self, name: PublicKey) -> Address | None:
        return self._mempool_addrs.get(name)

    # -- epoch-final handoff (the wall) --------------------------------------

    def handoff_boundary(self) -> Round | None:
        """The earliest declared activation round among pending NEXT-epoch
        changes, or None when no handoff is in flight. Rounds at or past
        it are walled until the carrier commits."""
        best: Round | None = None
        nxt = self.applied_epoch + 1
        for p in self._pending.values():
            if p.change.new_epoch == nxt and (
                best is None or p.change.activation_round < best
            ):
                best = p.change.activation_round
        return best

    def handoff_pending(self) -> bool:
        nxt = self.applied_epoch + 1
        return any(p.change.new_epoch == nxt for p in self._pending.values())

    def handoff_blocks(self, round_: Round) -> bool:
        """True when the certification wall covers `round_`: a pending
        handoff declared its boundary at or below it, so this node must
        not help certify the round until the carrier commits."""
        boundary = self.handoff_boundary()
        return boundary is not None and round_ >= boundary

    async def note_pending(
        self, change: EpochChange, carrier_round: Round, store=None
    ) -> bool:
        """Record an admitted carrier (called from the proposal path once
        `validate` passed). Idempotent per (change, carrier round).
        Persisted so a node crashing between admission and commit wakes
        up with the wall intact — the boundary-crash scenarios pin it."""
        if change.new_epoch <= self.applied_epoch:
            return False
        key = change.digest().data
        entry = self._pending.get(key)
        if entry is None:
            entry = self._pending[key] = _PendingHandoff(change)
        if carrier_round in entry.carriers:
            return False
        entry.carriers.add(carrier_round)
        log.info(
            "Epoch handoff pending: %s carried by B%s (wall at round %s)",
            change,
            carrier_round,
            change.activation_round,
        )
        if store is not None:
            await self.save(store)
        return True

    def note_hold(self, round_: Round, kind: str) -> None:
        """Account one walled certification act (vote or proposal)."""
        _M_HANDOFF_HOLDS.inc()
        log.warning(
            "epoch handoff wall: withholding %s at round %s (boundary %s "
            "awaits the carrier's commit)",
            kind,
            round_,
            self.handoff_boundary(),
        )

    async def note_commit(self, committed_round: Round, store=None) -> None:
        """Drop pendings whose every observed carrier the committed chain
        has passed WITHOUT applying: commits walk ancestors, so a carrier
        at or below the committed floor that did not apply is not in the
        committed chain — a dead fork whose boundary must not wall
        liveness. Applied changes were already cleared by `apply`."""
        dropped = False
        for key, p in list(self._pending.items()):
            if p.change.new_epoch <= self.applied_epoch:
                del self._pending[key]
                dropped = True
                continue
            if p.carriers and all(r <= committed_round for r in p.carriers):
                del self._pending[key]
                dropped = True
                _M_HANDOFF_ABANDONED.inc()
                log.info(
                    "Epoch handoff abandoned: %s — the chain committed past "
                    "every carrier without it (fork died)",
                    p.change,
                )
        if dropped and store is not None:
            await self.save(store)

    # -- validation (proposal ingress) --------------------------------------

    def validate(self, change: EpochChange, block_round: Round) -> None:
        """Structural admission for an EpochChange riding a round-
        `block_round` proposal; raises ReconfigError. The author's
        signature is checked separately in Block.verify_async (it rides
        the block's batched service group)."""
        try:
            ensure(
                change.new_epoch == self.epoch_for_round(block_round) + 1,
                ReconfigError(
                    f"epoch change to {change.new_epoch} out of sequence "
                    f"(round {block_round} is epoch "
                    f"{self.epoch_for_round(block_round)})"
                ),
            )
            ensure(
                change.activation_round >= block_round + MIN_ACTIVATION_MARGIN,
                ReconfigError(
                    f"activation round {change.activation_round} inside the "
                    f"commit margin of round {block_round}"
                ),
            )
            ensure(
                len(change.members) > 0,
                ReconfigError("epoch change with an empty committee"),
            )
            ensure(
                len(change.members) <= MAX_WIRE_MEMBERS,
                ReconfigError(
                    f"epoch change with {len(change.members)} members "
                    f"(cap {MAX_WIRE_MEMBERS})"
                ),
            )
            committee = change.committee()
            ensure(
                committee.total_votes() > 0,
                ReconfigError("epoch change with zero total stake"),
            )
        except ReconfigError:
            _M_REJECTED.inc()
            raise

    # -- apply-on-commit -----------------------------------------------------

    async def apply(
        self, change: EpochChange, store=None, trigger_round: Round | None = None
    ) -> bool:
        """Epoch-commit rule: called only once the carrying block is
        2-chain committed. Idempotent (a change committed in two blocks,
        or re-applied from persistence, is a no-op the second time).

        The boundary is ALWAYS the DECLARED activation round — pure
        chain content, so every node (live, restarting, or replaying a
        range-synced chain) derives the identical round -> committee
        map. The block that locally completes the carrier's 2-chain is
        deliberately NOT folded in: two nodes can first see different
        QC-carrying envelopes (one of which may never certify), so any
        trigger-derived boundary would diverge across honest nodes — a
        schedule split, the one thing the epoch-commit rule exists to
        prevent.

        Under the epoch-final handoff the commit CANNOT land past the
        boundary on an honest chain: the wall (handoff_blocks) keeps the
        old committee from certifying gap rounds, so `trigger_round >=
        activation_round` — once a counted-but-tolerated margin
        pathology — is now a hard invariant violation (it requires a
        Byzantine quorum or a broken wall), logged at error level,
        counted in `reconfig.late_applies`, and escalated through the
        AnomalyWatchdog (`handoff_violation` auto-dump). The chaos
        SafetyChecker derives the same contract independently from chain
        content."""
        committee = change.committee()
        if not self.schedule.apply(change.activation_round, committee):
            return False
        self._pending.pop(change.digest().data, None)
        self._mempool_addrs.update(change.mempool_addresses())
        if trigger_round is not None:
            lag = max(0, trigger_round - (change.activation_round - 1))
            _M_HANDOFF_LAG.record(float(lag))
            if lag > 0:
                _M_LATE_APPLIES.inc()
                # WARNING level (not ERROR): the benchmark LogParser
                # treats ERROR lines as a crashed run and aborts parsing;
                # the severity escalation rides the watchdog trigger +
                # the scraped "VIOLATION" marker instead.
                log.warning(
                    "Epoch handoff VIOLATION: epoch %s commit landed at "
                    "round %s, at/past the declared activation round %s — "
                    "gap rounds were certified by the old committee (the "
                    "epoch-final wall should have made this impossible)",
                    committee.epoch,
                    trigger_round,
                    change.activation_round,
                )
                tracing.WATCHDOG.note_handoff_violation(
                    committee.epoch, change.activation_round, trigger_round
                )
            else:
                # NOTE: parsed by the benchmark LogParser (+ RECONFIG:).
                log.info(
                    "Epoch handoff to %s committed at round %s (boundary "
                    "%s, slack %s rounds)",
                    committee.epoch,
                    trigger_round,
                    change.activation_round,
                    change.activation_round - trigger_round,
                )
        self._switched(committee, change.activation_round)
        if store is not None:
            await self.save(store)
        return True

    def _switched(self, committee: Committee, activation_round: Round) -> None:
        _M_SWITCHES.inc()
        _M_EPOCH.set(committee.epoch)
        # NOTE: this log entry is parsed by the benchmark LogParser.
        log.info(
            "Epoch switch to %s at activation round %s (%s validators, quorum %s)",
            committee.epoch,
            activation_round,
            committee.size(),
            committee.quorum_threshold(),
        )
        self._reregister(committee)
        for hook in self._on_switch:
            hook(committee, activation_round)

    def _reregister(self, committee: Committee) -> None:
        """Device-side committee succession: swap the backend's resident
        key tables to the new epoch. TorchBackend registration is snapshot-
        pinned (ops/ed25519.CommitteeTable): batches staged against the
        old table finish on the OLD epoch's replicas while new traffic
        resolves against the new indices — no flush barrier needed."""
        if not self._register_backend:
            return
        from ..crypto import get_backend

        backend = get_backend()
        if hasattr(backend, "register_committee"):
            try:
                backend.register_committee(committee.sorted_keys())
            except Exception as e:  # registration is an optimization only
                log.warning("epoch committee re-registration failed: %r", e)

    # -- persistence ---------------------------------------------------------

    async def save(self, store) -> None:
        """Persist applied boundaries AND pending handoffs. The pending
        half is what survives a crash landing exactly at the activation
        boundary: the restarted node must wake with the wall intact, or
        it could certify gap rounds its crashed incarnation refused."""
        entries = []
        for r, c in self.schedule.entries()[1:]:  # genesis comes from config
            entry = {"activation_round": r, "committee": c.to_json()}
            maddrs = {
                pk.encode_base64(): f"{a[0]}:{a[1]}"
                for pk in c.sorted_keys()
                for a in (self._mempool_addrs.get(pk),)
                if a is not None
            }
            if maddrs:
                entry["mempool_addresses"] = maddrs
            entries.append(entry)
        pending = [
            {
                "change": _encode_change_hex(p.change),
                "carriers": sorted(p.carriers),
            }
            for _key, p in sorted(self._pending.items())
        ]
        state = {"entries": entries, "pending": pending}
        await store.write(_STORE_KEY, json.dumps(state).encode())

    async def load(self, store) -> None:
        """Rebuild applied boundaries and pending handoffs after a
        restart (idempotent). The switch hooks re-fire so the backend
        tables match the persisted epoch before the node rejoins; the
        restored pendings re-arm the certification wall, so a node that
        crashed mid-handoff can never re-judge (or help re-certify) gap
        rounds its pre-crash incarnation walled off."""
        raw = await store.read(_STORE_KEY)
        if raw is None:
            return
        state = json.loads(raw.decode())
        if isinstance(state, list):  # pre-handoff format: entries only
            entries, pending = state, []
        else:
            entries = state.get("entries", [])
            pending = state.get("pending", [])
        for entry in entries:
            committee = Committee.from_json(entry["committee"])
            if self.schedule.apply(entry["activation_round"], committee):
                for pk_b64, addr in entry.get("mempool_addresses", {}).items():
                    host, port = addr.rsplit(":", 1)
                    self._mempool_addrs[PublicKey.decode_base64(pk_b64)] = (
                        host,
                        int(port),
                    )
                self._switched(committee, entry["activation_round"])
        for p in pending:
            change = _decode_change_hex(p["change"])
            if change.new_epoch <= self.applied_epoch:
                continue
            entry = self._pending.setdefault(
                change.digest().data, _PendingHandoff(change)
            )
            entry.carriers.update(p["carriers"])


def _encode_change_hex(change: EpochChange) -> str:
    w = Writer()
    change.encode(w)
    return w.bytes().hex()


def _decode_change_hex(data: str) -> EpochChange:
    return EpochChange.decode(Reader(bytes.fromhex(data)))
