"""Admission control for the client ingress: fee lanes, bounded queues
with explicit shedding, and retry-after backpressure hints.

A copy of `hotstuff_tpu/ingress/admission.py` for the port (`LaneSpec`,
`IngressConfig`, `AdmissionController`; the same lanes, replay window,
metrics and retry-after arithmetic):

  * **Reject-newest with a signal.** An overloaded lane rejects the new
    arrival as SHED with a retry-after hint, so an accepted transaction
    is really in the pipeline and the arrival rate stays controllable.
  * **Fee-selected lanes, strict-priority drain.** A transaction's signed
    `fee` maps it to the highest lane whose `min_fee` it clears; the
    pipeline drains lanes in priority order, and each lane's queue is
    bounded on its own.
  * **Replay filter before signature work.** A duplicate (client, nonce)
    is rejected from a bounded recently-seen set before verification; a
    nonce whose signature fails is released again (`forget`).

Retry-after derives from the observed drain: an EWMA of the drain rate,
and the time the rejected lane's depth needs to half-drain at that rate,
clamped to [RETRY_MIN_MS, RETRY_MAX_MS]. It reads only the event-loop
time its caller passes in.

`IngressConfig.verify_interval` paces the drain for the chaos scenarios
(`pipeline.py`).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ..utils import metrics
from . import messages
from .messages import ClientTransaction

_M_SHED = metrics.counter("ingress.shed")
_M_REPLAYS = metrics.counter("ingress.replays")
_M_MALFORMED = metrics.counter("ingress.malformed")
_M_ADMITTED = metrics.counter("ingress.admitted")
_M_LANE_DEPTH = metrics.gauge("ingress.lane_depth")
_M_RETRY_AFTER = metrics.histogram("ingress.retry_after_ms", metrics.SIZE_BUCKETS)

RETRY_MIN_MS = 50
RETRY_MAX_MS = 5_000


@dataclass(frozen=True, slots=True)
class LaneSpec:
    """One admission lane: transactions with fee >= min_fee ride it
    (highest-min_fee lane wins), up to `capacity` queued."""

    name: str
    min_fee: int
    capacity: int


@dataclass(slots=True)
class IngressConfig:
    # Highest-priority first; the last lane should have min_fee=0 so every
    # fee maps somewhere (fees below every floor reject as MALFORMED).
    lanes: tuple[LaneSpec, ...] = (
        LaneSpec("priority", min_fee=1_000, capacity=512),
        LaneSpec("standard", min_fee=1, capacity=2_048),
        LaneSpec("bulk", min_fee=0, capacity=8_192),
    )
    max_tx_bytes: int = 64 * 1024  # per-tx body cap (one frame, never a payload)
    replay_window: int = 65_536  # recently-seen (client, nonce) pairs kept
    verify_batch: int = 64  # txs per verification group
    # Seconds to pause between verification batches: a deliberate drain
    # pacer modelling finite verify capacity (batch/interval tx/s). 0 =
    # backend-bound (the card's path); the chaos scenarios set it so
    # overload, and so shedding, is reachable under a virtual clock where
    # Python work costs no virtual time.
    verify_interval: float = 0.0


@dataclass(slots=True)
class _Lane:
    spec: LaneSpec
    queue: deque = field(default_factory=deque)


class AdmissionController:
    """Stateful admission decisions; owned by one IngressPipeline.

    `admit()` either returns the lane index the transaction was queued
    into, or an (status, retry_after_ms) rejection. The pipeline pops
    admitted transactions via `take()` in strict priority order and
    reports drain progress via `note_drained()`.
    """

    def __init__(self, config: IngressConfig | None = None) -> None:
        self.config = config or IngressConfig()
        if not self.config.lanes or self.config.lanes[-1].min_fee != 0:
            raise ValueError("the last ingress lane must have min_fee=0")
        self.lanes = [_Lane(spec) for spec in self.config.lanes]
        self._seen: OrderedDict[tuple[bytes, int], None] = OrderedDict()
        # Drain-rate EWMA (txs/sec): seeded pessimistically low so the
        # first overload quotes a conservative (long) retry-after rather
        # than an optimistic one computed from zero observations.
        self._drain_rate = 0.0
        self._last_drain_t: float | None = None
        self.shed = 0

    # -- admission -----------------------------------------------------------

    def lane_for(self, fee: int) -> int | None:
        for i, lane in enumerate(self.lanes):
            if fee >= lane.spec.min_fee:
                return i
        return None

    def depth(self) -> int:
        return sum(len(lane.queue) for lane in self.lanes)

    def admit(self, tx: ClientTransaction, entry) -> tuple[int | None, int, int]:
        """Admit `tx` (queueing `entry`, the pipeline's (tx, t0, future)
        record) or reject it. Returns (lane index | None, status,
        retry_after_ms); lane is None exactly when rejected."""
        if len(tx.body) > self.config.max_tx_bytes or not tx.body:
            _M_MALFORMED.inc()
            return None, messages.MALFORMED, 0
        lane_idx = self.lane_for(tx.fee)
        if lane_idx is None:
            _M_MALFORMED.inc()
            return None, messages.MALFORMED, 0
        # Recorded at ADMISSION (not after verification) so an in-flight
        # duplicate is caught cheaply — but a nonce whose signature later
        # fails is released again via forget(): otherwise anyone knowing a
        # victim's public key could burn the victim's nonces forever with
        # garbage-signature submissions (zero crypto cost to the attacker,
        # since this filter runs before verification).
        key = (tx.client.data, tx.nonce)
        if key in self._seen:
            _M_REPLAYS.inc()
            return None, messages.REPLAY, 0
        lane = self.lanes[lane_idx]
        if len(lane.queue) >= lane.spec.capacity:
            self.shed += 1
            _M_SHED.inc()
            retry = self._retry_after_ms(lane)
            _M_RETRY_AFTER.record(retry)
            return None, messages.SHED, retry
        self._seen[key] = None
        while len(self._seen) > self.config.replay_window:
            self._seen.popitem(last=False)
        lane.queue.append(entry)
        _M_ADMITTED.inc()
        _M_LANE_DEPTH.set(self.depth())
        return lane_idx, messages.ACCEPTED, 0

    def forget(self, tx: ClientTransaction) -> None:
        """Release a (client, nonce) whose signature FAILED verification:
        only a verified transaction consumes its nonce, so a forged
        submission under someone else's key cannot squat the real
        client's nonce beyond its own in-flight window."""
        self._seen.pop((tx.client.data, tx.nonce), None)

    # -- drain side (pipeline) ----------------------------------------------

    def take(self, limit: int) -> list:
        """Pop up to `limit` queued entries in strict priority order
        (priority lane first; bulk starves under sustained overload —
        that is the lane contract, not a bug)."""
        out: list = []
        for lane in self.lanes:
            while lane.queue and len(out) < limit:
                out.append(lane.queue.popleft())
            if len(out) >= limit:
                break
        if out:
            _M_LANE_DEPTH.set(self.depth())
        return out

    def note_drained(self, n: int, now: float) -> None:
        """EWMA drain-rate update, fed by the pipeline after each verified
        batch; `now` is event-loop time (virtual under chaos)."""
        if self._last_drain_t is not None:
            dt = now - self._last_drain_t
            if dt > 0:
                inst = n / dt
                self._drain_rate = (
                    inst
                    if self._drain_rate == 0.0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
        self._last_drain_t = now

    def _retry_after_ms(self, lane: _Lane) -> int:
        """Time for the rejected lane's backlog to half-drain at the
        observed rate — long enough that an obedient client's retry has a
        real chance, short enough to keep goodput once pressure lifts."""
        if self._drain_rate <= 0.0:
            return RETRY_MAX_MS
        ms = int(1000.0 * (len(lane.queue) / 2.0) / self._drain_rate)
        return max(RETRY_MIN_MS, min(RETRY_MAX_MS, ms))
