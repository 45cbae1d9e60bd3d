"""BatchVerificationService: the verification facade over the device
scheduler.

A copy of `hotstuff_tpu/crypto/batch_service.py` for the port. Callers
submit groups of (message, key, signature) triples (one QC's votes, one
payload batch, one wire request, one ingress batch), declare their source
class (`source=`, or the `urgent` bit; `crypto/scheduler.py`) and await a
per-item validity mask. Batching policy lives in `DeviceScheduler`; this
class is the dispatch executor: the verified-signature cache, committee
tagging, the backend call in a worker thread (`asyncio.to_thread`, so a
dispatch never blocks the event loop) and future resolution.

Committee tagging follows the reference exactly: a flush passes
`committee=True` to the backend only when every group in it was submitted
with `committee=True` and the backend supports committee routing. The
sidecar's wire carries no committee tag, so its flushes never take the
committee kernels.

Per group, as in the reference: `dedup=False` keeps the group's triples
out of the verified-signature cache (ingress traffic, synthetic bench
load), and `trace=` records a flight-recorder `verify.batch` event for
the group in each flush that reaches the backend (`utils/tracing.py`).

`use_scheduler=False` runs the reference's legacy single-queue flush
loop (`_run_legacy`) instead of the scheduler, the baseline of the
bench's `--scheduler-ab`: a flush closes at `max_batch`, at an urgent
group, or `LEGACY_MAX_DELAY_S` (2 ms) after its first group; urgent
groups dispatch in a flush of their own, and at most
`MAX_CONCURRENT_DISPATCHES` (4) non-urgent flushes run at once. Both
values are the reference's defaults.

The node's consensus and mempool also call `verify` (one triple),
`seed_verified` (the aggregator records a vote it checked, so the QC
built from it verifies nothing twice) and read `backend` (the active
`CryptoBackend` of `backend.get_backend` when none was given, as in the
reference) and `lane_stats`.

Cross-backend work stealing, as in the reference: `steal_backends` are
sibling backends that a bulk bucket goes to when the home backend's
`BULK_CONCURRENCY` slots are all in flight (`crypto/scheduler.py`,
`pipeline.steals`). Critical dispatches and every flush of the legacy loop
stay on the home backend. The reference widens its service-wide bound on
concurrent dispatches to cover every backend's slots; the port's scheduler
path has no such bound, so the scheduler's per-backend accounting is the
only bound.

`inline=True` is the chaos plane's virtual-time mode, as in the reference:
the backend call runs on the event loop instead of a worker thread (thread
scheduling is the one nondeterminism a virtual-time replay cannot
control), and stealing is forced off, so which backend a bucket lands on
never depends on thread timing. `scheduler_config` passes the scheduler's
knobs (`SchedulerConfig`: the chaos plane's `pace_s_per_sig`). The card's
path keeps the defaults: a worker thread and no pacing.

With tracing on, each flush that reaches the backend feeds the anomaly
watchdog one sample of its per-signature cost
(`tracing.WATCHDOG.note_verify`), as the reference's does.

Not ported: a cache size other than the reference's default (65,536
triples).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

from ..utils import metrics, tracing
from ..utils.actors import spawn
from .backend import CryptoBackend, get_backend
from .primitives import PublicKey, Signature
from .scheduler import DeviceScheduler, LaneStats, SchedulerConfig, note_queue_delay, resolve_source

log = logging.getLogger("hotstuff.crypto")

_M_DEDUP_HITS = metrics.counter("verifier.dedup_hits")
_M_DEDUP_MISSES = metrics.counter("verifier.dedup_misses")
_M_DEDUP_INSERTS = metrics.counter("verifier.dedup_inserts")
_M_DEDUP_EVICTIONS = metrics.counter("verifier.dedup_evictions")

# The reference service's default, which its sidecar runs with.
DEDUP_CACHE_SIZE = 65536
# The reference's legacy flush loop: its flush deadline and its bound on
# concurrent non-urgent dispatches (`max_delay`, `max_concurrent_dispatches`).
LEGACY_MAX_DELAY_S = 0.002
MAX_CONCURRENT_DISPATCHES = 4


class VerifiedSigCache:
    """Bounded LRU of (message, pk, sig) triples that verified.

    A hit short-circuits the backend call. Only successes are cached, and
    the key is the full triple, so a forged signature over the same
    message can never alias an entry. Thread-safe: dispatch threads look
    entries up while the event loop seeds them."""

    __slots__ = ("maxsize", "_entries", "_lock")

    def __init__(self, maxsize: int = 65536) -> None:
        if maxsize <= 0:
            raise ValueError("dedup cache needs maxsize >= 1")
        self.maxsize = maxsize
        self._entries: OrderedDict[tuple[bytes, bytes, bytes], None] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def hit(self, message: bytes, key: PublicKey, sig: Signature) -> bool:
        """True iff this exact triple verified before (refreshes its LRU
        recency); counts into verifier.dedup_hits / dedup_misses."""
        k = (message, key.data, sig.data)
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                _M_DEDUP_HITS.inc()
                return True
        _M_DEDUP_MISSES.inc()
        return False

    def add(self, message: bytes, key: PublicKey, sig: Signature) -> None:
        """Record a verified triple; evicts the least recently used past
        maxsize."""
        k = (message, key.data, sig.data)
        with self._lock:
            if k in self._entries:
                self._entries.move_to_end(k)
                return
            self._entries[k] = None
            _M_DEDUP_INSERTS.inc()
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                _M_DEDUP_EVICTIONS.inc()


@dataclass
class _Group:
    messages: list[bytes]
    keys: list[PublicKey]
    signatures: list[Signature]
    urgent: bool
    committee: bool = False
    # dedup=False keeps the group out of the verified-signature cache.
    dedup: bool = True
    # Trace id (utils/tracing.py): a traced group gets a verify.batch event.
    trace: str | None = None
    # Scheduler source class; t_submit is stamped at admission, t_dequeue
    # when a bucket (or a legacy flush) takes the group.
    source: str = "mempool"
    t_submit: float = 0.0
    t_dequeue: float = 0.0
    future: asyncio.Future = field(default_factory=lambda: asyncio.get_running_loop().create_future())

    def __len__(self) -> int:
        return len(self.messages)


class BatchVerificationService:
    def __init__(
        self,
        backend: CryptoBackend | None = None,
        max_batch: int = 8192,
        use_scheduler: bool = True,
        steal_backends: Sequence[CryptoBackend] = (),
        inline: bool = False,
        scheduler_config: SchedulerConfig | None = None,
    ) -> None:
        self._backend = backend
        self.max_batch = max_batch
        # Backends 1.. of the scheduler's accounts: where bulk buckets go
        # while every slot of the home backend (0) is in flight. Inline
        # (virtual-time) services never steal.
        self._steal_backends: list[CryptoBackend] = [] if inline else list(steal_backends)
        self.inline = inline
        self.dedup = VerifiedSigCache(DEDUP_CACHE_SIZE)
        self._queue: asyncio.Queue[_Group] = asyncio.Queue()  # the legacy loop's
        self._task: asyncio.Task | None = None
        self.lane_stats = LaneStats()  # per-lane queueing delay, fed by both loops
        self.scheduler: DeviceScheduler | None = (
            DeviceScheduler(
                self._spawn_dispatch,
                max_batch=max_batch,
                alignment_fn=self._bucket_alignment,
                lane_stats=self.lane_stats,
                config=scheduler_config,
                n_backends=1 + len(self._steal_backends),
            )
            if use_scheduler
            else None
        )
        self.stats = {
            "flushes": 0,
            "size_flushes": 0,
            "urgent_flushes": 0,
            "verified": 0,
        }

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            loop = self.scheduler.run() if self.scheduler is not None else self._run_legacy()
            self._task = spawn(loop, name="batch-verification-service")

    @property
    def backend(self) -> CryptoBackend:
        """The backend given at construction, else the active one."""
        return self._backend or get_backend()

    def _bucket_alignment(self) -> int:
        """The bucket grid the scheduler sizes bulk buckets against (0 for
        gridless backends)."""
        return getattr(self.backend, "bucket_alignment", 0)

    # -- submission API ------------------------------------------------------

    async def verify_group(
        self,
        messages: Sequence[bytes],
        pairs: Sequence[tuple[PublicKey, Signature]],
        urgent: bool = False,
        committee: bool = False,
        dedup: bool = True,
        trace: str | None = None,
        source: str | None = None,
    ) -> list[bool]:
        """Submit a correlated group; resolves to its per-item validity
        mask once the group's flush completes. `source` declares the
        scheduler class; when omitted, `urgent` maps to consensus-critical
        vs mempool bulk. `committee=True` tags the group as signed by
        registered validator keys; `dedup=False` keeps it out of the
        verified-signature cache; `trace` tags it with a trace id for the
        flight recorder."""
        if not messages:
            return []
        self._ensure_task()
        cls = resolve_source(source, urgent)
        group = _Group(
            list(messages),
            [pk for pk, _ in pairs],
            [sig for _, sig in pairs],
            cls.preemptive,
            committee,
            dedup,
            trace,
            cls.name,
            asyncio.get_running_loop().time(),
        )
        if self.scheduler is not None:
            self.scheduler.submit(group)
        else:
            await self._queue.put(group)
        return await group.future

    async def verify(
        self,
        message: bytes,
        key: PublicKey,
        signature: Signature,
        urgent: bool = True,
        committee: bool = False,
        trace: str | None = None,
        source: str | None = None,
    ) -> bool:
        """Await a single verification (batched under the hood)."""
        mask = await self.verify_group([message], [(key, signature)], urgent, committee, trace=trace, source=source)
        return mask[0]

    def seed_verified(self, message: bytes, key: PublicKey, signature: Signature) -> None:
        """Record an already verified triple into the dedup cache (the
        aggregator seeds vote and timeout signatures on arrival, so the QC
        or TC assembled from them re-verifies none here)."""
        self.dedup.add(message, key, signature)

    # -- the legacy flush loop -----------------------------------------------

    async def _run_legacy(self) -> None:
        """The reference's single-queue flush heuristics
        (`hotstuff_tpu/crypto/batch_service.py:331-383`): size, deadline
        and urgent flushing, no lanes, no alignment sizing, no refill."""
        loop = asyncio.get_running_loop()
        # Non-urgent flushes run concurrently up to this bound; urgent ones
        # never wait for a slot.
        slots = asyncio.Semaphore(MAX_CONCURRENT_DISPATCHES)
        while True:
            first = await self._queue.get()
            groups = [first]
            total = len(first)
            urgent = first.urgent
            deadline = loop.time() + LEGACY_MAX_DELAY_S
            while total < self.max_batch:
                # Take whatever is already enqueued.
                while not self._queue.empty() and total < self.max_batch:
                    g = self._queue.get_nowait()
                    groups.append(g)
                    total += len(g)
                    urgent |= g.urgent
                if urgent or total >= self.max_batch:
                    break
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    g = await asyncio.wait_for(self._queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                groups.append(g)
                total += len(g)
                urgent |= g.urgent

            # Dequeue time is stamped at the flush decision, so the lanes'
            # queueing delays read as the scheduler's do (submit -> dequeue).
            now = loop.time()
            for g in groups:
                g.t_dequeue = now
                note_queue_delay(self.lane_stats, g.source, max(0.0, now - g.t_submit))

            # Urgent groups dispatch in a flush of their own, at once; the
            # other groups of the same pass flush separately, behind the
            # dispatch bound (taken inside the spawned task, so this loop
            # keeps draining while every slot is busy).
            if urgent:
                hot = [g for g in groups if g.urgent]
                cold = [g for g in groups if not g.urgent]
                self._spawn_dispatch(hot, sum(len(g) for g in hot), True)
                if cold:
                    spawn(self._dispatch_in_slot(slots, cold, sum(len(g) for g in cold)), name="verify-dispatch")
            else:
                spawn(self._dispatch_in_slot(slots, groups, total), name="verify-dispatch")

    async def _dispatch_in_slot(self, slots: asyncio.Semaphore, groups: list[_Group], total: int) -> None:
        async with slots:
            await self._dispatch(groups, total, False)

    # -- dispatch ------------------------------------------------------------

    def _spawn_dispatch(self, groups: list[_Group], total: int, urgent: bool, backend_idx: int = 0) -> asyncio.Task:
        return spawn(self._dispatch(groups, total, urgent, backend_idx), name="verify-dispatch")

    async def _dispatch(self, groups: list[_Group], total: int, urgent: bool, backend_idx: int = 0) -> None:
        msgs = [m for g in groups for m in g.messages]
        keys = [k for g in groups for k in g.keys]
        sigs = [s for g in groups for s in g.signatures]
        # backend_idx > 0 is a steal; committee routing still resolves per
        # backend (a steal target without the committee takes the generic
        # kernels).
        backend = self.backend if backend_idx == 0 else self._steal_backends[backend_idx - 1]
        # Lanes of dedup=False groups neither hit nor enter the cache; a
        # flush with no cached group skips the scan.
        eligible = None if all(g.dedup for g in groups) else [g.dedup for g in groups for _ in range(len(g))]
        if any(g.dedup for g in groups):
            mask, miss = self._lookup(msgs, keys, sigs, eligible)
        else:
            mask, miss = [False] * len(msgs), range(len(msgs))
        if miss:
            full = len(miss) == len(msgs)
            kwargs = {}
            if all(g.committee for g in groups) and getattr(backend, "supports_committee_routing", False):
                kwargs["committee"] = True
            m = msgs if full else [msgs[i] for i in miss]
            k = keys if full else [keys[i] for i in miss]
            s = sigs if full else [sigs[i] for i in miss]
            t0 = time.perf_counter()
            try:
                if self.inline:
                    sub = backend.verify_batch_mask(m, k, s, **kwargs)
                else:
                    sub = await asyncio.to_thread(backend.verify_batch_mask, m, k, s, **kwargs)
            except Exception as exc:  # a backend failure must not hang callers
                for g in groups:
                    if not g.future.done():
                        g.future.set_exception(exc)
                return
            if tracing.enabled():
                # One verify.batch event per traced group in the flush (the
                # flush's time, the group's lane and its queueing delay),
                # plus a watchdog sample of the flush's per-signature cost.
                dur = time.perf_counter() - t0
                for g in groups:
                    if g.trace is not None:
                        tracing.event("verify.batch", g.trace, dur, n=len(g), flush=len(miss), lane=g.source,
                                      queue_s=round(max(0.0, g.t_dequeue - g.t_submit), 6))
                tracing.WATCHDOG.note_verify(dur, len(miss))
            self._remember(mask, miss, sub, msgs, keys, sigs, eligible)
        self.stats["flushes"] += 1
        self.stats["size_flushes"] += total >= self.max_batch
        self.stats["urgent_flushes"] += urgent
        self.stats["verified"] += total
        lo = 0
        for g in groups:
            hi = lo + len(g)
            if not g.future.cancelled():
                g.future.set_result([bool(b) for b in mask[lo:hi]])
            lo = hi

    def _lookup(self, msgs, keys, sigs, eligible=None) -> tuple[list[bool], list[int]]:
        """The dedup scan: a mask with every eligible triple that verified
        before set True, and the indices of the rest, which go to the
        backend. `eligible` None means every lane."""
        mask = [False] * len(msgs)
        miss = []
        for i, (m, k, s) in enumerate(zip(msgs, keys, sigs)):
            if (eligible is None or eligible[i]) and self.dedup.hit(m, k, s):
                mask[i] = True
            else:
                miss.append(i)
        return mask, miss

    def _remember(self, mask, miss, sub, msgs, keys, sigs, eligible=None) -> None:
        """Write the backend's verdicts on the misses into `mask` and cache
        the eligible triples that verified."""
        for i, ok in zip(miss, sub):
            mask[i] = bool(ok)
            if ok and (eligible is None or eligible[i]):
                self.dedup.add(msgs[i], keys[i], sigs[i])
