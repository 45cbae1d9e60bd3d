"""BatchVerificationService: the verification facade over the device
scheduler.

A copy of `hotstuff_tpu/crypto/batch_service.py` for the port. Callers
submit groups of (message, key, signature) triples (one QC's votes, one
payload batch, one wire request), declare their source class (`source=`,
or the `urgent` bit; `crypto/scheduler.py`) and await a per-item validity
mask. Batching policy lives in `DeviceScheduler`; this class is the
dispatch executor: the verified-signature cache, committee tagging, the
backend call in a worker thread (`asyncio.to_thread`, so a dispatch never
blocks the event loop) and future resolution. The scheduler's bulk window
(`BULK_CONCURRENCY`) is the only bound on concurrent bulk dispatches.

Committee tagging follows the reference exactly: a flush passes
`committee=True` to the backend only when every group in it was submitted
with `committee=True` and the backend supports committee routing. The
sidecar's wire carries no committee tag, so its flushes never take the
committee kernels.

The reference records a flight-recorder `verify.batch` event for each
group that carries a causal trace id. The sidecar's wire carries no trace
id, so those events never fire there; they are not ported. Neither is
what the sidecar never reaches: the reference's single-queue flush loop
(`use_scheduler=False`, the baseline of its scheduler A/B bench) with
its `max_delay` and dispatch semaphore, cross-backend stealing, the
inline (virtual-time) dispatch mode, the per-group cache opt-out
(`dedup=False`, which the wire cannot express), `verify`,
`seed_verified`, and the cache size the reference's sidecar leaves at
its default (65,536 triples).
"""

from __future__ import annotations

import asyncio
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

from ..utils import metrics
from ..utils.actors import spawn
from .backend import CryptoBackend
from .primitives import PublicKey, Signature
from .scheduler import DeviceScheduler, LaneStats, resolve_source

log = logging.getLogger("hotstuff.crypto")

_M_DEDUP_HITS = metrics.counter("verifier.dedup_hits")
_M_DEDUP_MISSES = metrics.counter("verifier.dedup_misses")
_M_DEDUP_INSERTS = metrics.counter("verifier.dedup_inserts")
_M_DEDUP_EVICTIONS = metrics.counter("verifier.dedup_evictions")

# The reference service's default, which its sidecar runs with.
DEDUP_CACHE_SIZE = 65536


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
    # Scheduler source class; t_submit is stamped at admission, t_dequeue
    # when a bucket takes the group.
    source: str = "mempool"
    t_submit: float = 0.0
    t_dequeue: float = 0.0
    future: asyncio.Future = field(default_factory=lambda: asyncio.get_running_loop().create_future())

    def __len__(self) -> int:
        return len(self.messages)


class BatchVerificationService:
    def __init__(
        self,
        backend: CryptoBackend,
        max_batch: int = 8192,
    ) -> None:
        self.backend = backend
        self.max_batch = max_batch
        self.dedup = VerifiedSigCache(DEDUP_CACHE_SIZE)
        self._task: asyncio.Task | None = None
        self.lane_stats = LaneStats()  # per-lane queueing delay
        self.scheduler = DeviceScheduler(
            self._spawn_dispatch,
            max_batch=max_batch,
            alignment_fn=self._bucket_alignment,
            lane_stats=self.lane_stats,
        )
        self.stats = {
            "flushes": 0,
            "size_flushes": 0,
            "urgent_flushes": 0,
            "verified": 0,
        }

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self._task = spawn(self.scheduler.run(), name="batch-verification-service")

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
        source: str | None = None,
    ) -> list[bool]:
        """Submit a correlated group; resolves to its per-item validity
        mask once the group's flush completes. `source` declares the
        scheduler class; when omitted, `urgent` maps to consensus-critical
        vs mempool bulk. `committee=True` tags the group as signed by
        registered validator keys."""
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
            cls.name,
            asyncio.get_running_loop().time(),
        )
        self.scheduler.submit(group)
        return await group.future

    # -- dispatch ------------------------------------------------------------

    def _spawn_dispatch(self, groups: list[_Group], total: int, urgent: bool) -> asyncio.Task:
        return spawn(self._dispatch(groups, total, urgent), name="verify-dispatch")

    async def _dispatch(self, groups: list[_Group], total: int, urgent: bool) -> None:
        msgs = [m for g in groups for m in g.messages]
        keys = [k for g in groups for k in g.keys]
        sigs = [s for g in groups for s in g.signatures]
        backend = self.backend
        mask, miss = self._lookup(msgs, keys, sigs)
        if miss:
            full = len(miss) == len(msgs)
            kwargs = {}
            if all(g.committee for g in groups) and getattr(backend, "supports_committee_routing", False):
                kwargs["committee"] = True
            m = msgs if full else [msgs[i] for i in miss]
            k = keys if full else [keys[i] for i in miss]
            s = sigs if full else [sigs[i] for i in miss]
            try:
                sub = await asyncio.to_thread(backend.verify_batch_mask, m, k, s, **kwargs)
            except Exception as exc:  # a backend failure must not hang callers
                for g in groups:
                    if not g.future.done():
                        g.future.set_exception(exc)
                return
            self._remember(mask, miss, sub, msgs, keys, sigs)
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

    def _lookup(self, msgs, keys, sigs) -> tuple[list[bool], list[int]]:
        """The dedup scan: a mask with every triple that verified before
        set True, and the indices of the misses, which go to the backend."""
        mask = [False] * len(msgs)
        miss = []
        for i, (m, k, s) in enumerate(zip(msgs, keys, sigs)):
            if self.dedup.hit(m, k, s):
                mask[i] = True
            else:
                miss.append(i)
        return mask, miss

    def _remember(self, mask, miss, sub, msgs, keys, sigs) -> None:
        """Write the backend's verdicts on the misses into `mask` and cache
        the triples that verified."""
        for i, ok in zip(miss, sub):
            mask[i] = bool(ok)
            if ok:
                self.dedup.add(msgs[i], keys[i], sigs[i])
