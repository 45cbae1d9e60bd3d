"""The port's `BatchVerificationService` and `DeviceScheduler` against the
reference's (`hotstuff_tpu/crypto/batch_service.py`, `scheduler.py`).

Both services get the same group sequence, submitted in the same event
loop tick, into the same kind of recording stub backend (the reference's
under its scheduler, the default). They must make the same flushes (the same lanes in each backend call, the same `committee`
keyword), resolve the same masks, and count the same `scheduler.*` and
`verifier.dedup_*` metrics and service stats.
"""

from __future__ import annotations

import asyncio
import sys
import threading

import pytest

from hotstuff_tpu.crypto import batch_service as ref_bs
from hotstuff_tpu.crypto import scheduler as ref_sched
from hotstuff_tpu.crypto.primitives import PublicKey as RefPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RefSignature
from hotstuff_tpu.utils import metrics as ref_metrics
from hotstuff_tpu.utils import tracing as ref_tracing
from hotstuff_tpu_torch.crypto import batch_service, scheduler
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.utils import metrics, tracing
from tests.common_torch_threads import one_torch_thread  # noqa: F401


class RecordingBackend:
    """Records each call's messages and `committee` keyword; a lane is
    valid iff its signature's first byte is not a multiple of 3."""

    name = "stub"
    supports_committee_routing = True

    def __init__(self, alignment: int) -> None:
        self.bucket_alignment = alignment
        self.calls: list[tuple[tuple[bytes, ...], bool]] = []
        self._lock = threading.Lock()

    def verify_batch_mask(self, messages, keys, signatures, committee=False):
        with self._lock:
            self.calls.append((tuple(messages), committee))
        return [s.data[0] % 3 != 0 for s in signatures]


def _group(tag: str, n: int, first_sig_byte: int = 1):
    """n triples named by `tag`; lane i's signature starts with
    first_sig_byte + i."""
    msgs = [f"{tag}-{i}".encode() for i in range(n)]
    keys = [bytes([i % 256]) * 32 for i in range(n)]
    sigs = [bytes([(first_sig_byte + i) % 256]) * 64 for i in range(n)]
    return msgs, keys, sigs


# Each scenario: (alignment, max_batch, rounds). A round is a list of group
# specs (tag, n, urgent, committee, source) submitted in one tick; rounds
# run one after another.
SCENARIOS = {
    "urgent_and_bulk": (8, 32, [[
        ("b0", 5, False, False, None), ("b1", 7, False, False, None), ("b2", 20, False, False, None),
        ("u0", 3, True, False, None), ("b3", 9, False, False, None), ("u1", 2, True, False, None),
        ("b4", 3, False, False, None),
    ]]),
    "committee_tagged": (8, 64, [[
        ("c0", 43, False, True, None), ("c1", 43, False, True, None), ("u0", 4, True, True, None),
    ]]),
    "committee_mixed": (8, 64, [
        [("c0", 10, False, True, None), ("g0", 6, False, False, None), ("c1", 30, False, True, None),
         ("u0", 4, True, True, None), ("u1", 2, True, False, None)],
        [("c2", 20, False, True, None), ("u2", 3, True, True, None)],
    ]),
    "sources": (16, 40, [[
        ("m0", 6, False, False, "mempool"), ("i0", 5, False, False, "ingress"),
        ("s0", 4, False, False, "sync"), ("a0", 3, False, False, "aggregate"),
        ("k0", 2, False, False, "consensus"), ("m1", 30, False, False, "mempool"),
    ]]),
    "size_and_gridless": (0, 16, [[
        ("b0", 20, False, False, None), ("b1", 5, False, False, None), ("b2", 11, False, False, None),
        ("b3", 1, False, False, None),
    ]]),
    "deadline_below_the_grid": (128, 8192, [[
        ("m0", 5, False, False, None), ("m1", 7, False, False, None), ("i0", 3, False, False, "ingress"),
    ]]),
    "grid_overshoot": (16, 64, [[
        ("b0", 10, False, False, None), ("b1", 10, False, False, None), ("b2", 10, False, False, None),
    ]]),
    "priority_order": (8, 24, [[
        ("m0", 10, False, False, "mempool"), ("i0", 10, False, False, "ingress"),
        ("s0", 10, False, False, "sync"), ("a0", 6, False, False, "aggregate"),
    ]]),
    "urgent_storm": (16, 64, [
        [("u0", 2, True, False, None), ("b0", 40, False, False, None), ("u1", 2, True, False, None)],
        [("u2", 2, True, False, None), ("u3", 1, True, True, None), ("b1", 9, False, True, None)],
    ]),
    "dedup_rounds": (8, 32, [
        [("d0", 12, False, False, None), ("u0", 3, True, False, None)],
        [("d0", 12, False, False, None), ("u0", 3, True, False, None), ("d1", 4, False, False, None)],
    ]),
}


def _drive(pkg: str, scenario: str, use_scheduler: bool = True, dedup=lambda tag: True):
    """Run one scenario through one package's service (its scheduler, or
    the legacy flush loop), each group's cache opt-in from `dedup(tag)`.
    Returns (sorted backend calls, masks by round, service stats, scheduler
    stats, lane counts, counter values, histogram counts)."""
    if pkg == "port":
        bs, m, pk, sg = batch_service, metrics, PublicKey, Signature
    else:
        bs, m, pk, sg = ref_bs, ref_metrics, RefPublicKey, RefSignature
    alignment, max_batch, rounds = SCENARIOS[scenario]
    backend = RecordingBackend(alignment)

    async def body():
        m.reset()
        svc = bs.BatchVerificationService(backend, max_batch=max_batch, use_scheduler=use_scheduler)
        masks = []
        for specs in rounds:
            calls = []
            for tag, n, urgent, committee, source in specs:
                msgs, keys, sigs = _group(tag, n)
                calls.append(svc.verify_group(msgs, [(pk(k), sg(s)) for k, s in zip(keys, sigs)],
                                              urgent=urgent, committee=committee, source=source,
                                              dedup=dedup(tag)))
            masks.append(await asyncio.gather(*calls))
        lanes = {lane: v["count"] for lane, v in svc.lane_stats.summary().items()}
        sched = dict(svc.scheduler.stats) if use_scheduler else {"cache": len(svc.dedup)}
        return masks, dict(svc.stats), sched, lanes

    masks, stats, sched_stats, lanes = asyncio.run(asyncio.wait_for(body(), 30))
    dump = m.dump()
    counters = {k: v for k, v in dump["counters"].items() if k.startswith(("scheduler.", "verifier.dedup_", "pipeline."))}
    hists = {k: v["count"] for k, v in dump["histograms"].items() if k.startswith("scheduler.")}
    return sorted(backend.calls), masks, stats, sched_stats, lanes, counters, hists


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_service_flushes_and_counts_as_the_reference(scenario):
    port = _drive("port", scenario)
    ref = _drive("reference", scenario)
    calls, masks, stats, sched_stats, lanes, counters, hists = port
    assert calls == ref[0]  # the same flush partition and committee keyword
    assert masks == ref[1]
    assert stats == ref[2]
    assert sched_stats == ref[3]  # steals included: 0 with no steal backend
    assert lanes == ref[4]
    ref_counters = {k: ref[5][k] for k in counters}
    assert counters == ref_counters
    assert hists == {k: ref[6][k] for k in hists}
    # Every lane is answered with the stub's rule (a cached lane was valid).
    for specs, round_masks in zip(SCENARIOS[scenario][2], masks):
        for (tag, n, *_), mask in zip(specs, round_masks):
            assert mask == [(1 + i) % 3 != 0 for i in range(n)], tag


def test_committee_keyword_only_when_every_group_is_tagged():
    calls = _drive("port", "committee_tagged")[0]
    assert calls and all(committee for _, committee in calls)
    mixed = _drive("port", "committee_mixed")[0]
    assert any(not committee for _, committee in mixed) and any(committee for _, committee in mixed)
    for msgs, committee in mixed:
        tags = {m.split(b"-")[0] for m in msgs}
        assert committee == tags.isdisjoint({b"g0", b"u1"})


def test_dedup_hits_skip_the_backend():
    calls, masks, *_rest, counters, _ = _drive("port", "dedup_rounds")
    sent = [m for msgs, _ in calls for m in msgs]
    # d0 and u0 lanes with valid signatures went to the backend once; the
    # invalid ones (first byte a multiple of 3) went twice.
    for tag, n in (("d0", 12), ("u0", 3)):
        for i in range(n):
            want = 2 if (1 + i) % 3 == 0 else 1
            assert sent.count(f"{tag}-{i}".encode()) == want
    valid = sum((1 + i) % 3 != 0 for i in range(12)) + sum((1 + i) % 3 != 0 for i in range(3))
    assert counters["verifier.dedup_hits"] == valid


def test_scheduler_names_match_the_reference():
    assert [(c.name, c.priority, c.slo_s, c.max_delay_s, c.preemptive) for c in scheduler.SOURCE_CLASSES.values()] == [
        (c.name, c.priority, c.slo_s, c.max_delay_s, c.preemptive) for c in ref_sched.SOURCE_CLASSES.values()]
    assert scheduler.BULK_CONCURRENCY == ref_sched.SchedulerConfig().bulk_concurrency == 2
    with pytest.raises(ValueError):
        scheduler.resolve_source("bogus", False)


def test_cache_is_bounded_and_thread_safe():
    """Eight threads insert and look up overlapping triples under a short
    switch interval: the cache never exceeds maxsize, and inserts minus
    evictions equal its length."""
    metrics.reset()
    cache = batch_service.VerifiedSigCache(maxsize=500)
    key, sig = PublicKey(bytes(32)), Signature(bytes(64))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t: int) -> None:
            for i in range(2000):
                msg = b"%d" % ((t * 997 + i) % 1500)
                if not cache.hit(msg, key, sig):
                    cache.add(msg, key, sig)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    counters = metrics.dump()["counters"]
    assert len(cache) == 500
    assert counters["verifier.dedup_inserts"] - counters["verifier.dedup_evictions"] == len(cache)
    assert counters["verifier.dedup_hits"] + counters["verifier.dedup_misses"] == 8 * 2000


class _StubGroup:
    """What the scheduler reads of a group: source, times and length."""

    def __init__(self, tag: str, n: int, source: str) -> None:
        self.tag, self.n, self.source = tag, n, source
        self.t_submit = self.t_dequeue = 0.0

    def __len__(self) -> int:
        return self.n


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_scheduler_holds_two_bulk_buckets_in_flight(pkg):
    """The first two buckets dispatch at once; the next two wait for a
    free slot, and a critical group goes past the full window. When the
    held buckets finish, the waiting work dispatches. The port's scheduler
    and the reference's dispatch the same way."""
    mod, m = (scheduler, metrics) if pkg == "port" else (ref_sched, ref_metrics)

    async def body():
        m.reset()
        loop = asyncio.get_running_loop()
        release = loop.create_future()
        shipped = []

        def dispatch(groups, total, critical):
            shipped.append(([g.tag for g in groups], critical))

            async def hold():
                if not critical:
                    await release

            return loop.create_task(hold())

        sched = mod.DeviceScheduler(dispatch, max_batch=64, alignment_fn=lambda: 8)
        runner = loop.create_task(sched.run())
        for i in range(4):
            g = _StubGroup(f"b{i}", 8, "mempool")
            g.t_submit = loop.time()
            sched.submit(g)
            await asyncio.sleep(0)
        await asyncio.sleep(0.05)
        before_release = list(shipped)
        urgent = _StubGroup("u0", 3, "consensus")
        urgent.t_submit = loop.time()
        sched.submit(urgent)
        await asyncio.sleep(0.05)
        with_urgent = list(shipped)
        release.set_result(None)
        await asyncio.sleep(0.05)
        runner.cancel()
        await asyncio.gather(runner, return_exceptions=True)
        return before_release, with_urgent, shipped, dict(sched.stats), m.dump()["counters"]

    before, with_urgent, shipped, stats, counters = asyncio.run(asyncio.wait_for(body(), 30))
    assert before == [(["b0"], False), (["b1"], False)]
    assert with_urgent == before + [(["u0"], True)]
    assert shipped[3:] == [(["b2", "b3"], False)]
    assert stats["buckets"] == counters["scheduler.buckets"] == 3
    assert stats["critical_dispatches"] == counters["scheduler.critical_dispatches"] == 1


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_legacy_flush_loop_flushes_as_the_reference(scenario):
    """`use_scheduler=False` (`_run_legacy`) makes the reference's legacy
    flushes, stats, lane counts and cache counters, and answers every
    group with the mask the scheduler path gives it."""
    port = _drive("port", scenario, use_scheduler=False)
    ref = _drive("reference", scenario, use_scheduler=False)
    calls, masks, stats, cache, lanes, counters, hists = port
    assert calls == ref[0]
    assert masks == ref[1] == _drive("port", scenario)[1]
    assert stats == ref[2] and lanes == ref[4]
    assert cache == ref[3]  # the cache's size
    assert counters == {k: ref[5][k] for k in counters}
    assert hists == {k: ref[6][k] for k in hists}
    assert counters["scheduler.buckets"] == 0  # the scheduler never ran


@pytest.mark.parametrize("use_scheduler", [True, False])
def test_dedup_false_groups_never_touch_the_cache(use_scheduler):
    """Groups submitted with `dedup=False` neither hit nor enter the
    verified-signature cache, in a flush of their own or beside cached
    groups, on both loops; the counters are the reference's."""
    only = _drive("port", "dedup_rounds", use_scheduler, dedup=lambda tag: False)
    assert only[5]["verifier.dedup_hits"] == only[5]["verifier.dedup_misses"] == 0
    assert only[5]["verifier.dedup_inserts"] == 0
    sent = [m for msgs, _ in only[0] for m in msgs]
    assert sent.count(b"d0-0") == 2  # the repeated group went to the backend twice
    mixed = lambda tag: tag != "d0"
    port = _drive("port", "dedup_rounds", use_scheduler, dedup=mixed)
    ref = _drive("reference", "dedup_rounds", use_scheduler, dedup=mixed)
    assert port[0] == ref[0] and port[1] == ref[1]
    assert {k: v for k, v in port[5].items() if k.startswith("verifier.dedup")} == {
        k: ref[5][k] for k in port[5] if k.startswith("verifier.dedup")}
    assert port[5]["verifier.dedup_hits"] > 0 and b"d0-0" in [m for msgs, _ in port[0] for m in msgs]


def test_legacy_loop_waits_max_delay_then_flushes_at_size(monkeypatch):
    """The legacy loop holds a lone bulk group until its flush deadline
    expires, coalesces what arrives meanwhile, and closes a flush at
    `max_batch`. The deadline is stretched to 50 ms so that the check
    inside it does not race the clock."""
    backend = RecordingBackend(0)
    monkeypatch.setattr(batch_service, "LEGACY_MAX_DELAY_S", 0.05)

    async def body():
        svc = batch_service.BatchVerificationService(backend, max_batch=16, use_scheduler=False)
        msgs, keys, sigs = _group("a", 4)
        pairs = [(PublicKey(k), Signature(s)) for k, s in zip(keys, sigs)]
        first = asyncio.ensure_future(svc.verify_group(msgs, pairs))
        await asyncio.sleep(0.01)
        assert backend.calls == []  # still inside the deadline
        msgs_b, keys_b, sigs_b = _group("b", 14)
        second = svc.verify_group(msgs_b, [(PublicKey(k), Signature(s)) for k, s in zip(keys_b, sigs_b)])
        await asyncio.gather(first, second)
        return dict(svc.stats)

    stats = asyncio.run(asyncio.wait_for(body(), 30))
    assert len(backend.calls) == 1 and len(backend.calls[0][0]) == 18
    assert stats["size_flushes"] == 1 and stats["flushes"] == 1


def _traced_events(pkg: str, use_scheduler: bool):
    """verify.batch events of a round with traced and untraced groups."""
    if pkg == "port":
        bs, tr, pk, sg = batch_service, tracing, PublicKey, Signature
    else:
        bs, tr, pk, sg = ref_bs, ref_tracing, RefPublicKey, RefSignature
    backend = RecordingBackend(8)

    async def body():
        tr.reset()
        svc = bs.BatchVerificationService(backend, max_batch=32, use_scheduler=use_scheduler)
        calls = []
        for tag, n, urgent, trace, source in (("t0", 5, False, "r1-aa", "ingress"), ("u0", 3, True, "r2-bb", None),
                                              ("n0", 6, False, None, "mempool"), ("t1", 4, False, "r3-cc", None)):
            msgs, keys, sigs = _group(tag, n)
            calls.append(svc.verify_group(msgs, [(pk(k), sg(s)) for k, s in zip(keys, sigs)], urgent=urgent,
                                          trace=trace, source=source, dedup=False))
        await asyncio.gather(*calls)
        return [e for e in tr.RECORDER.events() if e["kind"] == "verify.batch"]

    return asyncio.run(asyncio.wait_for(body(), 30))


@pytest.mark.parametrize("use_scheduler", [True, False])
def test_traced_groups_emit_verify_batch_as_the_reference(use_scheduler):
    """One `verify.batch` event per traced group in each flush that reaches
    the backend, with the reference's fields (`n`, `flush`, `lane`,
    `queue_s`) and the flush's time as its duration."""
    ours, theirs = _traced_events("port", use_scheduler), _traced_events("reference", use_scheduler)
    strip = lambda evs: sorted((e["trace"], tuple(sorted((k, v) for k, v in e["data"].items() if k != "queue_s")))
                               for e in evs)
    assert strip(ours) == strip(theirs)
    assert sorted(e["trace"] for e in ours) == ["r1-aa", "r2-bb", "r3-cc"]
    for e in ours:
        assert set(e["data"]) == {"n", "flush", "lane", "queue_s"} and e["dur"] >= 0 and e["data"]["queue_s"] >= 0
