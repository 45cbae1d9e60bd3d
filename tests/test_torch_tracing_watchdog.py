"""The anomaly watchdog's verify-regression trigger in the port
(`utils/tracing.py` `AnomalyWatchdog.note_verify`, fed by
`crypto/batch_service.py` after each backend dispatch) held against the
reference's (`hotstuff_tpu/utils/tracing.py`, `crypto/batch_service.py`):

  * the same per-flush samples fire at the same sample in both watchdogs
    (the baseline is the median of the first `BASELINE_SAMPLES`, a fire
    needs `REGRESSION_STREAK` consecutive flushes above `p99_factor` x it);
  * a traced `BatchVerificationService` over a stub backend, 32 fast
    flushes then 8 slow ones, fires once in each package, on the last.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from hotstuff_tpu.crypto import batch_service as r_batch_service
from hotstuff_tpu.crypto.primitives import PublicKey as RPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RSignature
from hotstuff_tpu.utils import tracing as r_tracing
from hotstuff_tpu_torch.crypto import batch_service as p_batch_service
from hotstuff_tpu_torch.crypto.primitives import PublicKey as PPublicKey
from hotstuff_tpu_torch.crypto.primitives import Signature as PSignature
from hotstuff_tpu_torch.utils import tracing as p_tracing

PKGS = {
    "reference": (r_tracing, r_batch_service, RPublicKey, RSignature),
    "port": (p_tracing, p_batch_service, PPublicKey, PSignature),
}


@pytest.fixture
def traced():
    """Both packages' tracing on, their recorders and watchdogs cleared
    before and after."""
    was = {name: mods[0].enabled() for name, mods in PKGS.items()}
    for tracing, *_ in PKGS.values():
        tracing.enable(True)
        tracing.reset()
    yield
    for name, (tracing, *_rest) in PKGS.items():
        tracing.enable(was[name])
        tracing.reset()


def test_constants_and_event_kind_equal_the_reference():
    for name in ("BASELINE_SAMPLES", "REGRESSION_STREAK"):
        assert getattr(p_tracing.AnomalyWatchdog, name) == getattr(r_tracing.AnomalyWatchdog, name)
    assert p_tracing.AnomalyWatchdog().p99_factor == r_tracing.AnomalyWatchdog().p99_factor == 4.0
    assert "watchdog.verify_regression" in p_tracing.EVENT_KINDS
    assert p_tracing.EVENT_KINDS == r_tracing.EVENT_KINDS


# Per-flush (duration s, signatures) samples after one cold 500 ms-a-
# signature sample: the reference's sequence (`tests/test_tracing.py`,
# 100 us a signature, then flushes at 10 ms), and what follows it: a
# streak that carries on past a fire, one broken by a fast flush, and one
# across an empty flush (which is no sample).
SEQUENCE = (
    [(0.001, 10)] * 32 + [(0.1, 10)] + [(0.1, 10)] * 8
    + [(0.1, 10)] * 7 + [(0.001, 10)] + [(0.1, 10)] * 8
    + [(0.0, 0)] + [(0.1, 10)] * 8
)


@pytest.mark.parametrize("cooldown_s", [100.0, 0.0])
def test_note_verify_fires_at_the_same_samples(traced, cooldown_s):
    fired = {}
    for name, (tracing, *_rest) in PKGS.items():
        now = {"t": 0.0}
        prev = tracing.set_clock(lambda: now["t"])
        try:
            wd = tracing.AnomalyWatchdog(p99_factor=4.0, cooldown_s=cooldown_s)
            out = []
            wd.add_dump_hook(lambda reason, detail: out.append((i, reason, detail)))
            # A median baseline: cold outliers among the first samples do
            # not move it.
            wd.note_verify(5.0, 10)
            for i, (dur, n) in enumerate(SEQUENCE):
                now["t"] = float(i)
                wd.note_verify(dur, n)
            fired[name] = (out, wd.triggers, wd._verify_baseline)
        finally:
            tracing.set_clock(prev)
    assert fired["port"] == fired["reference"]
    out, triggers, baseline = fired["port"]
    assert baseline == 0.0001
    assert [i for i, *_ in out] == ([39, 47, 56, 65] if cooldown_s == 0.0 else [39])
    assert out[0][1:] == ("verify_regression", {"per_sig_s": 0.01, "baseline_s": 0.0001})
    assert triggers[0]["reason"] == "verify_regression"


class _StubBackend:
    """Answers every lane True after `delay` seconds of wall time."""

    def __init__(self) -> None:
        self.delay = 0.0
        self.calls = 0

    def verify_batch_mask(self, messages, keys, signatures, **_kw):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return [True] * len(messages)


@pytest.mark.parametrize("name", list(PKGS))
def test_service_feeds_the_watchdog_after_each_dispatch(traced, name):
    """32 flushes of 16 lanes at no cost, then 8 that sleep 20 ms: the
    service's own watchdog fires `verify_regression` once, on the 40th
    flush, with the first 32 flushes' median as its baseline."""
    tracing, batch_service, public_key, signature = PKGS[name]
    backend = _StubBackend()
    fired = []
    hook = lambda reason, detail: fired.append((backend.calls, reason, detail))  # noqa: E731
    tracing.WATCHDOG.add_dump_hook(hook)
    msgs = [b"m%02d" % i for i in range(16)]
    pairs = [(public_key(bytes([i]) * 32), signature(bytes([i]) * 64)) for i in range(16)]

    async def body():
        service = batch_service.BatchVerificationService(backend, inline=True)
        for flush in range(40):
            backend.delay = 0.0 if flush < 32 else 0.02
            mask = await service.verify_group(msgs, pairs, source="mempool", dedup=False)
            assert mask == [True] * 16

    try:
        asyncio.run(body())
    finally:
        tracing.WATCHDOG.remove_dump_hook(hook)
    assert backend.calls == 40
    assert [(calls, reason) for calls, reason, _ in fired] == [(40, "verify_regression")]
    detail = fired[0][2]
    assert detail["per_sig_s"] >= 0.02 / 16 > 4 * detail["baseline_s"]
    assert [t["reason"] for t in tracing.WATCHDOG.triggers] == ["verify_regression"]
    assert [e["kind"] for e in tracing.RECORDER.events()].count("watchdog.verify_regression") == 1


@pytest.mark.parametrize("name", list(PKGS))
def test_service_feeds_no_sample_with_tracing_off(traced, name):
    tracing, batch_service, public_key, signature = PKGS[name]
    tracing.enable(False)
    backend = _StubBackend()

    async def body():
        service = batch_service.BatchVerificationService(backend, inline=True)
        for _ in range(40):
            await service.verify_group([b"m"], [(public_key(bytes(32)), signature(bytes(64)))],
                                       source="mempool", dedup=False)

    asyncio.run(body())
    assert backend.calls == 40
    assert tracing.WATCHDOG._verify_samples == [] and tracing.WATCHDOG._verify_baseline is None
