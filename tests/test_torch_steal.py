"""Cross-backend work stealing in the port's batch service and scheduler
(`crypto/batch_service.py` `steal_backends`, `crypto/scheduler.py`
`n_backends`, `pipeline.steals`) against the reference's, with stub
backends in both packages: the reference's three cases
(`tests/test_scheduler.py`) give equal masks, dispatch sizes and steals,
and with no steal backend the port's scheduler is what it was.

The reference's third case turns stealing off through its inline
(virtual-time) mode; the port's inline mode is given the same steal
backend and must turn stealing off the same way.
"""

from __future__ import annotations

import asyncio
import threading

import pytest

from hotstuff_tpu.crypto.backend import CryptoBackend as RCryptoBackend
from hotstuff_tpu.crypto.batch_service import BatchVerificationService as RService
from hotstuff_tpu.crypto.primitives import PublicKey as RPublicKey
from hotstuff_tpu.crypto.primitives import Signature as RSignature
from hotstuff_tpu.utils import metrics as r_metrics
from hotstuff_tpu_torch.crypto import scheduler as p_scheduler
from hotstuff_tpu_torch.crypto.backend import CryptoBackend
from hotstuff_tpu_torch.crypto.batch_service import BatchVerificationService
from hotstuff_tpu_torch.crypto.primitives import PublicKey, Signature
from hotstuff_tpu_torch.utils import metrics as p_metrics


def _stub(base):
    class StubBackend(base):
        """Accepts every lane and records each dispatch's size; with a gate,
        each call parks until it is set."""

        name = "stub"

        def __init__(self, gate: threading.Event | None = None):
            self.calls: list[int] = []
            self._gate = gate

        def verify_batch_mask(self, messages, keys, signatures, **_kw):
            self.calls.append(len(messages))
            if self._gate is not None:
                self._gate.wait(timeout=5)
            return [True] * len(messages)

    return StubBackend


PKGS = {
    "reference": dict(service=RService, stub=_stub(RCryptoBackend), pk=RPublicKey, sig=RSignature,
                      metrics=r_metrics, no_steal=lambda stub: {"inline": True, "steal_backends": [stub()]}),
    "port": dict(service=BatchVerificationService, stub=_stub(CryptoBackend), pk=PublicKey, sig=Signature,
                 metrics=p_metrics, no_steal=lambda stub: {"inline": True, "steal_backends": [stub()]}),
}


def _group(pkg, n: int, tag: bytes):
    pairs = [(pkg["pk"](b"\x01" * 32), pkg["sig"](b"\x02" * 64))] * n
    return [tag + bytes([i % 256, i // 256]) for i in range(n)], pairs


def _home_full_then_steal(name: str) -> dict:
    """With both of the home backend's bulk slots held by dispatches in
    flight (the reference's case with its default two slots), the next
    bulk bucket ships to the sibling."""
    pkg = PKGS[name]

    async def body():
        gate = threading.Event()
        home, sibling = pkg["stub"](gate), pkg["stub"]()
        svc = pkg["service"](home, use_scheduler=True, steal_backends=[sibling])
        n_backends = svc.scheduler.n_backends
        parked = []
        for n, tag in ((8, b"a"), (6, b"c")):
            m, p = _group(pkg, n, tag)
            parked.append(asyncio.ensure_future(svc.verify_group(m, p, source="mempool", dedup=False)))
            for _ in range(400):  # until this dispatch is in flight on home
                if len(home.calls) == len(parked):
                    break
                await asyncio.sleep(0.005)
        m2, p2 = _group(pkg, 4, b"b")
        mask2 = await asyncio.wait_for(svc.verify_group(m2, p2, source="mempool", dedup=False), 5.0)
        calls = (list(home.calls), list(sibling.calls))
        gate.set()
        masks = [await asyncio.wait_for(f, 5.0) for f in parked]
        return dict(n_backends=n_backends, masks=[*masks, mask2], calls=calls, steals=svc.scheduler.stats["steals"])

    before = pkg["metrics"].counter("pipeline.steals").value
    out = asyncio.run(asyncio.wait_for(body(), 30))
    out["counted"] = pkg["metrics"].counter("pipeline.steals").value - before
    return out


def _critical_stays_home(name: str) -> dict:
    pkg = PKGS[name]

    async def body():
        home, sibling = pkg["stub"](), pkg["stub"]()
        svc = pkg["service"](home, use_scheduler=True, steal_backends=[sibling])
        m, p = _group(pkg, 3, b"q")
        mask = await svc.verify_group(m, p, source="consensus", dedup=False)
        return dict(masks=[mask], calls=(home.calls, sibling.calls), steals=svc.scheduler.stats["steals"])

    return asyncio.run(asyncio.wait_for(body(), 30))


def _stealing_off(name: str) -> dict:
    pkg = PKGS[name]

    async def body():
        home = pkg["stub"]()
        svc = pkg["service"](home, **pkg["no_steal"](pkg["stub"]))
        m, p = _group(pkg, 2, b"m")
        mask = await svc.verify_group(m, p, source="mempool", dedup=False)
        return dict(n_backends=svc.scheduler.n_backends, steal_backends=list(svc._steal_backends), masks=[mask],
                    calls=home.calls, steals=svc.scheduler.stats["steals"])

    return asyncio.run(asyncio.wait_for(body(), 30))


CASES = {"home full, then steal": _home_full_then_steal, "critical stays home": _critical_stays_home,
         "stealing off": _stealing_off}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stealing_matches_the_reference(case):
    port, ref = CASES[case]("port"), CASES[case]("reference")
    assert port == ref
    if case == "home full, then steal":
        assert port["calls"] == ([8, 6], [4]) and port["steals"] == port["counted"] == 1 and port["n_backends"] == 2
    elif case == "critical stays home":
        assert port["calls"] == ([3], []) and port["steals"] == 0
    else:
        assert port["n_backends"] == 1 and port["steal_backends"] == [] and port["steals"] == 0


def test_one_backend_dispatches_as_before():
    """With no steal backend the scheduler keeps one account and calls its
    dispatch hook with three arguments, as before stealing."""
    seen = []

    class Task:
        def add_done_callback(self, fn):
            seen.append(fn)

    sched = p_scheduler.DeviceScheduler(lambda *a: seen.append(a) or Task(), max_batch=4)
    assert sched.n_backends == 1 and sched._inflight == [0] and p_scheduler.BULK_CONCURRENCY == 2

    class Group:
        source, t_submit, t_dequeue = "mempool", 0.0, 0.0

        def __len__(self):
            return 4

    async def body():
        for _ in range(3):
            sched.submit(Group())
        loop_task = asyncio.ensure_future(sched.run())
        await asyncio.sleep(0.05)
        loop_task.cancel()

    asyncio.run(body())
    dispatches = [a for a in seen if isinstance(a, tuple)]
    # Two buckets fill both slots of the one backend; the third waits.
    assert [len(a) for a in dispatches] == [3, 3] and sched._inflight == [2]
    assert sched.stats["steals"] == 0 and sched.depth() == 1
