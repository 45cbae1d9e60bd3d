"""The port's flight recorder (`hotstuff_tpu_torch/utils/tracing.py`)
against the reference's (`hotstuff_tpu/utils/tracing.py`): the same events
under a fixed clock give the same dump, key for key, in both packages."""

from __future__ import annotations

import json

import pytest

from hotstuff_tpu.utils import metrics as ref_metrics
from hotstuff_tpu.utils import tracing as ref_tracing
from hotstuff_tpu_torch.utils import metrics, tracing


@pytest.fixture
def fixed_clocks():
    """Both recorders cleared, enabled and on a clock that steps 0.25 s a
    read; restored after."""
    ticks = {"port": 0, "ref": 0}

    def clock(pkg):
        def read():
            ticks[pkg] += 1
            return 1000.0 + 0.25 * ticks[pkg]
        return read

    prev = tracing.set_clock(clock("port")), ref_tracing.set_clock(clock("ref"))
    was = tracing.enabled(), ref_tracing.enabled()
    tracing.enable(True)
    ref_tracing.enable(True)
    tracing.reset()
    ref_tracing.reset()
    metrics.reset()
    ref_metrics.reset()
    yield
    tracing.set_clock(prev[0])
    ref_tracing.set_clock(prev[1])
    tracing.enable(was[0])
    ref_tracing.enable(was[1])
    tracing.reset()
    ref_tracing.reset()


def _record(mod):
    tid = mod.trace_id(0, bytes(range(32)))
    mod.event("ingress.recv", tid)
    mod.event("ingress.admit", tid, lane=2)
    mod.event("verify.batch", tid, 0.00123456789, n=64, flush=64, lane="ingress", queue_s=0.002)
    mod.event("ingress.reject", tid, status="bad_signature")
    mod.event("ingress.forward", mod.trace_id(7, b"\xff" * 32))
    mod.event("ingress.shed", None, status="shed", retry_after_ms=50)


def _without_wall(dump: dict) -> dict:
    return {**dump, "anchor": {"mono": dump["anchor"]["mono"]}}


def test_dump_has_the_references_layout(fixed_clocks, tmp_path):
    _record(tracing)
    _record(ref_tracing)
    ours, theirs = tracing.dump(), ref_tracing.dump()
    assert set(ours) == set(theirs) == {"v", "enabled", "node", "capacity", "recorded", "dropped", "anchor",
                                        "events"}
    assert _without_wall(ours) == _without_wall(theirs)
    assert ours["recorded"] == 6 and ours["node"] is None and "node" not in ours["events"][4]
    assert ours["events"][2]["dur"] == 0.001235 and ours["events"][0]["trace"] == "r0-0001020304050607"
    path = tmp_path / "trace.json"
    tracing.write_json(str(path))
    assert json.loads(path.read_text())["events"] == ours["events"]
    assert metrics.counter("trace.events").value == ref_metrics.counter("trace.events").value == 6
    assert metrics.counter("trace.dumps").value == 2


def test_disabled_recorder_records_nothing(fixed_clocks):
    tracing.enable(False)
    _record(tracing)
    assert len(tracing.RECORDER) == 0 and tracing.dump()["enabled"] is False
    tracing.enable(True)
    tracing.event("ingress.recv", "r0-00")
    assert len(tracing.RECORDER) == 1


def test_ring_drops_the_oldest_as_the_reference(fixed_clocks):
    ours, theirs = tracing.FlightRecorder(capacity=16), ref_tracing.FlightRecorder(capacity=16)
    for rec in (ours, theirs):
        for i in range(40):
            rec.record("ingress.recv", f"r{i}-00", None, {"i": i})
    assert ours.dropped == theirs.dropped == 24 and len(ours) == 16
    assert ours.events() == theirs.events() and ours.events()[0]["data"] == {"i": 24}
    assert tracing.FlightRecorder(capacity=3).capacity == 16
    assert metrics.counter("trace.dropped").value == ref_metrics.counter("trace.dropped").value == 24
