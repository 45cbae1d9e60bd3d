"""The port's `DeviceTimeline` (`hotstuff_tpu_torch/ops/timeline.py`)
against the reference's (`hotstuff_tpu/ops/timeline.py`): the same
intervals fed to both give equal `summary()`, `intervals()`, ring bounds and
dump keys, exactly."""

import json

import numpy as np
import pytest

from hotstuff_tpu.ops import timeline as ref
from hotstuff_tpu_torch.ops import timeline as port

# (batch, chunk, phase, t0, t1, n) sets: the hand-computed cases of
# tests/test_timeline.py, then seeded random ones.
HAND = {
    "empty": [],
    "occupancy_and_gaps": [
        (1, 0, "upload", 0.0, 1.0, 64),
        (1, 0, "dispatch", 1.0, 2.0, 64),
        (1, 0, "readback", 5.0, 6.0, 64),
        (1, 0, "stage", 9.0, 10.0, 64),
    ],
    "headroom_pairs": [
        (1, 0, "upload", 0.0, 1.0, 64),
        (1, 0, "dispatch", 1.0, 3.0, 64),
        (1, 1, "upload", 3.0, 4.0, 64),
        (1, 1, "dispatch", 4.0, 4.5, 64),
        (1, 2, "upload", 4.5, 7.5, 64),
        (2, 0, "upload", 8.0, 9.0, 64),
    ],
}


def _random(seed: int, n: int) -> list:
    """n intervals over 3 batches of 6 chunks, overlapping at random."""
    rng = np.random.default_rng(seed)
    phases = ("stage", "upload", "dispatch", "readback")
    out = []
    for _ in range(n):
        t0 = float(rng.uniform(0.0, 0.05))
        out.append((int(rng.integers(1, 4)), int(rng.integers(0, 6)), phases[int(rng.integers(0, 4))],
                    t0, t0 + float(rng.uniform(0.0, 0.004)), int(rng.integers(1, 4097))))
    return out


CASES = {**HAND, **{f"random{s}": _random(s, 40 + 30 * s) for s in range(4)}}


def _both(intervals, capacity=256):
    tls = ref.DeviceTimeline(capacity=capacity), port.DeviceTimeline(capacity=capacity)
    for tl in tls:
        for iv in intervals:
            tl.note(*iv)
    return tls


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_intervals_same_summary(case):
    r, p = _both(CASES[case])
    assert p.summary() == r.summary()
    assert p.intervals() == r.intervals()
    assert (len(p), p.dropped) == (len(r), r.dropped)


def test_hand_computed_summary_values():
    _, p = _both(HAND["occupancy_and_gaps"])
    s = p.summary()
    assert (s["chunks"], s["batches"], s["span_s"], s["occupancy"]) == (1, 1, 10.0, 0.3)
    assert s["idle"] == {"count": 1, "total_s": 3.0, "p50_s": 3.0, "max_s": 3.0}
    _, p = _both(HAND["headroom_pairs"])
    assert p.summary()["overlap_headroom"] == round(1.5 / 6.0, 6)


def test_ring_bound_evicts_oldest_on_both():
    ivs = [(1, i, "upload", float(i), float(i) + 0.5, 8) for i in range(20)]
    r, p = _both(ivs, capacity=16)
    assert len(p) == len(r) == 16 and p.dropped == r.dropped == 4
    assert p.intervals() == r.intervals() and p.intervals()[0]["chunk"] == 4
    assert p.summary() == r.summary()
    p.reset()
    assert len(p) == 0 and p.dropped == 0 and p.summary() == ref.DeviceTimeline(capacity=16).summary()


def test_span_backdate_and_disabled_gate():
    tl = port.DeviceTimeline(capacity=16)
    with port.span("readback", 3, 1, 42, timeline=tl, start=0.0):
        pass
    with port.span_for("upload", None):
        pass
    (iv,) = tl.intervals()
    assert (iv["phase"], iv["batch"], iv["chunk"], iv["n"], iv["t0"]) == ("readback", 3, 1, 42, 0.0)
    port.enable(False)
    try:
        assert port.span("upload", 1, 0, timeline=tl) is port.NULL
        tl.note(1, 0, "upload", 0.0, 1.0, 8)
        assert len(tl) == 1
    finally:
        port.enable(True)
    assert port.PHASES == ref.PHASES and port.DEVICE_PHASES == ref.DEVICE_PHASES


def test_dump_has_the_reference_keys(tmp_path):
    r, p = _both(HAND["headroom_pairs"])
    dr, dp = r.dump(), p.dump()
    assert dp.keys() == dr.keys() and dp["anchor"].keys() == dr["anchor"].keys()
    for key in ("v", "kind", "node", "capacity", "recorded", "dropped", "intervals", "summary"):
        assert dp[key] == dr[key], key
    path = tmp_path / "tl.json"
    p.write_json(str(path))
    assert json.loads(path.read_text())["summary"] == r.summary()
