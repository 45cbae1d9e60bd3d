"""The comparison that decides `correct` fails when the timed path is
broken underneath: a whole run on the CPU (the program's plain kernels,
a tiny configuration), past the look for a card, with the control or a
fault of `faults.py` put under the service once the window opens."""

import json
import time
from pathlib import Path

import pytest

from portbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(bench, "n50-flood")
    cell.config = dict(cell.config, nodes=4, quorum=3, payload_triples=16, synthetic_pool_size=64)
    cell.traffic = dict(cell.traffic, corrupt_share=0.25, warmup_s=0.5)
    cell.traffic["lanes"] = [dict(lane) for lane in cell.traffic["lanes"]]
    cell.traffic["lanes"][0]["in_flight"] = 2
    return cell


def run(wrap=None, grace_s=harness.GRACE_S):
    return harness.run(tiny_cell(), 2**33 + 17, 2.0, False, time.perf_counter(), device="cpu", wrap=wrap,
                       grace_s=grace_s, workers=1)


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["lanes_compared"] > 0, r["checks"]
    # The card's kernel time needs the card's trace: on the CPU only set-up is read.
    assert set(r["metrics"]) == {"setup_s"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", ["group_verdict", "stale", "half", "flip"])
def test_a_wrong_answer_fails(name):
    r = run(faults.FAULTS[name])
    assert not r["correct"] and r["checks"]["lane_mismatches"]["value"] > 0


def test_an_answer_that_never_comes_fails(monkeypatch):
    monkeypatch.setattr(faults.Silent, "silent_s", 4.0)
    r = run(faults.Silent, grace_s=1.0)
    assert not r["correct"] and r["checks"]["unanswered_groups"]["value"] > 0
