"""On the card, at the cell's own size: a sound run of each cell is
correct, and the control (each call's lanes answered by one verdict for
the call) is not. Run on the chip: `python -m pytest portbench/tests -q -m card`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def run_cell(*args):
    out = subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["n50-flood"])
def test_a_sound_run_is_correct(card, cell):
    r = run_cell("--workload", cell, "--seed", "4100000001", "--seconds", "5", "--trace", "0")
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["n50-flood"])
def test_the_control_is_not_correct(card, cell):
    r = run_cell("--workload", cell, "--seed", "4100000002", "--seconds", "5", "--trace", "0",
                 "--fault", "group_verdict")
    assert not r["correct"] and r["checks"]["lane_mismatches"]["value"] > 0
