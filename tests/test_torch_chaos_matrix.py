"""The port's scenario matrix (`chaos/scenarios.py` `run_matrix_cell` and
its grid, `utils/telemetry.fleet_rollup`, `python -m
hotstuff_tpu_torch.chaos_run --matrix`) held against the reference's on
the CPU.

A cell runs on the host by design in both packages (the chaos plane's
`PurePythonBackend`, or the trusted-crypto stub from 16 nodes up), so the
reference is an exact oracle: a cell's record is equal field for field
but `wall_seconds`, and the matrix artifact of a one-cell grid is equal
but its wall fields (`generated_wall`, `summary.wall_seconds`, each
cell's `wall_seconds`). The regression contract (rc 1 when a cell the
baseline recorded green comes back red) is the reference's
(`tests/test_harness.py`). Each cell runs from zeroed gauges and with the
watchdog's wall-clock verify trigger held off, in both packages
(`tests/common_torch_chaos.py`).
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from hotstuff_tpu.chaos import scenarios as r_scenarios
from hotstuff_tpu.utils.telemetry import fleet_rollup as r_fleet_rollup
from hotstuff_tpu_torch import chaos_run as p_chaos_run
from hotstuff_tpu_torch.chaos import scenarios as p_scenarios
from hotstuff_tpu_torch.chaos.plan import FaultPlan, LinkFaults
from hotstuff_tpu_torch.utils.telemetry import fleet_rollup as p_fleet_rollup
from tests.common_torch_chaos import NO_VERIFY_TRIGGER_ENV, chaos_process_state  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def _without_wall(cell: dict) -> dict:
    return {k: v for k, v in cell.items() if k != "wall_seconds"}


# --- the grid ------------------------------------------------------------------


def test_grid_and_cell_names_equal_the_reference():
    for name in ("MATRIX_SCENARIOS", "MATRIX_SEEDS", "MATRIX_SIZES", "MATRIX_CELL_DURATION_S",
                 "TRUSTED_CRYPTO_MIN_N"):
        assert getattr(p_scenarios, name) == getattr(r_scenarios, name), name
    assert all(s in p_scenarios.SCENARIOS for s in p_scenarios.MATRIX_SCENARIOS)
    for s in p_scenarios.MATRIX_SCENARIOS:
        ps, rs = p_scenarios.SCENARIOS[s], r_scenarios.SCENARIOS[s]
        assert (ps.matrix_sizes, ps.cell_duration, ps.trusted_crypto) == \
            (rs.matrix_sizes, rs.cell_duration, rs.trusted_crypto), s
    assert p_scenarios.cell_name("flood", 2, 64) == r_scenarios.cell_name("flood", 2, 64) == "flood@s2/n64"
    assert p_scenarios.matrix_telemetry_config() == p_scenarios.TelemetryConfig(
        **vars(r_scenarios.matrix_telemetry_config()))
    with pytest.raises(ValueError, match="sometimes"):
        p_scenarios.run_matrix_cell("baseline", seed=1, n=4, trusted="sometimes")


@pytest.mark.parametrize("n, trusted, crypto_mode", [(4, "off", "exact"), (64, "auto", "trusted-stub")])
def test_matrix_cell_equals_the_reference(n, trusted, crypto_mode):
    ref = r_scenarios.run_matrix_cell("baseline", seed=1, n=n, trusted=trusted)
    port = p_scenarios.run_matrix_cell("baseline", seed=1, n=n, trusted=trusted)
    assert port["cell"] == f"baseline@s1/n{n}" and port["green"] is True
    assert port["crypto_mode"] == crypto_mode and port["wall_seconds"] > 0
    assert port["rollup"]["commits"]["min_node"] >= 4
    assert port["violations"] == {"safety": [], "liveness": [], "expectations": []}
    assert _without_wall(port) == _without_wall(ref)


# --- fleet_rollup on synthetic reports -------------------------------------------


def _synthetic_reports() -> dict[str, dict]:
    """The reference's synthetic reports (`tests/test_fleet.py`,
    `tests/test_election.py`) and the variants they step through."""
    fleet = {
        "nodes": 2,
        "ok": True,
        "crypto_mode": "trusted-stub",
        "wan_regions": {"0": "eu-west", "1": "us-east"},
        "virtual_seconds": 10.0,
        "safety_violations": [],
        "liveness_violations": [],
        "expectation_failures": [],
        "commit_times": {"0": [1.0, 2.0, 3.0], "1": [1.5, 2.5]},
        "epoch_switches": {"0": [{"epoch": 2}], "1": [{"epoch": 2}]},
        "metrics": {"sync.range_blocks": 7, "wan.frames": 40, "net.frames_sent": 9},
        "fault_trace_truncated": True,
        "telemetry": {
            "0": {
                "snapshots": [{"seq": 0}, {"seq": 1}],
                "lanes": {"consensus": {"count": 10, "p50_ms": 1.0, "p99_ms": 2.0, "max_ms": 3.0}},
                "alerts": [{"event": "fired"}, {"event": "cleared"}],
                "active_alerts": [],
                "device": {"occupancy": 0.9},
            },
            "1": {
                "snapshots": [{"seq": 0}],
                "lanes": {"consensus": {"count": 10, "p50_ms": 1.0, "p99_ms": 4.0, "max_ms": 5.0}},
                "alerts": [],
                "active_alerts": ["lane.mempool"],
                "device": {"occupancy": 0.7},
            },
        },
    }
    with_bytes = copy.deepcopy(fleet)
    with_bytes["metrics"]["agg.cert_bytes_committed"] = 660
    starved = copy.deepcopy(with_bytes)
    starved["commits"] = {"0": [[1, "d1"], [2, "d2"], [3, "d3"]], "1": [[1, "d1"], [2, "d2"]], "2": []}
    base = {"nodes": 4, "virtual_seconds": 10.0, "ok": True, "commits": {}}
    election = {**base, "metrics": {"elect.rounds": 200, "elect.leader_region_matches": 150,
                                    "elect.cross_region_hops": 50, "elect.cross_region_hops_blind": 150}}
    base3 = {"nodes": 3, "virtual_seconds": 10.0, "ok": True, "commits": {}}
    partial = {**base3, "metrics": {}, "peers": {"0": {"1": {"rtt_ewma_ms": 62.0}}, "1": {"0": {"rtt_ewma_ms": 62.0}}}}
    rtt = {(0, 1): 5.0, (0, 2): 80.0, (1, 2): 82.0}
    full = {**base3, "metrics": {}, "peers": {
        str(a): {str(b): {"rtt_ewma_ms": rtt[tuple(sorted((a, b)))]} for b in range(3) if b != a} for a in range(3)}}
    scheduler_only = {"nodes": 2, "virtual_seconds": 4.0, "ok": False, "liveness_violations": ["stalled"],
                      "commits": {"0": [[1, "d"]], "1": []},
                      "scheduler": {"0": {"queue_delay": {"consensus": {"count": 4, "p50_ms": 2.0, "p99_ms": 9.0,
                                                                        "max_ms": 9.5}}},
                                    "1": None},
                      "health": {"verdict": "degraded"}}
    return {"fleet": fleet, "with_bytes": with_bytes, "starved": starved, "election": election,
            "no_election": {**base, "metrics": {}}, "partial_rtt": partial, "full_rtt": full,
            "no_rtt": {**base3, "peers": {}, "metrics": {}}, "scheduler_only": scheduler_only, "empty": {}}


@pytest.mark.parametrize("name", sorted(_synthetic_reports()))
def test_fleet_rollup_equals_the_reference(name):
    report = _synthetic_reports()[name]
    port = p_fleet_rollup(copy.deepcopy(report))
    assert port == r_fleet_rollup(copy.deepcopy(report))
    if name == "starved":
        assert port["commits"] == {"total": 5, "rate_per_s": 0.5, "min_node": 0, "max_node": 3,
                                   "bytes_per_committed_round": 132.0}
    if name == "full_rtt":
        assert port["peer_rtt"]["region_count"] == 2 and port["peer_rtt"]["coverage"] == 1.0


# --- python -m hotstuff_tpu_torch.chaos_run --matrix -----------------------------------


WALL_FIELDS = ("generated_wall",)


def _artifact_without_wall(artifact: dict) -> dict:
    out = {k: v for k, v in artifact.items() if k not in WALL_FIELDS}
    out["summary"] = {k: v for k, v in artifact["summary"].items() if k != "wall_seconds"}
    out["cells"] = [_without_wall(c) for c in artifact["cells"]]
    return out


def test_matrix_cli_writes_the_reference_tools_artifact(tmp_path):
    """A one-cell grid through both tools, in a scratch working directory,
    against the repo's newest committed matrix as the baseline: the same
    stdout verdict lines and an equal artifact but for its wall fields."""
    grid = ["--matrix", "--matrix-scenarios", "baseline", "--matrix-seeds", "1", "--matrix-sizes", "4",
            "--baseline", str(REPO / "CHAOS_MATRIX_r08.json")]
    runs = {}
    for name, argv in (("reference", [sys.executable, str(REPO / "tools" / "chaos_run.py")]),
                       ("port", [sys.executable, "-m", "hotstuff_tpu_torch.chaos_run"])):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run(argv + grid + ["--report", str(out)], cwd=tmp_path, capture_output=True, text=True,
                              timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                                        **NO_VERIFY_TRIGGER_ENV))
        assert proc.returncode == 0, proc.stderr[-2000:]
        runs[name] = (proc.stdout, json.loads(out.read_text()))
    (p_out, port), (r_out, ref) = runs["port"], runs["reference"]
    assert sorted(tmp_path.iterdir()) == [tmp_path / "port.json", tmp_path / "reference.json"]
    assert port["kind"] == "chaos_matrix" and port["summary"]["cells"] == port["summary"]["green"] == 1
    reg = port["regression"]
    assert reg["newly_red"] == [] and reg["commit_rate_deltas"] == {"baseline@s1/n4": 0.0}
    assert len(reg["missing_from_run"]) == 47
    assert _artifact_without_wall(port) == _artifact_without_wall(ref)

    def verdict_lines(out: str) -> list[str]:
        return [line.split(" wall=")[0] for line in out.splitlines() if line.startswith("MATRIX")
                and "written to" not in line]

    assert verdict_lines(p_out) == verdict_lines(r_out)
    assert "MATRIX result: 1 green / 0 red of 1 cells" in p_out


def test_matrix_auto_numbering_and_baseline_discovery_equal_the_reference(tmp_path):
    spec = importlib.util.spec_from_file_location("ref_chaos_run", REPO / "tools" / "chaos_run.py")
    r_chaos_run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(r_chaos_run)

    assert p_chaos_run._next_matrix_path(str(tmp_path)) == str(tmp_path / "CHAOS_MATRIX_r01.json")
    for name in ("CHAOS_MATRIX_r02.json", "CHAOS_MATRIX_r10.json", "CHAOS_MATRIX_rx.json", "other.json"):
        (tmp_path / name).write_text("{}")
    d = str(tmp_path)
    assert p_chaos_run._matrix_revisions(d) == r_chaos_run._matrix_revisions(d)
    assert p_chaos_run._next_matrix_path(d) == r_chaos_run._next_matrix_path(d) == \
        str(tmp_path / "CHAOS_MATRIX_r11.json")
    newest = str(tmp_path / "CHAOS_MATRIX_r10.json")
    assert p_chaos_run._latest_matrix_baseline(d, exclude=newest) == \
        r_chaos_run._latest_matrix_baseline(d, exclude=newest) == str(tmp_path / "CHAOS_MATRIX_r02.json")


def test_matrix_regression_rc1_when_a_green_cell_goes_red(monkeypatch, tmp_path, capsys):
    """rc 2 for a red cell without a baseline; rc 1 when the baseline
    recorded it green (the flip ranks above plain red); rc 3 for an
    unknown grid scenario and for an unreadable baseline."""
    rigged = p_scenarios.Scenario(
        name="rigged_red",
        description="always fails its expectation (test fixture)",
        plan=lambda: FaultPlan(default_link=LinkFaults(delay=0.01)),
        duration=3.0,
        min_commits=1,
        expect=lambda report, deltas: ["forced red (fixture)"],
    )
    monkeypatch.setitem(p_scenarios.SCENARIOS, "rigged_red", rigged)
    monkeypatch.chdir(tmp_path)
    grid = ["--matrix", "--matrix-scenarios", "rigged_red", "--matrix-seeds", "1", "--matrix-sizes", "4",
            "--trusted", "on"]
    out1 = tmp_path / "m1.json"
    assert p_chaos_run.main(grid + ["--report", str(out1)]) == 2
    assert "rigged_red@s1/n4 red" in capsys.readouterr().out
    first = json.loads(out1.read_text())
    assert first["regression"] == {"baseline": None}

    doctored = json.loads(out1.read_text())
    doctored["cells"][0]["green"] = True
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps(doctored))
    assert p_chaos_run.main(grid + ["--report", str(tmp_path / "m2.json"), "--baseline", str(baseline)]) == 1
    assert "MATRIX regression: rigged_red@s1/n4 went red (was green)" in capsys.readouterr().out
    second = json.loads((tmp_path / "m2.json").read_text())
    assert second["regression"]["newly_red"] == ["rigged_red@s1/n4"]

    assert p_chaos_run.main(["--matrix", "--matrix-scenarios", "no_such_cell"]) == 3
    (tmp_path / "torn.json").write_text("{")
    assert p_chaos_run.main(grid + ["--report", str(tmp_path / "m3.json"), "--baseline",
                                    str(tmp_path / "torn.json")]) == 3
    assert not (tmp_path / "m3.json").exists()
    assert p_chaos_run.main(["--matrix", "--jobs", "0"]) == 3
