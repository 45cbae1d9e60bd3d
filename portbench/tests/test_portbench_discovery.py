"""A configuration, a mix and a metric are files found by name: one
dropped into a fresh tree is picked up with no code changed."""

import json
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_files_dropped_into_a_tree_are_found_by_name(tmp_path):
    (tmp_path / "portbench/configs").mkdir(parents=True)
    (tmp_path / "portbench/traffic").mkdir()
    (tmp_path / "portbench/metrics").mkdir()
    (tmp_path / "portbench/configs/tiny-cfg.json").write_text(json.dumps({"nodes": 4, "quorum": 3}))
    (tmp_path / "portbench/traffic/trickle.json").write_text(json.dumps({"lanes": [], "warmup_s": 0}))
    (tmp_path / "portbench/metrics/new.metric.py").write_text("def read(r):\n    return 42.0\n")
    (tmp_path / "portbench/metrics/other.py").write_text("def read(r):\n    return None\n")
    bench = {
        "configs": [{"name": "tiny-cfg", "file": "portbench/configs/tiny-cfg.json"}],
        "workloads": [{"name": "tiny-trickle", "config": "tiny-cfg", "traffic": "trickle", "chips": 1},
                      {"name": "elsewhere", "config": "tiny-cfg", "traffic": "trickle", "chips": 1}],
        "end_to_end": [{"name": "new.metric", "unit": "s"}],
        "per_layer": [{"name": "other", "unit": "%", "workloads": ["elsewhere"]}],
    }
    cell = harness.load_cell(bench, "tiny-trickle", root=tmp_path)
    assert cell.config == {"nodes": 4, "quorum": 3} and cell.traffic["lanes"] == []
    assert [m["name"] for m in cell.end_to_end] == ["new.metric"] and cell.per_layer == []
    assert cell.readers["new.metric"](None) == 42.0
    assert harness.load_cell(bench, "elsewhere", root=tmp_path).readers["other"](None) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(bench, w["name"])
        assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        # A per-layer metric is read only where the metric it moves is.
        assert {m["moves"] for m in cell.per_layer} <= e2e
