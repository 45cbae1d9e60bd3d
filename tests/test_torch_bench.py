"""The port's bench (`python -m hotstuff_tpu_torch.bench`) on the CPU, each
leg in-process at 128 lanes on the kernels' plain versions: its workloads
are the reference bench's byte for byte, its legs pass their mask gates,
its JSON line has the reference's keys and the card's, its metrics and
trace dumps read back in the registries' layouts, and what it does not
port it refuses. The ingress, scheduler A/B and AggQC legs
(`tests/test_torch_aggregate_ab.py`) run at wall-clock legs of 0.5 s."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hotstuff_tpu_torch import bench
from hotstuff_tpu_torch.ops import bit_ladder, ladder
from hotstuff_tpu_torch.utils import metrics
from tests.common_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--batch", "128", "--device-batch", "128", "--chunk", "128",
         "--iters", "1", "--e2e-iters", "1", "--cpu-budget", "0.05"]
# The reference's keys of the default line (`bench.py:1243-1266`) with
# --committee-cache, and what the port adds.
REFERENCE_KEYS = {"metric", "value", "unit", "vs_baseline", "e2e_value", "e2e_vs_baseline", "cpu_multicore",
                  "backend", "committee_cache", "committee_value", "occupancy", "overlap_headroom",
                  "device_timeline"}
PORT_KEYS = {"device", "power_limit_w"}


def _ref_bench():
    sys.path.insert(0, str(REPO))
    import bench as ref  # the root bench.py

    return ref


def test_workloads_are_the_reference_benchs_byte_for_byte():
    import __graft_entry__

    ref = _ref_bench()
    assert bench.signed_batch(128) == __graft_entry__._signed_batch(128)
    assert bench.signed_batch(5, msg_len=33, seed=4) == __graft_entry__._signed_batch(5, 33, 4)
    for committee in (4, 64):
        assert bench.qc_batch(committee, 128) == ref._qc_batch(committee, 128)
    assert bench.pipeline_workload(20) == ref._pipeline_workload(20)


def test_the_reference_bench_imports_no_jax_at_module_level():
    probe = "import sys, bench; print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib')))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_default_leg_with_committee_cache_and_metrics_out(tmp_path, capsys):
    metrics.reset()
    path = tmp_path / "metrics.json"
    line = bench.main(SMALL + ["--committee-cache", "on", "--metrics-out", str(path)])
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert set(line) == REFERENCE_KEYS | PORT_KEYS
    assert line["backend"] == "cpu" and line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["value"] > 0 and line["e2e_value"] > 0 and line["committee_value"] > 0
    assert line["committee_cache"] == "on" and line["metric"] == "votes_verified_per_sec"
    assert "committee-cache=on: 1 x 86 sigs -> table_builds +0, decompressions +0" in err
    dump = json.loads(path.read_text())
    assert set(dump) == {"v", "enabled", "counters", "gauges", "histograms"}
    assert dump == json.loads(json.dumps(metrics.dump()))
    for name in ("crypto.tpu_batches", "crypto.cpu_batches", "verifier.crossover_fallbacks",
                 "verifier.committee_misses", "verifier.rejected_sigs", "verifier.committee_rejected_sigs"):
        assert name in dump["counters"]
    assert dump["counters"]["verifier.committee_sigs"] == 2 * 86
    assert set(dump["histograms"]["crypto.batch_size"]["buckets"]) == {"le", "counts"}


def test_committee_cache_off_runs_the_generic_kernels(capsys):
    line = bench.main(SMALL + ["--committee-cache", "off", "--mesh", "2"])
    assert line["committee_cache"] == "off" and line["committee_value"] > 0 and line["mesh_devices"] == 2
    assert "committee-cache=off: 1 x 86 sigs -> table_builds +1, decompressions +86" in capsys.readouterr().err


def test_kernel_bits_runs_k7s_plain_version(monkeypatch):
    calls = []
    plain = bit_ladder.bit_ladder_plain
    monkeypatch.setattr(bit_ladder, "bit_ladder_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    monkeypatch.setattr(ladder, "ladder_plain", lambda *a: pytest.fail("K1 ran on the bits leg"))
    line = bench.main(SMALL + ["--kernel", "bits", "--device-batch", "64"])
    assert line["value"] > 0 and line["e2e_value"] > 0
    # bench_device's gate and timed run at 64 lanes, the verifier's gate and run at its 128-lane bucket
    assert calls == [(253, 64)] * 2 + [(253, 128)] * 2


def test_pipeline_ab_legs_give_identical_masks(monkeypatch):
    monkeypatch.setattr(bench, "AB_ATTEMPTS", 1)
    line = bench.main(["--device", "cpu", "--pipeline-ab", "--batch", "32", "--chunk", "16", "--e2e-iters", "1"])
    assert line["masks_identical"] is True and line["ab_attempts"] == 1
    assert line["chunks_per_leg"] == 6 and line["backend"] == "cpu"
    assert line["metric"] == "pipeline_occupancy" and line["value"] > 0
    assert {"occupancy_serial", "verified_per_sec_serial", "verified_per_sec_pipelined", "stalls_pipelined",
            "pipeline_speedup", "overlap_headroom_pipelined", "device_timeline"} <= set(line)


def test_committee_scale_shows_the_host_route_for_small_quorums(monkeypatch, capsys):
    pytest.importorskip("cryptography")
    monkeypatch.setattr(bench, "COMMITTEE_SIZES", (4, 10, 64))
    line = bench.main(["--device", "cpu", "--committee-scale", "--batch", "86", "--e2e-iters", "1",
                       "--cpu-budget", "0.05"])
    rows = {r["committee"]: r for r in line["committee_scale"]}
    assert [rows[c]["quorum"] for c in (4, 10, 64)] == [3, 7, 43]
    assert rows[4]["route"] == rows[10]["route"] == "openssl"
    assert rows[64]["route"] == "card" and rows[64]["qcs"] == 2
    assert line["value"] == rows[64]["e2e_sigs_per_s"] > 0
    assert "openssl" in capsys.readouterr().out


def test_without_a_card_and_without_device_cpu_main_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "8"])


def test_telemetry_port_serves_the_plane(capsys):
    """`--telemetry-port 0` serves the telemetry plane on a free port for
    the run, which the port's and the reference's `scrape_sync` both read;
    `stop_telemetry` closes it."""
    from hotstuff_tpu.utils import telemetry as ref_telemetry
    from hotstuff_tpu_torch.utils import telemetry

    try:
        line = bench.main(["--device", "cpu", "--ingress", "--ingress-duration", "0.2", "--ingress-rate", "20",
                           "--telemetry-port", "0"])
        port = bench.TELEMETRY_PORT
        assert f"# telemetry scrape endpoint on 127.0.0.1:{port}" in capsys.readouterr().err
        for scrape_sync in (telemetry.scrape_sync, ref_telemetry.scrape_sync):
            dump = scrape_sync(("127.0.0.1", port))
            assert dump["kind"] == "telemetry" and dump["node"] == "bench" and dump["lanes"] == {}
            assert isinstance(dump["device"], dict)
    finally:
        bench.stop_telemetry()
    assert line["backend"] == "cpu" and bench.TELEMETRY_PORT is None
    with pytest.raises(OSError):
        telemetry.scrape_sync(("127.0.0.1", port), timeout=2.0)


@pytest.mark.parametrize("flag", ["--ingress-backend", "--sched-backend"])
def test_pure_python_backends_are_refused(flag, monkeypatch, capsys):
    """`pure` runs its leg (0.5 s) on the port's pure-Python verifier on
    the host, as the reference's `pure` does: no card is asked for (none
    is visible here and `--device` is left at its default), the line has
    the reference's keys with `backend` `pure-python` and no `routes`, and
    every mask holds."""
    from hotstuff_tpu_torch.crypto.pysigner import PurePythonBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    verify = PurePythonBackend.verify_batch_mask
    monkeypatch.setattr(PurePythonBackend, "verify_batch_mask", lambda self, *a: calls.append(len(a[0])) or
                        verify(self, *a))
    if flag == "--ingress-backend":
        line = bench.main(["--ingress", flag, "pure", "--ingress-duration", "0.5", "--ingress-rate", "20"])
        keys, extra = INGRESS_KEYS, {"committed", "signer", "signer_sigs_per_s", "pipeline"}
        assert line["committed"] == line["accepted"] == line["offered"] == sum(calls) > 0
    else:
        line = bench.main(["--scheduler-ab", flag, "pure", "--sched-duration", "0.5"])
        keys, extra = SCHED_KEYS, set()
        assert line["workload"]["bulk_size"] == 8 and line["workload"]["critical_size"] == 3
        assert line["legacy"]["masks_all_true"] and line["scheduler"]["masks_all_true"] and calls
    assert keys <= set(line) and set(line) - keys == extra | {"device", "power_limit_w"}
    assert line["backend"] == "pure-python" and line["device"] == "cpu" and line["power_limit_w"] is None
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line


@pytest.mark.parametrize("leg", ["--ingress", "--scheduler-ab"])
def test_auto_leg_without_a_card_raises_and_does_not_degrade(leg, monkeypatch):
    """`auto` is the card: without one the leg raises before any
    verification, where the reference's `auto` degrades to its pure-Python
    verifier (`bench.py:388-413`)."""
    from hotstuff_tpu_torch.crypto.pysigner import PurePythonBackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(PurePythonBackend, "verify_batch_mask", lambda *a: pytest.fail("degraded to pure"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([leg, "--ingress-duration", "0.2", "--sched-duration", "0.2"])


# The reference's keys of the --ingress payload (`bench.py:480-495`) and of
# the --scheduler-ab payload and its legs (`bench.py:573-581`, `:624-648`).
INGRESS_KEYS = {"metric", "value", "unit", "offered_tps", "committed_tps", "offered", "accepted", "shed",
                "retry_hints", "shed_rate", "latency_ms", "curve", "clients", "backend"}
SCHED_KEYS = {"metric", "value", "unit", "legacy", "scheduler", "p99_improvement", "verified_ratio", "workload",
              "backend"}
SCHED_LEG_KEYS = {"mode", "critical_queue_ms", "bulk_queue_ms", "verified_per_sec", "bulk_groups",
                  "critical_groups", "flushes"}


def test_ingress_leg_on_the_cpu(tmp_path, capsys):
    """`--ingress` for 0.5 s at 20 tx/s on the CPU: the reference's keys,
    every offered transaction committed, the signer's line, and metrics and
    trace dumps that load."""
    metrics.reset()
    mpath, tpath = tmp_path / "metrics.json", tmp_path / "trace.json"
    line = bench.main(["--device", "cpu", "--ingress", "--ingress-duration", "0.5", "--ingress-rate", "20",
                       "--metrics-out", str(mpath), "--trace-out", str(tpath)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line and out[-2].startswith("# ingress signer: ")
    assert INGRESS_KEYS <= set(line)
    assert set(line) - INGRESS_KEYS == {"committed", "signer", "signer_sigs_per_s", "pipeline", "routes",
                                        "device", "power_limit_w"}
    assert line["metric"] == "ingress_committed_tx_per_sec" and line["backend"] == "cpu"
    assert line["offered"] > 0 and line["committed"] == line["accepted"] == line["offered"] == \
        line["pipeline"]["accepted"]
    assert line["curve"]["kind"] == "flash" and line["curve"]["peak"] == 100.0
    counters = json.loads(mpath.read_text())["counters"]
    assert counters["ingress.verified_sigs"] == line["committed"] and counters["ingress.rejected_sigs"] == 0
    assert line["routes"]["host_sigs"] + line["routes"]["device_sigs"] == line["committed"]
    kinds = {e["kind"] for e in json.loads(tpath.read_text())["events"]}
    assert {"ingress.recv", "ingress.admit", "ingress.verify", "ingress.forward", "verify.batch"} <= kinds


def test_ingress_leg_raises_when_a_dispatch_fails(monkeypatch):
    """A failed dispatch is caught by the pipeline, as in the reference, but
    the bench offers only valid signatures: the leg raises."""
    from hotstuff_tpu_torch.crypto import torch_backend

    def broken(self, *a, **kw):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(torch_backend.TorchBackend, "verify_batch_mask", broken)
    with pytest.raises(RuntimeError, match="valid signatures rejected"):
        bench.main(["--device", "cpu", "--ingress", "--ingress-duration", "0.2", "--ingress-rate", "20"])


def test_scheduler_ab_leg_on_the_cpu(tmp_path):
    """`--scheduler-ab` for 0.5 s a leg on the CPU: the reference's keys,
    both legs verified with every mask True, each through its own loop."""
    tpath = tmp_path / "trace.json"
    line = bench.main(["--device", "cpu", "--scheduler-ab", "--sched-duration", "0.5", "--sched-bulk", "4",
                       "--trace-out", str(tpath)])
    assert SCHED_KEYS <= set(line) and set(line) - SCHED_KEYS == {"routes", "device", "power_limit_w"}
    assert line["metric"] == "critical_lane_p99_queue_ms"
    assert line["workload"] == {"duration_s": 0.5, "bulk_size": 4, "bulk_feeders": 3, "critical_size": 3,
                                "critical_interval_s": 0.02}
    for leg, loop in (("legacy", "BatchVerificationService._run_legacy"), ("scheduler", "DeviceScheduler.run")):
        d = line[leg]
        assert SCHED_LEG_KEYS <= set(d) and set(d) - SCHED_LEG_KEYS == {"flush_loop", "masks_all_true"}
        assert d["mode"] == leg and d["flush_loop"] == loop and d["masks_all_true"]
        assert d["verified_per_sec"] > 0 and d["critical_groups"] > 0 and d["bulk_groups"] > 0
        assert d["critical_queue_ms"]["count"] == d["critical_groups"]
    assert line["verified_ratio"] > 0 and line["value"] == line["scheduler"]["critical_queue_ms"]["p99_ms"]
    assert json.loads(tpath.read_text())["v"] == 1


def test_every_leg_writes_its_trace_out_after_its_metrics(tmp_path, capsys):
    """Every leg ends in `emit`: the metrics dump, then the flight
    recorder's dump (`trace.dumps` counts it after the metrics were
    written, as in the reference), then the JSON line."""
    metrics.reset()
    mpath, tpath = tmp_path / "metrics.json", tmp_path / "trace.json"
    assert bench.emit({"value": 1.0}, str(mpath), str(tpath)) == {"value": 1.0}
    assert json.loads(capsys.readouterr().out) == {"value": 1.0}
    trace = json.loads(tpath.read_text())
    assert set(trace) == {"v", "enabled", "node", "capacity", "recorded", "dropped", "anchor", "events"}
    assert json.loads(mpath.read_text())["counters"]["trace.dumps"] == 0
    assert metrics.counter("trace.dumps").value == 1
