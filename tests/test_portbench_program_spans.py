"""The benchmark's readers of the program's own spans
(`portbench/metrics/`), on synthetic `harness.Readings`, and the naming of
a traced window's idle gaps by the program ranges open at their middles
(`portbench/program_trace.py`), on a synthetic Chrome trace."""

import pytest

from portbench import harness, program_trace


def reader(name):
    return harness._reader(harness.ROOT, name)


def hist(count, total):
    return {"count": count, "sum": total}


WINDOW = {
    "counters": {"crypto.tpu_sigs": 400_000, "crypto.cpu_sigs": 100_000, "verifier.sigs": 400_000},
    "histograms": {
        "service.submit_s": hist(512, 0.05), "service.assemble_s": hist(64, 0.1),
        "service.resolve_s": hist(64, 0.1), "service.handoff_critical_s": hist(20, 0.06),
        "service.handoff_bulk_s": hist(44, 9.0), "backend.generic_s": hist(44, 0.5),
        "backend.committee_s": hist(20, 0.1), "verifier.e2e_s": hist(64, 0.52),
        "pipeline.wait_s": hist(128, 0.2), "runtime.gc_s": hist(300, 0.051),
    },
}
# What each reader gives on WINDOW (a 10 s window).
WANT = {
    "service.host_us_per_sig": 1e6 * 0.25 / 500_000,
    "service.critical_handoff_ms": 1e3 * 0.06 / 20,
    "backend.host_us_per_sig": 1e6 * (0.6 - 0.52) / 400_000,
    "pipeline.wait_us_per_sig": 1e6 * 0.2 / 400_000,
    "runtime.gc_ms_per_s": 1e3 * 0.051 / 10.0,
}


def readings(window):
    return harness.Readings(10.0, 1.0, {}, [], window, 50)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_takes_its_spans_over_its_base(name):
    assert reader(name)(readings(WINDOW)) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_is_silent_where_the_program_has_no_such_span(name):
    parent = {"counters": dict(WINDOW["counters"]),
              "histograms": {"verifier.e2e_s": WINDOW["histograms"]["verifier.e2e_s"]}}
    assert reader(name)(readings(parent)) is None


def test_the_critical_handoff_is_silent_without_a_critical_call():
    window = {"counters": {}, "histograms": {"service.handoff_critical_s": hist(0, 0.0)}}
    assert reader("service.critical_handoff_ms")(readings(window)) is None


def _trace():
    """Device work 10-1000 us between two markers, busy 100-200 and 600-700;
    a harness span on thread 7 over 150-650; program ranges on thread 7
    (the backend call, the verifier's inside it) and thread 9 (a service
    span) covering the middle of the 200-600 gap, and none at the others."""
    def x(name, cat, ts, dur, tid=1):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}

    return {"traceEvents": [
        x("spin_kernel", "kernel", 0, 10), x("spin_kernel", "kernel", 1000, 10),
        x("ladder_kernel", "kernel", 100, 100), x("compress_eq_kernel", "kernel", 600, 100),
        x("portbench.backend.generic", "user_annotation", 150, 500, 7),
        x("backend.generic_s", "user_annotation", 150, 500, 7),
        x("verifier.e2e_s", "user_annotation", 160, 480, 7),
        x("service.resolve_s", "user_annotation", 300, 200, 9),
        x("aten::copy_", "cpu_op", 390, 20, 9),
    ]}


def test_a_gap_is_named_by_the_innermost_program_range_on_each_thread():
    trace = _trace()
    tr = harness.read_trace(trace)
    ranges = program_trace.program_ranges(trace)
    assert sorted(n for n, *_ in ranges) == ["backend.generic_s", "service.resolve_s", "verifier.e2e_s"]
    named = program_trace.name_gaps(tr, ranges)
    assert named == [["backend.generic | service.resolve_s + verifier.e2e_s", 400e-6],
                     ["no backend call | -", 300e-6], ["no backend call | -", 90e-6]]
    # The harness's own name of each gap stays its prefix.
    for (new, secs), (old, old_secs) in zip(named, harness.breakdown(tr)["idle_gaps"]):
        assert new.startswith(old + " | ") and secs == old_secs


def test_the_cycle_is_each_span_a_bulk_bucket():
    window = {"counters": {}, "histograms": dict(WINDOW["histograms"], **{"scheduler.bucket_size": hist(40, 312_320)})}
    got = program_trace.cycle(window, 10.0)
    assert got["buckets"] == 40 and got["window_ms"] == pytest.approx(250.0)
    assert got["backend.generic_s"] == {"ms": pytest.approx(12.5), "samples": pytest.approx(1.1)}
    assert "verifier.stage_s" not in got
    assert program_trace.cycle({"counters": {}, "histograms": {}}, 10.0) == {}


def test_idle_time_inside_backend_calls_is_the_overlap_of_the_two():
    tr = harness.read_trace(_trace())
    idle = program_trace.idle_gaps(tr)
    assert idle == [(10.0, 100.0), (200.0, 600.0), (700.0, 1000.0)]
    assert program_trace.overlap_s(idle, [(150.0, 650.0)]) == pytest.approx(400e-6)
    assert program_trace.overlap_s(idle, []) == 0.0
