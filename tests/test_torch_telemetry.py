"""The port's telemetry plane (`hotstuff_tpu_torch/utils/telemetry.py`)
against the reference's (`hotstuff_tpu/utils/telemetry.py`).

The reference's own cases (`tests/test_telemetry.py`, all but the chaos
scenario) run over both packages, each plane reading its own package's
metrics registry, `LaneStats` and watchdog. Then the two side by side: fed
the same counter, histogram and lane sequences at the same `now`, they give
equal snapshots, equal fire and clear transitions and equal dumps; their
SLO sets and fleet helpers agree; and each package's `scrape_sync` reads
the other's server over localhost TCP, whose reply bytes are the same.

No torch kernel, no JAX: the planes read registries and reservoirs only.
"""

from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
import types

import pytest

from hotstuff_tpu.crypto import scheduler as r_scheduler
from hotstuff_tpu.utils import metrics as r_metrics
from hotstuff_tpu.utils import telemetry as r_telemetry
from hotstuff_tpu.utils import tracing as r_tracing
from hotstuff_tpu_torch.crypto import scheduler as p_scheduler
from hotstuff_tpu_torch.utils import metrics as p_metrics
from hotstuff_tpu_torch.utils import telemetry as p_telemetry
from hotstuff_tpu_torch.utils import tracing as p_tracing

PKGS = {
    "reference": types.SimpleNamespace(metrics=r_metrics, telemetry=r_telemetry, tracing=r_tracing,
                                       scheduler=r_scheduler),
    "port": types.SimpleNamespace(metrics=p_metrics, telemetry=p_telemetry, tracing=p_tracing,
                                  scheduler=p_scheduler),
}


@pytest.fixture(autouse=True)
def _isolate_tracing():
    for pkg in PKGS.values():
        pkg.tracing.reset()
    yield
    for pkg in PKGS.values():
        pkg.tracing.reset()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _plane(pkg, ls=None, **cfg):
    clock = {"t": 0.0}
    config = pkg.telemetry.TelemetryConfig(interval_s=1.0, short_window=2, long_window=4, burn_factor=2.0, **cfg)
    plane = pkg.telemetry.TelemetryPlane(label="n0", config=config, lane_stats=ls, clock=lambda: clock["t"])
    return plane, clock


# --- the SLO set of record ----------------------------------------------------


def test_default_slos_cover_every_source_class_with_registered_metrics(pkg):
    specs = pkg.telemetry.default_slos()
    if pkg is PKGS["reference"]:
        registered = {name for name, _k, _b in r_metrics._DEFAULT_NAMESPACE}
    else:
        # The port registers its metrics where they are recorded; it has no
        # commit-proof plane, so nothing records proofs.serve_s.
        import hotstuff_tpu_torch.consensus.reconfig  # noqa: F401
        import hotstuff_tpu_torch.ops.verifier  # noqa: F401

        registered = set(p_metrics.dump()["histograms"]) | {"proofs.serve_s"}
    assert {s.metric for s in specs} <= registered
    classes = pkg.scheduler.SOURCE_CLASSES
    assert {s.lane for s in specs if s.lane is not None} == set(classes)
    for spec in specs:
        if spec.lane is not None:
            assert spec.threshold_s == classes[spec.lane].slo_s


def test_the_port_keeps_the_reference_slo_set_and_config():
    assert p_telemetry.default_slos() == tuple(p_telemetry.SLOSpec(**vars(s)) for s in r_telemetry.default_slos())
    assert vars(p_telemetry.TelemetryConfig()) == vars(r_telemetry.TelemetryConfig())
    assert p_telemetry.VERIFY_E2E_SLO_S == r_telemetry.VERIFY_E2E_SLO_S
    assert p_telemetry.REGION_RTT_THRESHOLD_MS == r_telemetry.REGION_RTT_THRESHOLD_MS


# --- snapshot deltas ----------------------------------------------------------


def test_snapshot_counters_are_deltas_from_plane_birth(pkg):
    c = pkg.metrics.counter("chaos.drops")
    c.inc(5)  # pre-birth history must not leak into the first snapshot
    plane, _clock = _plane(pkg)
    c.inc(3)
    snap = plane.snapshot(1.0)
    assert snap["counters"]["chaos.drops"] == 3
    assert "chaos.drops" not in plane.snapshot(2.0).get("counters", {})


def test_snapshot_windowed_histogram_percentiles(pkg):
    h = pkg.metrics.histogram("scheduler.queue_mempool_s")
    plane, _clock = _plane(pkg)
    for _ in range(10):
        h.record(0.003)
    row = plane.snapshot(1.0)["hist"]["scheduler.queue_mempool_s"]
    assert row["count"] == 10 and 0.002 <= row["p50"] <= 0.005
    assert "scheduler.queue_mempool_s" not in plane.snapshot(2.0).get("hist", {})


def test_snapshot_lane_stats_window(pkg):
    ls = pkg.scheduler.LaneStats()
    plane, _clock = _plane(pkg, ls)
    for _ in range(4):
        ls.note("consensus", 0.0005)
    lane = plane.snapshot(1.0)["lanes"]["consensus"]
    assert lane["count"] == 4 and lane["bad"] == 0
    assert lane["p99_ms"] == pytest.approx(0.5)
    assert "lanes" not in plane.snapshot(2.0)


# --- the burn evaluator -------------------------------------------------------


def _drive_to_fire(plane, clock, ls, healthy=2, burning=2):
    for _ in range(healthy):
        clock["t"] += 1.0
        ls.note("mempool", 0.001)
        plane.snapshot()
    for _ in range(burning):
        clock["t"] += 1.0
        for _ in range(5):
            ls.note("mempool", 2.0)  # past the 500 ms objective
        plane.snapshot()


def test_burn_evaluator_fires_then_clears(pkg):
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    _drive_to_fire(plane, clock, ls)
    assert "lane.mempool" in plane.active_alerts()
    fired = [a for a in plane.alerts if a["event"] == "fired"]
    assert fired and fired[0]["slo"] == "lane.mempool"
    assert fired[0]["burn_short"] >= plane.config.burn_factor
    assert any(t["reason"] == "slo_burn" for t in pkg.tracing.WATCHDOG.triggers)
    for _ in range(2):
        clock["t"] += 1.0
        plane.snapshot()
    assert plane.active_alerts() == []
    cleared = [a for a in plane.alerts if a["event"] == "cleared"]
    assert cleared and cleared[0]["t"] > fired[0]["t"]


def test_burn_requires_both_windows(pkg):
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    for _ in range(4):
        clock["t"] += 1.0
        for _ in range(20):
            ls.note("mempool", 0.001)
        plane.snapshot()
    clock["t"] += 1.0
    ls.note("mempool", 2.0)
    for _ in range(19):
        ls.note("mempool", 0.001)
    plane.snapshot()
    assert plane.active_alerts() == []


def test_startup_blip_does_not_fire(pkg):
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    clock["t"] += 1.0
    for _ in range(5):
        ls.note("mempool", 2.0)
    plane.snapshot()
    assert plane.active_alerts() == []
    for _ in range(3):
        clock["t"] += 1.0
        for _ in range(5):
            ls.note("mempool", 2.0)
        plane.snapshot()
    assert plane.active_alerts() == ["lane.mempool"]


def test_lane_window_survives_reservoir_rotation(pkg, monkeypatch):
    monkeypatch.setattr(pkg.scheduler.LaneStats, "CAP", 8)
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    for _ in range(20):
        ls.note("mempool", 2.0)
    clock["t"] += 1.0
    assert plane.snapshot()["lanes"]["mempool"]["count"] == 8
    for _ in range(4):
        ls.note("mempool", 2.0)
    clock["t"] += 1.0
    lane = plane.snapshot()["lanes"]["mempool"]
    assert lane["count"] == 4 and lane["bad"] == 4


def test_idle_lane_never_fires(pkg):
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    for _ in range(6):
        clock["t"] += 1.0
        plane.snapshot()
    assert plane.active_alerts() == [] and plane.alerts == []


def test_histogram_backed_slo(pkg):
    h = pkg.metrics.histogram("verifier.e2e_s")
    clock = {"t": 0.0}
    spec = pkg.telemetry.SLOSpec("verify.e2e", "verifier.e2e_s", threshold_s=0.25)
    plane = pkg.telemetry.TelemetryPlane(
        label="h", config=pkg.telemetry.TelemetryConfig(interval_s=1.0, short_window=2, long_window=4,
                                                        burn_factor=2.0),
        slos=(spec,), clock=lambda: clock["t"])
    for _ in range(2):
        clock["t"] += 1.0
        h.record(0.01)
        plane.snapshot()
    assert plane.active_alerts() == []
    for _ in range(2):
        clock["t"] += 1.0
        for _ in range(5):
            h.record(5.0)
        plane.snapshot()
    assert plane.active_alerts() == ["verify.e2e"]


# --- the watchdog's dump context ----------------------------------------------


def test_auto_dump_embeds_last_snapshots(pkg, tmp_path):
    ls = pkg.scheduler.LaneStats()
    plane, clock = _plane(pkg, ls)
    plane.attach_watchdog()
    hook = pkg.tracing.WATCHDOG.set_auto_dump(str(tmp_path / "trace.json"))
    try:
        _drive_to_fire(plane, clock, ls)
        files = sorted(tmp_path.glob("trace.json.watchdog-slo_burn-*.json"))
        assert files, "slo_burn trigger wrote no auto-dump"
        d = json.loads(files[0].read_text())
        assert d["watchdog"]["reason"] == "slo_burn"
        snaps = d["context"]["telemetry"]["n0"]
        assert snaps and len(snaps) <= plane.config.dump_snapshots
        assert any("lanes" in s for s in snaps)
    finally:
        pkg.tracing.WATCHDOG.remove_dump_hook(hook)
        plane.detach_watchdog()


def test_detach_watchdog_removes_context(pkg):
    plane, _clock = _plane(pkg)
    plane.attach_watchdog()
    assert pkg.tracing.WATCHDOG.context().get("telemetry") is not None
    plane.detach_watchdog()
    assert pkg.tracing.WATCHDOG.context() == {}


# --- the scrape endpoint (real TCP) -------------------------------------------


def test_scrape_round_trip_over_real_tcp(pkg):
    async def main():
        ls = pkg.scheduler.LaneStats()
        ls.note("consensus", 0.001)
        plane = pkg.telemetry.TelemetryPlane(label="nX", lane_stats=ls)
        plane.snapshot(1.0)
        plane.snapshot(2.0)
        server = pkg.telemetry.TelemetryServer(("127.0.0.1", 0), plane)
        port = await server.start()
        try:
            resp = await pkg.telemetry.scrape(("127.0.0.1", port))
            assert resp["node"] == "nX" and len(resp["snapshots"]) == 2
            assert {s["name"] for s in resp["slos"]} >= {"lane.consensus"}
            assert "consensus" in resp["lanes"]
            resp2 = await pkg.telemetry.scrape(("127.0.0.1", port), last=1)
            assert len(resp2["snapshots"]) == 1 and resp2["snapshots"][0]["seq"] == 1
        finally:
            server._server.close()

    before = pkg.metrics.counter("telemetry.scrapes").value
    asyncio.run(main())
    assert pkg.metrics.counter("telemetry.scrapes").value - before == 2


def test_scrape_server_serves_static_dump_verbatim(pkg):
    static = {"node": "7", "snapshots": [{"seq": 0, "t": 1.0}], "alerts": []}

    async def main():
        server = pkg.telemetry.TelemetryServer(("127.0.0.1", 0), static)
        port = await server.start()
        try:
            assert await pkg.telemetry.scrape(("127.0.0.1", port)) == static
        finally:
            server._server.close()

    asyncio.run(main())


# --- side by side -------------------------------------------------------------


def _feed(pkg, ls, step: int) -> None:
    """One step of the shared observation sequence: test counters and a
    gauge, queue and verify-latency samples (slow ones in steps 5-8), lane
    notes (the mempool lane burning in steps 3-6)."""
    pkg.metrics.counter("telemetry_test.events").inc(step)
    pkg.metrics.gauge("telemetry_test.depth").set(step % 3)
    for i in range(step + 1):
        pkg.metrics.histogram("scheduler.queue_mempool_s").record(0.001 * (i + 1))
    e2e = pkg.metrics.histogram("verifier.e2e_s")
    for _ in range(4):
        e2e.record(2.0 if 5 <= step <= 8 else 0.004)
    for i in range(6):
        ls.note("consensus", 0.0004 * (i + 1))
        ls.note("mempool", 1.5 if 3 <= step <= 6 else 0.002 * (i + 1))
    if step % 4 == 0:
        ls.note("ingress", 0.5)  # past the ingress lane's 100 ms


def _run_plane(pkg, steps: int = 14):
    ls = pkg.scheduler.LaneStats()
    config = pkg.telemetry.TelemetryConfig(
        interval_s=1.0, short_window=2, long_window=4, burn_factor=2.0,
        counter_prefixes=("telemetry_test.", "telemetry."),
        histograms=("scheduler.queue_mempool_s",))
    plane = pkg.telemetry.TelemetryPlane(label="node-0", config=config, lane_stats=ls, clock=lambda: 99.0)
    plane.attach_watchdog()
    transitions = []
    try:
        for step in range(steps):
            _feed(pkg, ls, step)
            plane.snapshot(now=float(step))
            transitions.append(plane.active_alerts())
        dump = plane.dump()
        last = plane.dump(last=3)
        context = pkg.tracing.WATCHDOG.context()
    finally:
        plane.detach_watchdog()
    triggers = [(t["reason"], t.get("slo")) for t in pkg.tracing.WATCHDOG.triggers]
    return plane, transitions, dump, last, context, triggers


def test_planes_agree_snapshot_for_snapshot_and_alert_for_alert():
    ref = _run_plane(PKGS["reference"])
    port = _run_plane(PKGS["port"])
    (rp, r_trans, r_dump, r_last, r_ctx, r_trig), (pp, p_trans, p_dump, p_last, p_ctx, p_trig) = ref, port
    assert pp.snapshots() == rp.snapshots()
    assert p_trans == r_trans and pp.alerts == rp.alerts
    assert {a["event"] for a in pp.alerts} == {"fired", "cleared"}  # the sequence fires and clears
    assert p_trig == r_trig and p_trig
    assert set(p_dump) == set(r_dump)
    strip = lambda d: {k: v for k, v in d.items() if k != "anchor"}  # noqa: E731 (wall-clock stamp)
    assert strip(p_dump) == strip(r_dump) and strip(p_last) == strip(r_last)
    assert p_ctx == r_ctx and len(p_ctx["telemetry"]["node-0"]) == pp.config.dump_snapshots


FLEET = {"a": {"b": 4.0, "c": 150.0}, "c": {"d": 3.5, "a": 151.0}, "d": {"b": 149.0}, "e": {}}
LANES = {"n0": {"consensus": {"count": 10, "p50_ms": 0.4, "p99_ms": 1.9, "max_ms": 2.5}},
         "n1": {"consensus": {"count": 30, "p50_ms": 0.6, "p99_ms": 4.0}, "mempool": {"count": 0}},
         "n2": {"mempool": {"count": 7, "p50_ms": 12.0, "p99_ms": 40.0, "max_ms": 41.0}}}
PEERS = {"n3": {"rtt_ewma_ms": 3.25, "rtt_p50_ms": 3.0, "frames_sent": 12, "bytes_sent": 4096},
         "n1": {"backoff_drops": 2, "probes_sent": 5, "pongs_received": 4}}


def test_fleet_helpers_agree():
    assert p_telemetry.infer_fleet_regions(FLEET) == r_telemetry.infer_fleet_regions(FLEET)
    assert p_telemetry.infer_fleet_regions(FLEET, 200.0) == r_telemetry.infer_fleet_regions(FLEET, 200.0)
    assert p_telemetry.merge_lane_summaries(LANES) == r_telemetry.merge_lane_summaries(LANES)
    points = [(1.0, 0.5), (3.0, 2.0), (2.0, 0.0), (7.0, 1.5)]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert p_telemetry.weighted_percentile(points, q) == r_telemetry.weighted_percentile(points, q)
    assert [vars(v) for v in p_telemetry.peer_views(PEERS)] == [vars(v) for v in r_telemetry.peer_views(PEERS)]


class _Endpoint:
    """A package's TelemetryServer on a loop of its own in a thread, closed
    on exit."""

    def __init__(self, pkg, source) -> None:
        self.pkg, self.source = pkg, source
        self._ready, self._stop = threading.Event(), threading.Event()

    def __enter__(self) -> int:
        async def main():
            server = self.pkg.telemetry.TelemetryServer(("127.0.0.1", 0), self.source)
            self.port = await server.start()
            self._ready.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.01)
            server._server.close()
            await server._server.wait_closed()

        self._thread = threading.Thread(target=lambda: asyncio.run(main()), daemon=True)
        self._thread.start()
        assert self._ready.wait(10)
        return self.port

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(10)


@pytest.mark.parametrize("server_pkg, client_pkg", [("port", "reference"), ("reference", "port")])
def test_scrape_sync_reads_the_other_packages_server(server_pkg, client_pkg):
    """Over localhost TCP: a plane of one package served, the other
    package's `scrape_sync` reading it, with `last`, and its error reply
    to an unknown command."""
    srv, cli = PKGS[server_pkg], PKGS[client_pkg]
    ls = srv.scheduler.LaneStats()
    ls.note("mempool", 0.003)
    plane = srv.telemetry.TelemetryPlane(label="node-2", lane_stats=ls)
    for t in (1.0, 2.0, 3.0):
        plane.snapshot(t)
    with _Endpoint(srv, plane) as port:
        full = cli.telemetry.scrape_sync(("127.0.0.1", port))
        last = cli.telemetry.scrape_sync(("127.0.0.1", port), last=1)
        bad = _raw(port, {"cmd": "nope"})
    want = plane.dump()
    assert {k: v for k, v in full.items() if k != "anchor"} == {k: v for k, v in want.items() if k != "anchor"}
    assert full["node"] == "node-2" and [s["seq"] for s in last["snapshots"]] == [2]
    assert json.loads(bad) == {"error": "unknown cmd 'nope' (try 'scrape')"}


def _raw(port: int, req: dict) -> bytes:
    """One framed request's reply, as bytes off the socket (4-byte length
    prefix included)."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        body = json.dumps(req).encode()
        s.sendall(struct.pack(">I", len(body)) + body)
        head = b""
        while len(head) < 4:
            head += s.recv(4 - len(head))
        n = struct.unpack(">I", head)[0]
        data = b""
        while len(data) < n:
            data += s.recv(n - len(data))
    return head + data if req.get("cmd") == "scrape" else data


def test_servers_reply_with_the_same_bytes():
    """The same static dump and the same requests give byte-identical
    replies from both packages' servers (length prefix included)."""
    static = {"v": 1, "kind": "telemetry", "node": "n9", "snapshots": [{"seq": 0, "t": 1.5}], "alerts": [],
              "slos": [{"name": "lane.consensus", "lane": "consensus"}], "lanes": {}}
    replies = {}
    for name, pkg in PKGS.items():
        with _Endpoint(pkg, static) as port:
            replies[name] = [_raw(port, req) for req in ({"cmd": "scrape"}, {"cmd": "scrape", "last": -1},
                                                         {"cmd": "scrape", "last": 1}, {"cmd": "other"})]
    assert replies["port"] == replies["reference"]
    assert json.loads(replies["port"][0][4:]) == static
