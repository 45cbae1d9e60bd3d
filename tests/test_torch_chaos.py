"""The port's chaos plane (`hotstuff_tpu_torch/chaos/`,
`utils/incidents.py`, the aggregate-certificate plane) held against the
reference's (`hotstuff_tpu/chaos/`) on the CPU.

Both planes run on the host by design (`ChaosOrchestrator.run` installs
`PurePythonBackend`), so the reference's determinism contract is an exact
oracle:

  * seven scenarios at seed 1 through both packages, one of them with
    the ingress drain's pacing (`incident_smoke`, `verify_interval` set):
    `fault_trace`,
    `commits`, `commit_times`, `events`, `epoch_switches` and
    `final_epochs` are equal, and so is every other field of the report
    but those that carry the wall clock (`trace_anchor`, the telemetry
    anchors' `wall`, and the `dur` of the flight recorders' and the
    watchdog dumps' events);
  * a same-seed replay on the port is bit-identical but for those;
  * `TrustedCryptoScheme` / `TrustedAggScheme`, the `SafetyChecker`'s
    committed-QC audit, `incidents.build_ledger` / `report_ledger` and the
    AggQC / AggTC that `AggCertAggregator` forms for a 4-node fleet agree
    between the packages.

The port's other non-slow scenarios are held to their own expectations
in `tests/test_torch_chaos_{faults,load,epochs}.py`.
"""

from __future__ import annotations

import pytest

from hotstuff_tpu.chaos import invariants as r_invariants
from hotstuff_tpu.chaos import run_scenario as r_run_scenario
from hotstuff_tpu.chaos import trusted_crypto as r_trusted
from hotstuff_tpu.consensus import aggregator as r_aggregator
from hotstuff_tpu.consensus import config as r_config
from hotstuff_tpu.consensus import messages as r_messages
from hotstuff_tpu.crypto import aggsig as r_aggsig
from hotstuff_tpu.crypto import primitives as r_primitives
from hotstuff_tpu.crypto import pysigner as r_pysigner
from hotstuff_tpu.utils import incidents as r_incidents
from hotstuff_tpu.utils.serde import Writer as RWriter
from hotstuff_tpu_torch.chaos import invariants as p_invariants
from hotstuff_tpu_torch.chaos import run_scenario as p_run_scenario
from hotstuff_tpu_torch.chaos import trusted_crypto as p_trusted
from hotstuff_tpu_torch.consensus import aggregator as p_aggregator
from hotstuff_tpu_torch.consensus import config as p_config
from hotstuff_tpu_torch.consensus import messages as p_messages
from hotstuff_tpu_torch.crypto import aggsig as p_aggsig
from hotstuff_tpu_torch.crypto import primitives as p_primitives
from hotstuff_tpu_torch.crypto import pysigner as p_pysigner
from hotstuff_tpu_torch.utils import incidents as p_incidents
from hotstuff_tpu_torch.utils.serde import Writer as PWriter

PKGS = {
    "reference": dict(trusted=r_trusted, invariants=r_invariants, aggregator=r_aggregator, config=r_config,
                      messages=r_messages, aggsig=r_aggsig, primitives=r_primitives, pysigner=r_pysigner,
                      incidents=r_incidents, writer=RWriter),
    "port": dict(trusted=p_trusted, invariants=p_invariants, aggregator=p_aggregator, config=p_config,
                 messages=p_messages, aggsig=p_aggsig, primitives=p_primitives, pysigner=p_pysigner,
                 incidents=p_incidents, writer=PWriter),
}

# The determinism contract's fields: equal between the packages and
# across a replay.
CONTRACT = ("fault_trace", "commits", "commit_times", "events", "epoch_switches", "final_epochs")
# Fields that carry the wall clock in both packages (not a departure):
# the report's (mono, wall) anchor, each telemetry plane's anchor `wall`,
# and each flight-recorder event's `dur` (a perf_counter span around a
# dispatch), in the recorders and in the watchdog's dumps of them.
WALL_CLOCK = ("trace_anchor",)

CROSS = ("baseline", "vote_withholding", "forged_signatures", "stale_qc_replay", "equivocating_leader",
         "agg_certs", "incident_smoke")


def _without_dur(events: list) -> list:
    return [{k: v for k, v in e.items() if k != "dur"} for e in events]


def _without_wall_clock(report: dict) -> dict:
    out = {k: v for k, v in report.items() if k not in WALL_CLOCK}
    out["flight_recorders"] = {
        node: _without_dur(events) for node, events in report.get("flight_recorders", {}).items()
    }
    if "watchdog_dumps" in report:
        out["watchdog_dumps"] = [{**d, "events": _without_dur(d["events"])} for d in report["watchdog_dumps"]]
    if "telemetry" in report:
        out["telemetry"] = {
            node: {**t, "anchor": {k: v for k, v in t["anchor"].items() if k != "wall"}}
            for node, t in report["telemetry"].items()
        }
    return out


_REPORTS: dict[str, tuple[dict, dict]] = {}


def _reports(name: str) -> tuple[dict, dict]:
    """(reference, port) reports of `name` at seed 1, run once a module."""
    if name not in _REPORTS:
        _REPORTS[name] = r_run_scenario(name, 1), p_run_scenario(name, 1)
    return _REPORTS[name]


@pytest.mark.parametrize("name", CROSS)
def test_scenario_matches_the_reference(name):
    ref, port = _reports(name)
    assert ref["ok"] and port["ok"], (ref.get("expectation_failures"), port.get("expectation_failures"))
    for key in CONTRACT:
        assert port[key] == ref[key], key
    assert port["commits"] and all(port["commits"].values())
    assert sorted(port) == sorted(ref)
    ref_rest, port_rest = _without_wall_clock(ref), _without_wall_clock(port)
    assert [k for k in ref_rest if ref_rest[k] != port_rest[k]] == []
    if name == "agg_certs":
        # The aggregate plane ran: AggQCs formed, none entry-listed.
        assert port["metrics"]["agg.qcs_formed"] > 0
        assert port["metrics"]["agg.qcs_formed"] == ref["metrics"]["agg.qcs_formed"]


@pytest.mark.parametrize("name, seed", [("lossy_links", 42), ("agg_certs", 21)])
def test_same_seed_replays_bit_identically(name, seed):
    a, b = p_run_scenario(name, seed), p_run_scenario(name, seed)
    assert a["ok"] and b["ok"]
    assert _without_wall_clock(a) == _without_wall_clock(b)
    c = p_run_scenario(name, seed + 1)
    assert c["fault_trace"] != a["fault_trace"] or c["commits"] != a["commits"]


# --- the scheduler's chaos knobs ----------------------------------------------


def test_scheduler_drain_order_and_config_match_the_reference():
    from hotstuff_tpu.crypto import scheduler as r_scheduler
    from hotstuff_tpu_torch.crypto import scheduler as p_scheduler

    assert p_scheduler.drain_order() == r_scheduler.drain_order()
    assert sorted(p_scheduler.drain_order()) == sorted(p_scheduler.SOURCE_CLASSES)
    assert p_scheduler.BULK_CONCURRENCY == r_scheduler.SchedulerConfig().bulk_concurrency
    assert p_scheduler.SchedulerConfig() == p_scheduler.SchedulerConfig(
        pace_s_per_sig=r_scheduler.SchedulerConfig().pace_s_per_sig)


# --- the trusted-crypto stub ---------------------------------------------------


def _stub_outputs(pkg: dict) -> list:
    scheme, agg = pkg["trusted"].TrustedCryptoScheme(), pkg["trusted"].TrustedAggScheme()
    out = []
    for i in range(4):
        seed = bytes([i + 1]) * 32
        pk, sk = scheme.keypair_from_seed(seed)
        sig = scheme.sign(sk, b"msg %d" % i)
        bad = bytearray(sig)
        bad[i] ^= 1
        out += [pk, sig, scheme.verify(pk, b"msg %d" % i, sig), scheme.verify(pk, b"msg %d" % i, bytes(bad))]
        apk, ask = agg.keypair_from_seed(seed)
        out += [apk, agg.sign(ask, b"agg %d" % i)]
    apks = [agg.keypair_from_seed(bytes([i + 1]) * 32) for i in range(4)]
    sigs = [agg.sign(sk, b"quorum") for _, sk in apks]
    total = agg.aggregate(sigs)
    out += [total, agg.combine(sigs[0], sigs[1]), agg.verify([pk for pk, _ in apks], b"quorum", total),
            agg.verify([pk for pk, _ in apks[:3]], b"quorum", total)]
    return out


def test_trusted_crypto_scheme_matches_the_reference():
    assert _stub_outputs(PKGS["port"]) == _stub_outputs(PKGS["reference"])


def test_pysigner_scheme_seam_matches_the_reference():
    """Under each package's installed stub, the module-level names follow
    it and the `*_exact` names stay RFC 8032, with equal bytes."""
    outs = {}
    for name, pkg in PKGS.items():
        ps = pkg["pysigner"]
        seed = b"\x05" * 32
        prev = ps.install_scheme(pkg["trusted"].TrustedCryptoScheme())
        try:
            pk, _ = ps.keypair_from_seed(seed)
            sig = ps.sign(seed, b"m")
            exact_pk, _ = ps.keypair_exact(seed)
            exact_sig = ps.sign_exact(seed, b"m")
            outs[name] = (pk, sig, ps.verify(pk, b"m", sig), exact_pk, exact_sig,
                          ps.verify_exact(exact_pk, b"m", exact_sig), ps.verify_exact(exact_pk, b"m", sig))
        finally:
            ps.install_scheme(prev)
        assert ps.active_scheme() is prev
    assert outs["port"] == outs["reference"]
    assert outs["port"][2] and outs["port"][5] and not outs["port"][6]


# --- the SafetyChecker's committed-QC audit ------------------------------------


def _audit(pkg: dict, flip: bool) -> list[str]:
    """A quorate QC of stub signatures in a block by round 2's leader,
    through the package's SafetyChecker; `flip` corrupts one byte of one
    vote signature."""
    ps, m, prim = pkg["pysigner"], pkg["messages"], pkg["primitives"]
    scheme = pkg["trusted"].TrustedCryptoScheme()
    prev = ps.install_scheme(scheme)
    try:
        keys = sorted(scheme.keypair_from_seed(bytes([i + 1]) * 32) for i in range(4))
        keys = [(prim.PublicKey(pk), s) for pk, s in keys]
        committee = pkg["config"].Committee.new([(pk, 1, ("127.0.0.1", 9_000 + i)) for i, (pk, _) in enumerate(keys)])
        parent = prim.Digest(b"\x01" * 32)
        signed = m._vote_digest(parent, 1).data
        votes = [(pk, prim.Signature(ps.sign(s, signed))) for pk, s in keys[:3]]
        if flip:
            bad = bytearray(votes[0][1].data)
            bad[0] ^= 1
            votes[0] = (votes[0][0], prim.Signature(bytes(bad)))
        block = m.Block(m.QC(parent, 1, tuple(votes)), None, keys[2][0], 2, (prim.Digest(b"\x02" * 32),),
                        prim.Signature(bytes(64)))
        checker = pkg["invariants"].SafetyChecker(committee)
        checker.on_commit(0, block)
        return checker.violations
    finally:
        ps.install_scheme(prev)


@pytest.mark.parametrize("flip", [False, True], ids=["genuine", "one_flipped_byte"])
def test_safety_checker_audit_matches_the_reference(flip):
    port, ref = _audit(PKGS["port"], flip), _audit(PKGS["reference"], flip)
    assert port == ref
    if flip:
        assert any("FALSE ACCEPT" in v for v in port)
    else:
        assert port == []


# --- the incident ledger -------------------------------------------------------


def _ledgers(pkg: dict, report: dict) -> list[dict]:
    inc = pkg["incidents"]
    fw, al = inc.FaultWindow, inc.AlertSpan
    synthetic = [
        ([fw("crash", 10.0, 14.0, (1,))], [al("slo_burn", "lane.mempool", 1, 12.0, 15.0)], 20.0),
        ([fw("link_fault", 10.0, 20.0, None)], [al("slo_burn", "lane.ingress", 0, 9.5, 12.0)], 30.0),
        ([fw("flood", 5.0, 15.0, None), fw("crash", 8.0, 10.0, (2,))],
         [al("slo_burn", "lane.mempool", 0, 9.0, 11.0), al("slo_burn", "lane.mempool", 2, 9.0, 11.0)], 20.0),
        ([fw("crash", 2.0, None, (0,))], [al("slo_burn", "lane.mempool", 0, 3.0, None)], 10.0),
    ]
    out = [inc.build_ledger(w, a, run_end=end) for w, a, end in synthetic]
    out.append(inc.report_ledger(report))
    out.append(inc.report_ledger(report, (fw("flood", 0.05, 0.5, None),), budget={"lane.mempool": 1.0}))
    return out


def test_incident_ledger_matches_the_reference():
    ref, port = _reports("equivocating_leader")
    assert port["incidents"] == ref["incidents"] and port["health"] == ref["health"]
    assert _ledgers(PKGS["port"], ref) == _ledgers(PKGS["reference"], ref)


# --- aggregate certificates ----------------------------------------------------


def _agg_certs(pkg: dict) -> tuple[bytes, bytes, int, int]:
    """A 4-node fleet's aggregate quorums through the package's
    `AggCertAggregator` under the trusted-agg stub: three vote partials
    (one merged pair, one singleton) form an AggQC, three timeout
    partials over two high-QC rounds an AggTC. Returns both encoded, and
    the signers of each."""
    ps, m, prim, aggsig = pkg["pysigner"], pkg["messages"], pkg["primitives"], pkg["aggsig"]
    pairs = sorted(ps.keypair_exact(b"agg" + bytes(28) + bytes([i])) for i in range(4))
    keys = [(prim.PublicKey(pk), seed) for pk, seed in pairs]
    committee = pkg["config"].Committee.new([(pk, 1, ("127.0.0.1", 7000 + i)) for i, (pk, _) in enumerate(keys)])
    scheme = pkg["trusted"].TrustedAggScheme()
    prev_scheme = aggsig.install_agg_scheme(scheme)
    prev_reg = aggsig.install_agg_registry({pk.data: scheme.keypair_from_seed(seed)[0] for pk, seed in keys})
    try:
        agg = pkg["aggregator"].AggCertAggregator(committee, window=4)
        sorted_keys = committee.sorted_keys()
        sk = [scheme.keypair_from_seed(seed)[1] for _, seed in keys]
        digest = prim.Digest.of(b"block")
        vmsg = m._vote_digest(digest, 5).data
        bm = lambda idx: aggsig.bitmap_of([keys[i][0] for i in idx], sorted_keys)  # noqa: E731
        qc = None
        for idx in ((0, 1), (1,), (3,)):
            sig = scheme.aggregate([scheme.sign(sk[i], vmsg) for i in idx])
            qc = agg.add_vote_partial(m.AggVoteBundle(5, digest, bm(idx), sig, len(idx) - 1)) or qc
        tc = None
        for i, hqr in ((0, 3), (2, 4), (3, 3)):
            sig = scheme.sign(sk[i], m._timeout_digest(6, hqr).data)
            tc = agg.add_timeout_partial(6, ((hqr, bm((i,))),), sig, 0) or tc
        assert isinstance(qc, m.AggQC) and isinstance(tc, m.AggTC)
        qc.verify(committee)
        tc.verify(committee)
        wq, wt = pkg["writer"](), pkg["writer"]()
        m.encode_any_qc(wq, qc)
        m.encode_any_tc(wt, tc)
        return wq.bytes(), wt.bytes(), qc.signers(), tc.signers()
    finally:
        aggsig.install_agg_scheme(prev_scheme)
        aggsig.install_agg_registry(prev_reg)


def test_aggregate_certificates_match_the_reference():
    port, ref = _agg_certs(PKGS["port"]), _agg_certs(PKGS["reference"])
    assert port == ref
    assert port[2] == 3 and port[3] == 3
