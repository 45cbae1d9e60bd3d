"""The port's `latch_probe` and `roofline` tools, and `chip_smoke.py`'s
phase 14 and phase 13 telemetry checks, on the CPU.

`python -m hotstuff_tpu_torch.latch_probe --device cpu` runs its three
phases on the kernels' plain versions (a few lanes), where all three
contracts must hold. `roofline` is the one source of the bound column's
constants: `chip_smoke.py`'s names are its objects, and each bound it
prints is `bound_ms` over the same bytes and products as the kernels
line's. The phase 14 and phase 13 helpers run on made-up scrapes, the
plain versions or a stub backend.
"""

from __future__ import annotations

import json

import pytest

import chip_smoke
from hotstuff_tpu_torch import latch_probe, roofline
from hotstuff_tpu_torch.ops import _build, ladder
from tests.common_torch_threads import one_torch_thread  # noqa: F401

CONSTANTS = ("HBM_BYTES_PER_S", "INT32_OPS_PER_S", "H_DIGITS_OPS_PER_LANE", "REDUCE_OPS_PER_LANE",
             "BLS_OPS_PER_PRODUCT", "BLS_OPS_PER_SQUARE", "BLS_OPS_PER_REDUCTION", "BLS_OPS_PER_MEMBER",
             "BLS_CHAIN_SQUARES", "BLS_CHAIN_PRODUCTS", "BLS_OPS_PER_CHAIN", "BLS_OPS_PER_AFFINE",
             "BIT_DBL_PRODUCTS", "BIT_MADD_PRODUCTS")


def test_latch_probe_contracts_on_the_card_rules():
    """On the card a forced K2 failure must propagate with the latch on and
    K2 must have launched; the CPU's rules would fail there."""
    organic = {"masks_ok": True, "latch_fired": False, "latch_state_ok": True, "k2_launches": 3}
    card_forced = {"raised": True, "latch_ended_off": False, "device_hash_fallbacks": 0,
                   "mask_correct_via_host_retry": None}
    cpu_forced = {"raised": False, "latch_ended_off": True, "device_hash_fallbacks": 1,
                  "mask_correct_via_host_retry": True}
    transient = {"raised": True, "latch_survived_on": True}
    assert latch_probe.contracts([organic, card_forced, transient], on_card=True)
    assert not latch_probe.contracts([organic, cpu_forced, transient], on_card=True)
    assert latch_probe.contracts([organic, cpu_forced, transient], on_card=False)
    assert not latch_probe.contracts([{**organic, "k2_launches": 0}, card_forced, transient], on_card=True)


def test_chip_smoke_takes_the_roofline_constants():
    for name in CONSTANTS:
        assert getattr(chip_smoke, name) is getattr(roofline, name), name
    assert chip_smoke._bound_ms is roofline.bound_ms and chip_smoke.kernel_bytes is roofline.kernel_bytes


def test_roofline_bounds_are_the_kernels_lines(capsys):
    """Each printed bound is `bound_ms` over the kernel's bytes and its
    products a lane times the lanes, as `chip_smoke.py` computes its rows
    (phase 14 holds these against the rows of the card's run, whose
    products are counted at 4,096 lanes)."""
    out = roofline.main(["--rate", "250000", "--committee", "67"])
    text = capsys.readouterr().out
    counted = roofline.count_products()
    assert set(counted) == {"decompress_table", "ladder", "compress_eq", "committee_ladder"}
    assert all(n > 0 for n in counted.values())
    ops = {**counted, "h_digits": roofline.H_DIGITS_OPS_PER_LANE, "h_digits_idx": roofline.H_DIGITS_OPS_PER_LANE}
    assert set(out["kernels"]) == {name for _p, _k, name in roofline.PATHS}
    for name, row in out["kernels"].items():
        moved = roofline.kernel_bytes(name, 4096, 67)
        assert (row["bound_ms"], row["bound_by"]) == chip_smoke._bound_ms(moved, 4096 * ops[name]), name
        assert row["ops_per_sig"] == ops[name] and row["bytes_per_sig"] == moved / 4096
        assert f"{row['bound_ms']:.4f}" in text
    generic = sum(ops[n] for n in ("h_digits", "decompress_table", "ladder", "compress_eq"))
    assert out["ops_per_sig"]["generic"] == generic
    assert out["implied_ops_per_s"]["generic"] == 250000 * generic
    assert f"{250000 * generic / roofline.INT32_OPS_PER_S:.2%} of the issue ceiling" in text
    assert json.loads(text.splitlines()[-1]) == json.loads(json.dumps(out))


def test_phase_roofline_fails_on_a_differing_row(capsys):
    rows = roofline.kernel_rows(67)
    assert chip_smoke.phase_roofline(1000.0, 67, rows)["kernels"] == rows
    rows["ladder"] = {**rows["ladder"], "bound_ms": rows["ladder"]["bound_ms"] * 2}
    with pytest.raises(SystemExit, match="roofline bounds differ"):
        chip_smoke.phase_roofline(1000.0, 67, rows)


def test_latch_probe_holds_its_contracts_on_the_cpu(capsys):
    """`latch_probe --device cpu` as phase 14 runs it (its `main`, echoed):
    three phases on a few lanes of the plain versions, every contract
    held."""
    summary = chip_smoke.phase_latch_probe("cpu", lanes=4)
    lines = [json.loads(ln.split("| ", 1)[1]) for ln in capsys.readouterr().out.splitlines()]
    organic, forced, transient, last = lines
    assert organic["masks_ok"] and not organic["latch_fired"] and organic["inputs_checked"] == 10
    assert not forced["raised"] and forced["mask_correct_via_host_retry"] and forced["latch_ended_off"]
    assert transient["raised"] and transient["latch_survived_on"]
    assert last == summary and summary["contracts_held"] is True and summary["device"] == "cpu"
    # The patched calls are restored.
    assert ladder.verify_packed128_dh.__name__ == "verify_packed128_dh"


def test_phase_steal_checks_masks_lanes_and_steals(monkeypatch, capsys):
    """Phase 14's flood through a stub of `TorchBackend` that answers with
    the expected mask: steals move, the backends' lanes add up; a wrong
    mask fails the phase."""
    from hotstuff_tpu_torch.crypto import torch_backend

    expected = [i % 5 != 0 for i in range(64)]
    answer = {}

    class Stub:
        def __init__(self, **_kw):
            self.stats = {"device_sigs": 0, "host_sigs": 0}

        def verify_batch_mask(self, messages, keys, signatures, **_kw):
            self.stats["device_sigs"] += len(messages)
            return [answer.get(m, True) for m in messages]

    monkeypatch.setattr(torch_backend, "TorchBackend", Stub)
    monkeypatch.setattr(chip_smoke, "STEAL_GROUP", 4)
    monkeypatch.setattr(chip_smoke, "STEAL_BUCKET", 8)
    msgs = [bytes([i]) * 32 for i in range(64)]
    answer.update(zip(msgs, expected))
    batch = (msgs, [bytes(32)] * 64, [bytes(64)] * 64, expected)
    out = chip_smoke.phase_steal(batch, "cpu")
    assert out["stats"]["steals"] > 0 and sum(out["lanes"]) == 64 and min(out["lanes"]) > 0
    assert "this checks the accounting only" in capsys.readouterr().out
    answer[msgs[1]] = False
    with pytest.raises(SystemExit, match="a mask differs"):
        chip_smoke.phase_steal(batch, "cpu")


def _scrape(label, snapshots, lanes, batches=3):
    snaps = [{"seq": i, "t": float(i)} for i in range(snapshots)]
    if snaps:
        snaps[-1]["counters"] = {"verifier.batches": batches}
    from hotstuff_tpu_torch.utils import telemetry

    return {"kind": "telemetry", "node": label, "snapshots": snaps, "lanes": lanes, "alerts": [],
            "active_alerts": [], "slos": [{"name": s.name} for s in telemetry.default_slos()]}


def test_node_scrape_errors():
    lanes = {"consensus": {"count": 5}, "mempool": {"count": 9}}
    assert chip_smoke.node_scrape_errors(".node-0", [_scrape(".node-0", 1, lanes), _scrape(".node-0", 3, lanes)]) == []
    assert chip_smoke.scrape_batches(_scrape("x", 2, lanes, batches=7)) == 7
    stuck = chip_smoke.node_scrape_errors(".node-1", [_scrape(".node-1", 2, lanes), _scrape(".node-1", 2, lanes)])
    assert stuck == [".node-1: the snapshot ring did not grow (2 -> 2)"]
    idle = chip_smoke.node_scrape_errors(".node-2", [_scrape(".node-2", 1, {}), _scrape(".node-2", 3, {"mempool": {"count": 1}}, 0)])
    assert idle[0].startswith(".node-2: no events on the ['consensus'] lanes") and "verify.e2e SLO saw no event" in idle[1]
    other = chip_smoke.node_scrape_errors(".node-3", [_scrape(".node-2", 1, lanes), _scrape(".node-3", 3, lanes)])
    assert len(other) == 1 and "not a telemetry dump of '.node-3'" in other[0]
    assert chip_smoke.telemetry_errors({**_scrape("b", 1, {}), "slos": []}, "b") == ["b: the scrape's SLOs are []"]


def test_port_node_command_takes_the_telemetry_port():
    from hotstuff_tpu_torch.node import main as node_main

    cmd = chip_smoke.port_node_cmd("py", 1, "c.json", "p.json", "m.json", 9123)
    assert node_main.parse_args(cmd[4:]).telemetry_port == 9123
    assert "--telemetry-port" not in chip_smoke.port_node_cmd("py", 1, "c.json", "p.json", "m.json")
    assert set(_build.KERNELS) >= {name for _p, _k, name in roofline.PATHS}
