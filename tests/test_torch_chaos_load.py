"""The port's chaos scenarios of client ingress, the bulk flood, the SLO
burn, the incident ledger and commit proofs, held to their own
expectations on the port alone (seed 11, as the reference's tests run
them): every invariant holds, no expectation fails, the report is `ok`.
The cross-package comparisons are `tests/test_torch_chaos.py`'s, which
hold `incident_smoke` against the reference field for field.
"""

from __future__ import annotations

import pytest

from hotstuff_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario
from tests.common_torch_chaos import chaos_process_state  # noqa: F401  (autouse)

NAMES = [
    "flash_crowd_ingress", "bulk_flood_priority", "slo_burn_bulk", "ingress_proofs", "proof_squatter",
]


@pytest.mark.parametrize("name", NAMES)
def test_port_scenario_holds_its_expectations(name):
    assert not SCENARIOS[name].slow
    report = run_scenario(name, 11)
    assert report["safety_violations"] == []
    assert report["liveness_violations"] == []
    assert report.get("expectation_failures", []) == []
    assert report["ok"], report
    assert report["commits"] and all(report["commits"].values())
