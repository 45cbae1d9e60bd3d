"""The port's chaos scenarios of fault plans and aggregation-overlay failure
modes, held to their own expectations on the port alone (seed 11, as the
reference's tests run them): every invariant holds, no expectation fails,
the report is `ok`. The cross-package comparisons are
`tests/test_torch_chaos.py`'s.
"""

from __future__ import annotations

import pytest

from hotstuff_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario
from tests.common_torch_chaos import chaos_process_state  # noqa: F401  (autouse)

NAMES = [
    "lossy_links", "partition_heal", "leader_crash", "timeout_storm", "agg_collector_crash",
    "agg_byzantine_bundles", "wan_observatory",
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
