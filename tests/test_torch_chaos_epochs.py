"""The port's chaos scenarios of reconfiguration, catch-up, committee churn
and region-aware election, held to their own expectations on the port
alone (seed 11, as the reference's tests run them): every invariant holds,
no expectation fails, the report is `ok`. The cross-package comparisons
are `tests/test_torch_chaos.py`'s.
The churnscenarios run under the trusted-crypto stub, as the reference's
own tests run them (`tests/test_chaos.py`).
"""

from __future__ import annotations

import pytest

from hotstuff_tpu_torch.chaos.scenarios import SCENARIOS, SHORT_SCENARIOS, run_scenario

NAMES = [
    "epoch_reconfig", "genesis_catchup", "long_offline_catchup", "agg_epoch_boundary",
    "rolling_churn", "boundary_quorum_crash", "multi_epoch_catchup", "wan_election",
]
TRUSTED = ("rolling_churn", "boundary_quorum_crash", "multi_epoch_catchup")


@pytest.mark.parametrize("name", NAMES)
def test_port_scenario_holds_its_expectations(name):
    assert not SCENARIOS[name].slow
    report = run_scenario(name, 11, trusted_crypto=name in TRUSTED)
    assert report["safety_violations"] == []
    assert report["liveness_violations"] == []
    assert report.get("expectation_failures", []) == []
    assert report["ok"], report
    assert report["commits"] and all(report["commits"].values())


def test_every_non_slow_scenario_is_held_somewhere():
    """The port's non-slow scenarios are the cross-package seven of
    `test_torch_chaos.py` and the three files' lists, each once."""
    from tests import test_torch_chaos, test_torch_chaos_faults, test_torch_chaos_load

    held = [*test_torch_chaos.CROSS, *test_torch_chaos_faults.NAMES, *test_torch_chaos_load.NAMES, *NAMES]
    assert sorted(held) == sorted(SHORT_SCENARIOS) and len(set(held)) == len(held)
