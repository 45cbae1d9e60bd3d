"""A clean process for each chaos run that a test holds to be deterministic.

Both packages' chaos runs replay their seed on the virtual clock, but two
inputs of a run come from the process, not the seed, in both packages:

  * the metrics registry is process-global, and a telemetry plane ships
    its nonzero gauges whole, so a level that earlier work in the worker
    left set rides the run's snapshots and the watchdog's dumps of them;
  * the watchdog's verify-regression trigger (`note_verify`) samples the
    batch service's flushes with `time.perf_counter`, so under load it
    can fire in one run and not in a replay, and its trigger, event,
    counter, dump and incident are then wall-clock fields of the report.

A test module imports `chaos_process_state` to zero both registries'
gauges and to hold the trigger off in both packages (its factor set to
infinity) for each of its tests; `zero_gauges` zeroes them between two
runs in one test, and `NO_VERIFY_TRIGGER_ENV` holds the trigger off in a
subprocess. The trigger itself is held to the reference's in
`tests/test_torch_tracing_watchdog.py`.
"""

from __future__ import annotations

import pytest

from hotstuff_tpu.utils import metrics as r_metrics
from hotstuff_tpu.utils import tracing as r_tracing
from hotstuff_tpu_torch.utils import metrics as p_metrics
from hotstuff_tpu_torch.utils import tracing as p_tracing

NO_VERIFY_TRIGGER_ENV = {"HOTSTUFF_TRACE_P99_FACTOR": "inf"}


def zero_gauges() -> None:
    for metrics in (r_metrics, p_metrics):
        for name in metrics.dump()["gauges"]:
            metrics.gauge(name)._reset()


@pytest.fixture(autouse=True)
def chaos_process_state(monkeypatch):
    for watchdog in (r_tracing.WATCHDOG, p_tracing.WATCHDOG):
        monkeypatch.setattr(watchdog, "p99_factor", float("inf"))
    zero_gauges()
    yield
