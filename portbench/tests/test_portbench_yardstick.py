"""The frozen arithmetic: percentiles and rates over every sample, the
interval union, and the roofline counts, held equal to the program's
model at the commit that froze them."""

import math

import pytest

from portbench import yardstick


def test_percentile_is_nearest_rank_over_every_sample():
    values = list(range(1, 201))  # 200 samples: p95 is the 190th
    assert yardstick.percentile(values, 0.95) == 190
    assert yardstick.percentile(list(reversed(values)), 0.95) == 190
    assert yardstick.percentile([3.0], 0.95) == 3.0
    assert math.isnan(yardstick.percentile([], 0.95))


def test_percentile_matches_the_programs():
    from hotstuff_tpu_torch.utils import metrics

    values = [((i * 7919) % 1009) / 7.0 for i in range(1, 400)]
    for q in (0.5, 0.9, 0.95, 0.99):
        assert yardstick.percentile(values, q) == metrics.percentile(values, q)


def test_rate_is_all_work_over_all_time():
    assert yardstick.rate(1_000_000, 20.0) == 50_000.0


def test_device_intervals_union_and_clip():
    spans = [(5, 7), (0, 2), (1, 3), (6, 9), (12, 15)]
    assert yardstick.device_intervals(spans, 1, 13) == [(1, 3), (5, 9), (12, 13)]
    assert yardstick.device_intervals([], 0, 1) == []


@pytest.mark.parametrize("committee", [10, 50, 64])
@pytest.mark.parametrize("lanes", [1, 128, 4096])
def test_roofline_counts_equal_the_programs(lanes, committee):
    from hotstuff_tpu_torch import roofline

    rows = roofline.kernel_rows(committee)
    for path, names in yardstick.PATHS.items():
        for name in names:
            assert yardstick.OPS_PER_LANE[name] == rows[name]["ops_per_sig"]
            assert yardstick.kernel_bytes(name, lanes, committee) == roofline.kernel_bytes(name, lanes, committee)
    assert yardstick.HBM_BYTES_PER_S == roofline.HBM_BYTES_PER_S
    assert yardstick.INT32_OPS_PER_S == roofline.INT32_OPS_PER_S


def test_kernel_bound_is_the_programs_bound_summed():
    from hotstuff_tpu_torch import roofline

    rows = roofline.kernel_rows(64)
    want = sum(rows[n]["bound_ms"] for n in yardstick.PATHS["committee"]) / 1e3
    assert yardstick.kernel_bound_s("committee", roofline.LANES, 1, 64) == pytest.approx(want, rel=1e-12)
