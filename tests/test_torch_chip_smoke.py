"""CPU rehearsal of `chip_smoke.py`'s kernel-comparison phases.

On the CPU every kernel wrapper runs its plain version, so both sides of
each comparison are plain: these tests hold the phases' control flow
(shapes, widths, cuts, out-of-range indices, result rows), not the CUDA
kernels, which only `chip_smoke.py` on the card can hold. `LANES` is shrunk
to 16, which cuts the width list to 1, 7 and 16 and still holds the eight
special keys of K3 and the four out-of-range indices of K5, and the CUDA
timers are stubbed.
"""

from __future__ import annotations

import hashlib

import pytest

import chip_smoke
from hotstuff_tpu_torch import breakdown
from hotstuff_tpu_torch.crypto import pysigner

LANES = 16
KEYS = ("ladder", "h_digits", "decompress_table", "compress_eq")
ROW_KEYS = {"ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by", "bytes", "ops"}


@pytest.fixture
def small_smoke(monkeypatch):
    monkeypatch.setattr(chip_smoke, "LANES", LANES)
    monkeypatch.setattr(breakdown, "queued_ms", lambda fn, reps=20: 0.0)
    monkeypatch.setattr(chip_smoke, "_plain_ms", lambda fn: (0.0, fn()))
    return chip_smoke


def test_widths_cut_to_lanes(small_smoke):
    assert small_smoke._widths() == [1, 7, 16]


def test_phase_compare_on_cpu(small_smoke, capsys):
    results = small_smoke.phase_compare(0, "cpu")
    assert set(results) == set(KEYS)
    for name, res in results.items():
        assert ROW_KEYS <= set(res), name
        assert res["max_abs_err"] == 0, name
        assert res["bound_ms"] > 0 and res["bound_by"] in ("bytes", "operations"), name
    out = capsys.readouterr().out
    assert "raw limbs and valid identical to the plain version at widths [1, 7, 16]" in out
    assert "K1: raw limbs identical to the plain version at widths [1, 7, 16]" in out
    assert "K4: mask identical to the plain version at widths [1, 7, 16]" in out


def test_k4_lanes_by_construction(small_smoke):
    """K4's lambda-scaled, identity, non-canonical-R and invalid lanes: the
    mask known by construction is the plain version's, scaling changes no
    lane's mask, and each class is present."""
    import numpy as np
    import torch

    from hotstuff_tpu_torch.ops import ed25519 as ed
    from hotstuff_tpu_torch.ops import field

    rng = np.random.default_rng(5)
    n = LANES
    lam = field.limbs_of_int([int(v) % field.P + 1 for v in rng.integers(1, 2**62, n)])
    pts = torch.stack([field.mul(field.limbs_of_int([int(v) for v in rng.integers(1, 2**62, n)]), lam)
                       for _ in range(4)]).to(torch.int32)
    enc = ed.compress(pts)
    xyzt, r, valid, want = small_smoke._k4_inputs(rng, pts, enc, torch.device("cpu"))
    assert ed.compress_eq_plain(xyzt, r, valid).tolist() == want
    scaled = [i for i in range(0, n, 3) if i not in small_smoke.K4_IDENTITY_R]
    assert torch.equal(ed.compress(xyzt)[:, scaled], enc[:, scaled])
    assert not torch.equal(xyzt[:, :, scaled], pts[:, :, scaled])
    assert [want[i] for i in small_smoke.K4_IDENTITY_R] == [True, False, False]
    assert not valid[5] and not want[5] and want[0] and not want[7]


def test_phase_committee_compare_on_cpu(small_smoke, capsys):
    seeds = [hashlib.sha256(b"validator %d" % i).digest() for i in range(6)]
    keys = [pysigner.keypair_from_seed(s)[0] for s in seeds] + small_smoke._committee_special_keys()
    results = small_smoke.phase_committee_compare(0, keys, "cpu")
    assert set(results) == {"committee_ladder", "h_digits_idx"}
    for name, res in results.items():
        assert ROW_KEYS <= set(res), name
        assert res["max_abs_err"] == 0, name
    out = capsys.readouterr().out
    assert "K5: raw limbs and lane_valid identical to the plain version at widths [1, 7, 16]" in out


def test_spill_bytes_parses_ptxas():
    from hotstuff_tpu_torch.ops import _build

    clean = ("ptxas info    : Used 96 registers | 0 bytes stack frame, 0 bytes spill stores, "
             "0 bytes spill loads")
    assert _build.spill_bytes(clean) == 0
    assert _build.spill_bytes(clean.replace("0 bytes spill stores", "24 bytes spill stores")) == 24
    assert _build.spill_bytes("") == 0


def test_phase_reduce_compare_on_cpu(small_smoke, capsys):
    """The reduction phase's values are the reduction tests' own: the 11
    edge values and the 4,096-value sweep (its first rows all-ones with a
    zero byte, rows 256..511 near multiples of L)."""
    edges, sweep = small_smoke._reduce_values()
    assert len(edges) == 11 and len(sweep) == 4096
    assert all(0 <= v < 2**512 for v in edges + sweep)
    assert sum(v % pysigner.L < 4 or pysigner.L - v % pysigner.L < 4 for v in sweep[256:512]) == 256
    results = small_smoke.phase_reduce_compare("cpu")
    assert set(results) == {"reduce_mod_l"}
    res = results["reduce_mod_l"]
    assert ROW_KEYS <= set(res) and res["max_abs_err"] == 0
    assert res["bytes"] == 4096 * 96 and res["bound_by"] in ("bytes", "operations")
    assert "on 11 edge values and the 4096-value sweep" in capsys.readouterr().out
