"""`hotstuff_tpu_torch.ladder_ab`'s K7 and K6 legs on the CPU: their inputs,
and the launches they make, through stand-in kernels that run the plain
versions on the launch's arguments (the tool itself needs a card and
nvcc)."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from hotstuff_tpu_torch import ladder_ab
from hotstuff_tpu_torch.ops import bit_ladder as bl
from hotstuff_tpu_torch.ops import bls
from hotstuff_tpu_torch.ops import ed25519 as ted
from hotstuff_tpu_torch.ops import field
from tests.common_torch_threads import one_torch_thread  # noqa: F401


class _PlainBitLadder:
    """Stands in for `hs_bit_ladder(s_bits, h_bits, base, table, out, batch)`."""

    def __init__(self) -> None:
        self.launches = 0

    def launch(self, s_bits, h_bits, base, table, out, batch):
        self.launches += 1
        assert torch.equal(base, field.const("base_table", ted.BASE_TABLE, base.device))
        assert s_bits.shape == h_bits.shape == (ted.SCALAR_BITS, batch) and table.shape[-1] == batch
        out.copy_(bl.bit_ladder_plain(s_bits, h_bits, table))


def test_bit_ladder_leg_launches_k7_on_the_cut_inputs():
    """K7 is a source of the tool, timed at 128, 4,096 and the f32 path's
    8,192 lanes; its inputs hold (253, lanes) bits of s and h, and its
    runner launches K7's entry on the first w lanes, in its argument
    order, so the output is `bit_ladder_plain` of those lanes."""
    assert "bit_ladder" in ladder_ab.SOURCES and ladder_ab.source_of("bit_ladder") == "bit_ladder"
    assert ladder_ab.WIDTHS_OF["bit_ladder"] == (128, 4096, 8192)
    x = ladder_ab.inputs(0, 9, torch.device("cpu"))
    for k in ("sb", "hb"):
        assert x[k].dtype == torch.uint8 and x[k].shape == (ted.SCALAR_BITS, 9)
        assert set(x[k].unique().tolist()) == {0, 1}
    kernel = _PlainBitLadder()
    out, valid, run = ladder_ab.runner(kernel, "bit_ladder", x, 7)
    assert valid is None and out.shape == (4, field.NL, 7) and out.dtype == torch.int32
    run()
    assert kernel.launches == 1
    want = bl.bit_ladder_plain(x["sb"][:, :7], x["hb"][:, :7], x["table"][..., :7])
    assert torch.equal(out, want)


class _PlainFold:
    """Stands in for `hs_g1_aggregate(tx, ty, present, mask, out, n, batch)`,
    or, with `affine`, `hs_g1_aggregate_affine(..., out, identity, n, batch)`."""

    def __init__(self, affine: bool = False) -> None:
        self.affine = affine
        self.launches = 0

    def launch(self, tx, ty, present, mask, out, *rest):
        self.launches += 1
        if self.affine:
            identity, n, batch = rest
            limbs, flags = bls.g1_aggregate_affine_plain(tx, ty, present, mask)
            out.copy_(limbs)
            identity.copy_(flags)
        else:
            n, batch = rest
            out.copy_(bls.g1_aggregate_plain(tx, ty, present, mask))
        assert mask.shape == (batch, n) and out.shape[-1] == batch


def test_g1_aggregate_leg_times_both_builds_and_serves_aggregate_masks(monkeypatch):
    """K6's leg on phase 8's corpus cut to 8 keys x 6 rows: the fold alone
    of every build at all rows and at one, and `aggregate_masks` served by
    the affine entry where a build has one, by the fold and the host's
    `affine_points` where it has not; both give the same points."""
    monkeypatch.setattr(ladder_ab, "BLS_KEYS", 8)
    monkeypatch.setattr(ladder_ab, "BLS_ROWS", 6)
    monkeypatch.setattr(ladder_ab, "BLS_POOL", 2)
    monkeypatch.setattr(ladder_ab, "queued_ms", lambda fn, reps=20: fn() or 0.0)
    fold = {"shipped": _PlainFold(), "old": _PlainFold()}
    affine = {"shipped": _PlainFold(affine=True)}
    res = ladder_ab.bls_ab(fold, affine, 2, 0, torch.device("cpu"))
    assert set(res) == {"shipped", "old"}
    for name, row in res.items():
        assert len(row["queued_ms_6"]) == len(row["queued_ms_1"]) == len(row["aggregate_masks_wall_ms"]) == 2
    assert res["shipped"]["served_by"] == "affine entry + affine_of_limbs"
    assert res["old"]["served_by"] == "fold + host affine_points"
    assert affine["shipped"].launches == 3 and fold["old"].launches == 2 * (1 + 2) + 2


def test_g1_aggregate_leg_refuses_a_build_that_differs(monkeypatch):
    monkeypatch.setattr(ladder_ab, "BLS_KEYS", 8)
    monkeypatch.setattr(ladder_ab, "BLS_ROWS", 6)
    monkeypatch.setattr(ladder_ab, "BLS_POOL", 2)

    class _Off(_PlainFold):
        def launch(self, tx, ty, present, mask, out, *rest):
            super().launch(tx, ty, present, mask, out, *rest)
            out[0, 0, 0] ^= 1

    with pytest.raises(SystemExit, match="old/g1_aggregate differs from the shipped build"):
        ladder_ab.bls_ab({"shipped": _PlainFold(), "old": _Off()}, {}, 1, 0, torch.device("cpu"))


def test_bls_leg_runs_phase_8s_largest_corpus():
    assert (ladder_ab.BLS_KEYS, ladder_ab.BLS_ROWS) == (chip_smoke.BLS_SIZES[-1], chip_smoke.BLS_ROWS)


class _PlainChain:
    """Stands in for `hs_mont_chain(a, b, out, chains, field, steps, batch)`
    with the plain `mont_mul`, and the control's multiply-adds in int64."""

    def __init__(self, flip: bool = False) -> None:
        self.flip = flip
        self.launches = 0

    def launch(self, a, b, out, chains, on_field, steps, batch):
        self.launches += 1
        assert a.shape == (2 * bls.NLIMB, batch) and b.shape == (bls.NLIMB, batch)
        assert out.shape == (chains * bls.NLIMB, batch)
        y = field.from_i32(b)
        for c in range(chains):
            x = field.from_i32(a[c * bls.NLIMB:(c + 1) * bls.NLIMB])
            for _ in range(steps):
                if on_field:
                    x = bls.mont_mul(x, y)
                else:
                    for _ in range(ladder_ab.CONTROL_OPS):
                        x[0] = (x[0] * x[0] + y[0]) & 0xFFFFFFFF
            out[c * bls.NLIMB:(c + 1) * bls.NLIMB] = field.to_i32(x)
        if self.flip:
            out[0, -1] ^= 1


def test_chain_leg_holds_every_build_to_python_ints(monkeypatch):
    """The carry-overlap leg on 5 lanes x 3 steps: the field chain and the
    control, one chain and two, every lane checked against `chain_want`'s
    closed form, and two chains' time over one chain's reported."""
    monkeypatch.setattr(ladder_ab, "queued_ms", lambda fn, reps=20: fn() or 1.0)
    kernels = {"shipped": _PlainChain(), "old": _PlainChain()}
    res = ladder_ab.chain_ab(kernels, 2, 0, torch.device("cpu"), 5, steps=3, checked=5)
    for name in kernels:
        assert set(res[name]) == {"field", "control"}
        for row in res[name].values():
            assert row["two_over_one"] == 1.0 and len(row["ns_per_step_1"]) == len(row["ns_per_step_2"]) == 2
        assert kernels[name].launches == 2 * 2 * (1 + 2)
    assert "hs_mont_chain" in ladder_ab.CHAIN_SOURCE and '#include "g1_aggregate.cu"' in ladder_ab.CHAIN_SOURCE


def test_chain_leg_refuses_a_build_that_differs():
    with pytest.raises(SystemExit, match="old/mont_chain \\(field, 1 chains\\) differs from the shipped build"):
        ladder_ab.chain_ab({"shipped": _PlainChain(), "old": _PlainChain(flip=True)}, 1, 0, torch.device("cpu"), 3,
                           steps=1, checked=1)
    with pytest.raises(SystemExit, match="shipped/mont_chain \\(field, 1 chains\\) differs from Python's ints"):
        ladder_ab.chain_ab({"shipped": _PlainChain(flip=True)}, 1, 0, torch.device("cpu"), 3, steps=1, checked=3)
