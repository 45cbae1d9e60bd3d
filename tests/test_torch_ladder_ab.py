"""`hotstuff_tpu_torch.ladder_ab`'s K7, K6 and K8 legs on the CPU: their inputs,
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
from hotstuff_tpu_torch.ops import field12 as f12
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


class _PlainField12:
    """Stands in for `hs_field12(x, out, n, batch)` (or, with `mul`,
    `hs_field12_mul(a, b, out, batch)`) through the plain versions."""

    def __init__(self, mul: bool = False, flip: bool = False) -> None:
        self.mul, self.flip = mul, flip
        self.launches = 0

    def launch(self, *args):
        self.launches += 1
        if self.mul:
            a, b, out, batch = args
            out.copy_(f12.mul_plain(a, b))
        else:
            x, out, n, batch = args
            out.copy_(f12.sqr_n_plain(x, n))
        assert out.shape == (f12.NLIMB, batch)
        if self.flip:
            out[0, -1] ^= 1


class _PlainSqrChain:
    """Stands in for `hs_field_sqr_n(x, out, n, batch)`."""

    def __init__(self) -> None:
        self.launches = 0

    def launch(self, x, out, n, batch):
        self.launches += 1
        assert x.shape == (field.NL, batch)
        out.copy_(field.sqr_chain(x, n))


def test_field12_leg_times_both_builds_beside_the_production_field(monkeypatch):
    """K8's leg at widths 3 and 5, a chain of 2: every build's `hs_field12`
    and `hs_field12_mul` against the shipped build's, then both builds and
    `hs_field_sqr_n` timed in turns at the timed widths, with the ratio of
    each build's median to the production field's."""
    monkeypatch.setattr(ladder_ab, "queued_ms", lambda fn, reps=20: fn() or 2.0)
    kernels = {name: (_PlainField12(), _PlainField12(mul=True)) for name in ("shipped", "old")}
    chain = _PlainSqrChain()
    res = ladder_ab.field12_ab(kernels, chain, 2, 0, torch.device("cpu"), widths=(3, 5), timed=(5,), mul_width=4,
                               chain=2)
    assert set(res["builds"]) == {"shipped", "old"}
    for row in res["builds"].values():
        assert row["limbs_equal_at"] == [3, 5] and row["mul_equal_at"] == 4
        assert row["queued_ms_5"] == [2.0, 2.0] and row["over_field_sqr_n_5"] == 1.0
    assert res["field_sqr_n"]["queued_ms_5"] == [2.0, 2.0]
    for sq, mul in kernels.values():
        assert sq.launches == 2 + 2 and mul.launches == 1  # one check a width, one a timed round
    assert chain.launches == 2
    assert (ladder_ab.F12_WIDTHS, ladder_ab.F12_TIMED) == ((7, 128, 4096, 135168), (128, 4096, 135168))
    assert ladder_ab.F12_CHAIN == chip_smoke.FIELD12_CHAIN and ladder_ab.source_of(ladder_ab.F12) == "field12"


def test_field12_leg_inputs_are_normalized_with_the_edges_first():
    x, y, x25 = ladder_ab.field12_inputs(0, 9, torch.device("cpu"))
    assert x.shape == y.shape == (f12.NLIMB, 9) and x25.shape == (field.NL, 9)
    assert f12.int_of_limbs(x)[:4] == [0, 1, f12.P - 1, 2**255 - 20]
    assert all(v < 2**255 for v in f12.int_of_limbs(x) + f12.int_of_limbs(y))
    assert int(x25.min()) >= 0 and all(int(x25[i].max()) < 2 ** w for i, w in enumerate(field.WIDTHS))


def test_field12_leg_refuses_a_build_that_differs():
    cpu = torch.device("cpu")
    with pytest.raises(SystemExit, match="old/field12 differs from the shipped build at 3 lanes"):
        ladder_ab.field12_ab({"shipped": (_PlainField12(), _PlainField12(mul=True)),
                              "old": (_PlainField12(flip=True), _PlainField12(mul=True))},
                             _PlainSqrChain(), 1, 0, cpu, widths=(3,), timed=(3,), mul_width=3, chain=1)
    with pytest.raises(SystemExit, match="old/field12_mul differs from the shipped build at 3 lanes"):
        ladder_ab.field12_ab({"shipped": (_PlainField12(), _PlainField12(mul=True)),
                              "old": (_PlainField12(), _PlainField12(mul=True, flip=True))},
                             _PlainSqrChain(), 1, 0, cpu, widths=(3,), timed=(3,), mul_width=3, chain=1)


SASS = """
        Function : _ZN12_GLOBAL__N_118field12_mul_kernelEPKjS1_Pji
        /*0000*/                   IMAD R1, R2, R3, R4 ;
        /*0010*/                   IMAD R1, R2, R3, R4 ;
        /*0020*/                   LOP3.LUT R1, R2, 0xfff, RZ, 0xc0, !PT ;
        /*0030*/                   IMAD R1, R2, R3, R4 ;
        /*0040*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_114field12_kernelEPKjPjii
        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;
        /*0010*/                   IMAD R1, R2, R3, R4 ;
        /*0020*/                   LEA.HI R1, R2, R3, RZ, 0x14 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/              @P0  BRA 0x10 ;
        /*0050*/                   EXIT ;
"""


def test_sass_counts_read_one_function_of_a_library():
    """K8's library holds four kernels whose addresses all start at 0: the
    squaring loop (the backward branch at 0x40) is counted in
    `field12_kernel` alone, not with the product kernel's instructions at
    the same addresses."""
    counts = ladder_ab.sass_counts(None, "field12", SASS)
    assert counts == dict(IMAD=1, LEA=1, BAR=1, BRA=1, total=4, all=11)
    with pytest.raises(SystemExit, match="0 SASS functions of field12"):
        ladder_ab.sass_counts(None, "field12", SASS.replace("14field12_kernel", "14field99_kernel"))
