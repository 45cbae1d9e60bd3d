"""`hotstuff_tpu_torch.ladder_ab`'s K7 leg on the CPU: its inputs, and the
launch its runner makes, through a stand-in kernel that runs the plain
version on the launch's arguments (the tool itself needs a card and nvcc)."""

from __future__ import annotations

import torch

from hotstuff_tpu_torch import ladder_ab
from hotstuff_tpu_torch.ops import bit_ladder as bl
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
