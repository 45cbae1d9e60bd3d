"""GF(2^255 - 19) in 22 radix-2^12 uint32 limbs — the plain PyTorch version
of kernel K8 (`csrc/field12.cu`) and its wrappers.

Counterpart of `hotstuff_tpu/ops/field12.py`, the reference's experimental
field (its own copy here: nothing is imported from the JAX package). The
reference built it to answer one question with a benchmark: does a field
of 22 x 22 = 484 narrow products beat the production field? A uint32
accumulator holds every column sum exactly (products < 2^27, 22 terms <
2^31.1, `field12.py:8-10`), so on Hopper each product is one 32-bit IMAD,
against the port's 10-limb field (`ops/field.py`, `csrc/field.cuh`) at 100
IMAD.WIDE a product. `python -m hotstuff_tpu_torch.tune_device --field`
reads the answer on the card; the verifier stays on `ops/field.py`
whatever it says, as the reference keeps its verifier on `ops.field`.

An element batch is a `(NLIMB, B)` tensor, batch on the last axis, as in the
JAX package. Its dtype is `torch.int32` carrying the uint32 bits (limbs of
2^31 and above read as negative int32); the functions also take int64
tensors of values in [0, 2^32). PyTorch's `torch.uint32` lacks most
arithmetic, so the plain versions compute on int64 and mask with
`& 0xFFFFFFFF` after every add, subtract and product: shifts and masks are
then uint32's, and every function equals the JAX function limb for limb,
`sub`'s silent wrap included (`field12.py:114-117`). The carry passes and
folds stay exactly where the reference puts them; only the order in which
product rows are summed differs, which uint32's ring arithmetic ignores.

Kernel wrappers (`mul`, `sqr`, `sqr_n`, `sub`, `canonical`): a CPU tensor
runs the plain version; a CUDA tensor launches K8 or raises. K8's products
give a lane four threads, one in each warp of a block, by the partition
table of `csrc/field12.cu` (`kernel_layout`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from . import _build
from .field import ProductCount, const, from_i32, to_i32

P = 2**255 - 19
NLIMB = 22
BITS = 12
RADIX = 1 << BITS  # 4096
MASK = RADIX - 1
# 2^264 = 2^9 * 2^255 = 2^9 * 19 (mod p)
FOLD = 19 << 9  # 9728
U32 = 0xFFFFFFFF

# Limb products of one operation on the card (`csrc/field12.cu`): a mul is
# the full 22 x 22 convolution, a squaring its diagonal and one triangle.
MUL_PRODUCTS = NLIMB * NLIMB  # 484
SQR_PRODUCTS = NLIMB + NLIMB * (NLIMB - 1) // 2  # 22 + 231 = 253
# Products per lane done by the plain `mul_plain` / `sqr_plain` since the
# last reset: the operation count behind K8's bound (`chip_smoke.py`).
PRODUCTS = ProductCount()


def limbs_of_int(x: int, n: int = NLIMB) -> np.ndarray:
    """(n, 1) uint32 numpy limbs of 0 <= x < 2^(12 n), the reference's
    host layout."""
    assert 0 <= x < (1 << (BITS * n))
    out = np.zeros((n, 1), np.uint32)
    for i in range(n):
        out[i, 0] = (x >> (BITS * i)) & MASK
    return out


def int_of_limbs(limbs) -> list[int]:
    """Exact value per batch column of (n, B) limbs: a numpy array, or a
    tensor of uint32 bits."""
    if isinstance(limbs, torch.Tensor):
        limbs = from_i32(limbs.detach().cpu()).numpy()
    arr = np.asarray(limbs, np.uint64)
    return [
        sum(int(arr[i, b]) << (BITS * i) for i in range(arr.shape[0]))
        for b in range(arr.shape[1])
    ]


def tensor_of_ints(values, device: str | torch.device = "cpu") -> torch.Tensor:
    """(NLIMB, len(values)) int32 limbs of ints in [0, 2^264)."""
    cols = np.concatenate([limbs_of_int(v) for v in values], axis=1)
    return torch.from_numpy(cols.view(np.int32)).to(device)


def _make_bias(mult: int, lo: int) -> np.ndarray:
    """Limbs of mult*p with every limb in [lo, 2^17): per-limb lower bound
    lets `sub` stay nonnegative without borrows."""
    digits = [(mult * P >> (BITS * i)) & MASK for i in range(NLIMB)]
    digits[NLIMB - 1] += RADIX * (mult * P >> (BITS * NLIMB))
    for i in range(NLIMB - 1):
        while digits[i] < lo:
            digits[i] += RADIX
            digits[i + 1] -= 1
    assert digits[NLIMB - 1] >= lo and all(0 <= d < 2**17 for d in digits)
    assert sum(d << (BITS * i) for i, d in enumerate(digits)) == mult * P
    return np.array(digits, np.uint32).reshape(NLIMB, 1)


# The per-limb floor 8*RADIX exceeds every subtrahend limb after one lazy
# add (limb 0 <= ~28k); mult 8192 keeps the top digit above the floor.
BIAS = _make_bias(8192, 8 * RADIX)
P_COMPLEMENT = limbs_of_int((1 << (BITS * NLIMB)) - P)  # 2^264 - p

ZERO = limbs_of_int(0)
ONE = limbs_of_int(1)


def _const(name: str, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """(NLIMB, 1) numpy uint32 constant as int64 on `like`'s device, made
    once per device."""
    return const(f"field12_{name}", torch.from_numpy(arr.astype(np.int64)), like.device)


# ---------------------------------------------------------------------------
# Plain versions (the reference's order of operations)
# ---------------------------------------------------------------------------


def _carry_pass(c: torch.Tensor, wrap: bool) -> torch.Tensor:
    c = from_i32(c)
    hi = c >> BITS
    lo = c & MASK
    if wrap:
        head = (lo[:1] + ((hi[-1:] * FOLD) & U32)) & U32
    else:
        head = lo[:1]
    return to_i32(torch.cat([head, (lo[1:] + hi[:-1]) & U32], dim=0))


def carry(c: torch.Tensor) -> torch.Tensor:
    """Three wrapping carry passes: limbs < 2^30.6 -> normalized limbs,
    <= ~4100 for rows 1..21 and <= RADIX + FOLD + eps (~14k) for row 0."""
    for _ in range(3):
        c = _carry_pass(c, wrap=True)
    return c


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lazy addition (at most one before a mul/sub)."""
    return to_i32((from_i32(a) + from_i32(b)) & U32)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p), normalized: carry(a + BIAS - b) in uint32. Input
    bound: at most one lazy add of normalized elements per operand, or the
    difference wraps silently, as the reference's does."""
    t = (from_i32(a) + _const("bias", BIAS, a)) & U32
    return carry(to_i32((t - from_i32(b)) & U32))


def _reduce(c46: torch.Tensor) -> torch.Tensor:
    """(46, B) raw product rows -> normalized 22-limb element: three
    non-wrapping passes over the 46 rows, rows 44-45 folded into rows 22-23
    with FOLD, rows 22-43 into rows 0-21 with FOLD, then `carry`."""
    for _ in range(3):
        c46 = _carry_pass(c46, wrap=False)
    c46 = from_i32(c46)
    tail = c46[2 * NLIMB:]  # rows 44-45
    mid = c46[NLIMB:2 * NLIMB].clone()
    mid[: tail.shape[0]] = (mid[: tail.shape[0]] + ((FOLD * tail) & U32)) & U32
    folded = (c46[:NLIMB] + ((FOLD * mid) & U32)) & U32
    return carry(to_i32(folded))


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field product: the 22 x 22 convolution into 46 uint32 rows, then
    `_reduce`. Inputs normalized or one lazy add."""
    PRODUCTS.n += MUL_PRODUCTS
    a, b = from_i32(a), from_i32(b)
    c = torch.zeros((2 * NLIMB + 2,) + b.shape[1:], dtype=torch.int64, device=b.device)
    for i in range(NLIMB):
        c[i:i + NLIMB] = (c[i:i + NLIMB] + ((a[i] * b) & U32)) & U32
    return _reduce(c)


def sqr_plain(a: torch.Tensor) -> torch.Tensor:
    """Squaring: row 2i takes a_i^2, row i + j (j > i) takes (2 a_i) a_j
    — the reference's column sums — then `_reduce`."""
    PRODUCTS.n += SQR_PRODUCTS
    a = from_i32(a)
    a2 = (a + a) & U32
    c = torch.zeros((2 * NLIMB + 2,) + a.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(NLIMB):
        c[2 * i] = (c[2 * i] + ((a[i] * a[i]) & U32)) & U32
        if i + 1 < NLIMB:
            rows = slice(2 * i + 1, i + NLIMB)
            c[rows] = (c[rows] + ((a2[i] * a[i + 1:]) & U32)) & U32
    return _reduce(c)


def sqr_n_plain(a: torch.Tensor, n: int) -> torch.Tensor:
    a = to_i32(from_i32(a))
    for _ in range(n):
        a = sqr_plain(a)
    return a


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane select: mask (B,) bool -> a where True else b."""
    return torch.where(mask[None, :], a, b)


def _seq_carry(c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential carry through the 22 limbs: (limbs < 4096, carry out)."""
    rows = list(from_i32(c).unbind(0))
    cin = torch.zeros_like(rows[0])
    for i in range(NLIMB):
        t = (rows[i] + cin) & U32
        rows[i] = t & MASK
        cin = t >> BITS
    return to_i32(torch.stack(rows)), to_i32(cin)


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    t = to_i32((from_i32(x) + _const("p_complement", P_COMPLEMENT, x)) & U32)
    t, cout = _seq_carry(t)
    return select(from_i32(cout) >= 1, t, to_i32(from_i32(x)))


def _add_row0(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x with v (uint32) added to limb 0."""
    x = from_i32(x)
    x[0] = (x[0] + v) & U32
    return to_i32(x)


def canonical_plain(x: torch.Tensor) -> torch.Tensor:
    """Element anywhere in [0, 2^264) -> THE representative in [0, p): two
    sequential carries that fold their carry-out with FOLD, a third, two
    folds of the bits above 2^255 (bit 3 of limb 21) with 19, then two
    conditional subtractions of p."""
    x, cout = _seq_carry(x)
    x = _add_row0(x, (from_i32(cout) * FOLD) & U32)
    x, cout = _seq_carry(x)
    x = _add_row0(x, (from_i32(cout) * FOLD) & U32)
    x, _ = _seq_carry(x)  # limbs < 4096, value < 2^264
    for _ in range(2):
        x = from_i32(x)
        q = x[NLIMB - 1] >> 3  # value >> 255
        x[NLIMB - 1] = x[NLIMB - 1] & 7
        x[0] = (x[0] + ((q * 19) & U32)) & U32
        x, _ = _seq_carry(to_i32(x))
    x = _cond_sub_p(x)
    return _cond_sub_p(x)


def eq_canonical(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) bool equality of two canonical elements."""
    return (from_i32(a) == from_i32(b)).all(dim=0)


def kernel_partition() -> tuple[int, ...]:
    """K8's `F12_PART` table, read from `csrc/field12.cu`: warp g of a
    block owns the column pairs [part[g], part[g + 1]) of its lanes'
    products."""
    text = (_build.CSRC / "field12.cu").read_text()
    m = re.search(r"F12_PART\[\d+\]\s*=\s*\{([^}]*)\}", text)
    return tuple(int(v) for v in m.group(1).split(","))


def kernel_layout() -> dict:
    """K8's products as `csrc/field12.cu` splits them: threads a lane, the
    product rows of each (column pair k is rows k and 22 + k; the first
    thread also holds rows 44 and 45, which take only carries), and each
    thread's share of a squaring's and of a product's limb products."""
    part = kernel_partition()
    rows = [[*range(part[g], part[g + 1]), *range(NLIMB + part[g], NLIMB + part[g + 1])]
            + ([2 * NLIMB, 2 * NLIMB + 1] if g == 0 else []) for g in range(len(part) - 1)]
    mine = lambda rs, sq: sum(1 for i in range(NLIMB) for j in range(i if sq else 0, NLIMB) if i + j in rs)
    return dict(threads_per_lane=len(rows), lanes_per_block=32, rows=rows,
                sqr_products=[mine(rs, True) for rs in rows], mul_products=[mine(rs, False) for rs in rows])


# ---------------------------------------------------------------------------
# Kernel K8 wrappers
# ---------------------------------------------------------------------------


def _check(*ts: torch.Tensor) -> tuple[int, torch.device]:
    """Raise unless every tensor is a contiguous (NLIMB, B) int32 tensor on
    the first one's CUDA device; returns (B, device)."""
    batch, dev = ts[0].shape[-1], ts[0].device
    for t in ts:
        _build.check(t, (NLIMB, batch), torch.int32, dev)
    return batch, dev


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel K8 `hs_field12_mul` (replaces `field12.mul`, :137): CPU
    tensors -> `mul_plain`; CUDA tensors -> `csrc/field12.cu`."""
    if a.device.type == "cpu":
        return mul_plain(a, b)
    batch, dev = _check(a, b)
    out = torch.empty((NLIMB, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["field12_mul"].launch(a, b, out, batch)
    return out


def sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel K8 `hs_field12`, n squarings in one launch (replaces
    `field12.sqr_n`, :158, and the reference tool's chain of `sqr`, :147):
    CPU tensors -> `sqr_n_plain`; CUDA tensors -> `csrc/field12.cu`."""
    if a.device.type == "cpu":
        return sqr_n_plain(a, n)
    batch, dev = _check(a)
    out = torch.empty((NLIMB, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["field12"].launch(a, out, n, batch)
    return out


def sqr(a: torch.Tensor) -> torch.Tensor:
    return sqr_n(a, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel K8 `hs_field12_sub` (replaces `field12.sub`, :112): CPU
    tensors -> `sub_plain`; CUDA tensors -> `csrc/field12.cu`."""
    if a.device.type == "cpu":
        return sub_plain(a, b)
    batch, dev = _check(a, b)
    out = torch.empty((NLIMB, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["field12_sub"].launch(a, b, out, batch)
    return out


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Kernel K8 `hs_field12_canonical` (replaces `field12.canonical`,
    :184): CPU tensors -> `canonical_plain`; CUDA tensors ->
    `csrc/field12.cu`."""
    if x.device.type == "cpu":
        return canonical_plain(x)
    batch, dev = _check(x)
    out = torch.empty((NLIMB, batch), dtype=torch.int32, device=dev)
    _build.KERNELS["field12_canonical"].launch(x, out, batch)
    return out
