"""PyTorch/CUDA port of the hotstuff_tpu accelerator path.

The JAX package (`hotstuff_tpu`) runs batched ed25519 verification on a TPU;
this package runs the same verification, and the BLS12-381 key sums of
aggregate certificates, on an NVIDIA Hopper card with CUDA kernels written
by hand (`ops/csrc/`), each held against a plain PyTorch version of the
same arithmetic, and carries its own copy of the HotStuff node around
them (`node/`, `consensus/`, `mempool/`, `network/`, `store/`). It imports neither jax nor any module of
`hotstuff_tpu`: what it needs from there it keeps as its own trimmed copy.

Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`), where every kernel wrapper takes its plain version. There
is no silent fallback: asking for the card on a host without one raises.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "kernels_built"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless `cpu` is asked for.
    A card is returned in indexed form (`cuda` is the current card,
    `cuda:0` on a fresh process), as a tensor's `device` reads, so devices
    compare equal to the tensors placed on them.

    Raises RuntimeError when the card is asked for (explicitly or by
    default) and `torch.cuda.is_available()` is False — callers that want
    the plain CPU path must say so — or when the index names no visible
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} asked for, {torch.cuda.device_count()} CUDA devices visible")
        return torch.device("cuda", index)
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (cuda or cpu)")


def kernels_built() -> bool:
    """True when every CUDA kernel of the current sources is already built
    (no build is started)."""
    from .ops import _build

    return _build.all_built()
