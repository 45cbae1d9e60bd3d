"""Bucketed, chunked dispatcher for generic batched ed25519 verification.

Counterpart of `Ed25519TpuVerifier`'s generic path
(`hotstuff_tpu/ops/ed25519.py:1119-1248`): batches are split at `chunk`,
each chunk is padded to a power-of-two lane width between `min_bucket` and
`max_bucket`, shipped as a (128, W) uint8 wire array and verified by the
four kernels (`ladder.verify_packed128(_dh)`); the host s < L mask is ANDed
into the device mask.

When every message is a 32-byte digest (the protocol's hot path) h is
computed on the device (K2); otherwise the host hashes (`hashlib`). A
device-hash failure raises: this slice has no failure latch.

Chunks run one after another (upload, kernels, mask readback); overlapping
them with streams and pinned buffers is later work.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from . import ed25519 as ed
from . import ladder


class Ed25519TorchVerifier:
    def __init__(
        self,
        device: str | torch.device | None = None,
        min_bucket: int = 128,
        max_bucket: int = 8192,
        chunk: int | None = None,
    ):
        self.device = resolve_device(device)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.chunk = min(chunk or 4096, max_bucket)

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_bucket)

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[bytes],
        signatures: Sequence[bytes],
    ) -> np.ndarray:
        n = len(messages)
        out = np.empty(n, bool)
        if n == 0:
            return out
        device_hash = all(len(m) == 32 for m in messages)
        stage = ed.prepare_batch_packed_dh if device_hash else ed.prepare_batch_packed
        verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
        for lo in range(0, n, self.chunk):
            hi = min(lo + self.chunk, n)
            staged = stage(messages[lo:hi], keys[lo:hi], signatures[lo:hi])
            width = self._bucket(hi - lo)
            packed = np.zeros((128, width), np.uint8)
            packed[:, : hi - lo] = staged["packed"]
            mask = verify(torch.from_numpy(packed).to(self.device))
            out[lo:hi] = mask.cpu().numpy()[: hi - lo] & staged["s_ok"]
        return out
