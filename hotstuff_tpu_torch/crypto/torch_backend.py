"""TorchBackend: batched ed25519 verification on the card behind the
`CryptoBackend` seam.

Counterpart of `hotstuff_tpu/crypto/tpu_backend.py` (generic path). It
carries the reference's `Signature::verify_batch` (QC checks) and the
fork's `verify_batch_alt` (the mempool batch workload) to the CUDA kernels
of `ops/` through `Ed25519TorchVerifier`.

Batches smaller than `crossover` are verified on the host (`HostBackend`),
as the reference sends them to the host CPU: the card wins only past a
crossover size. That is a size rule, not a device fallback, and `stats`
counts those lanes. There is no committee-resident path yet
(`supports_committee_routing = False`): `register_committee` logs and
returns 0, and every batch takes the generic kernels.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Sequence

import numpy as np
import torch

from ..ops import _build
from ..ops.verifier import Ed25519TorchVerifier
from .backend import CryptoBackend, HostBackend
from .primitives import PublicKey, Signature

log = logging.getLogger("hotstuff.crypto")


class TorchBackend(CryptoBackend):
    name = "torch"
    supports_committee_routing = False

    def __init__(
        self,
        crossover: int = 64,
        max_bucket: int = 8192,
        min_bucket: int = 128,
        chunk: int | None = None,
        device: str | torch.device | None = None,
    ):
        self._verifier = Ed25519TorchVerifier(
            device=device, min_bucket=min_bucket, max_bucket=max_bucket, chunk=chunk
        )
        self._host = HostBackend()
        self.crossover = crossover
        self._lock = threading.Lock()
        self.stats = {"device_batches": 0, "device_sigs": 0, "host_batches": 0, "host_sigs": 0}

    @property
    def device(self) -> torch.device:
        return self._verifier.device

    @property
    def bucket_alignment(self) -> int:
        """The narrowest bucket width: the batch scheduler sizes bulk
        buckets against it so a closed bucket pads no lanes."""
        return self._verifier.min_bucket

    def register_committee(self, keys: Sequence[PublicKey | bytes], warmup: bool = False) -> int:
        log.warning("committee registration skipped: %s has no committee path", type(self).__name__)
        return 0

    def warmup(self) -> float:
        """Build the CUDA kernels (on the card) and run one batch at every
        bucket width the dispatcher uses, on both wire formats, before the
        node needs them. Inputs are seeded junk; masks are discarded.
        Returns wall seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all()
        v = self._verifier
        rng = np.random.default_rng(0)
        widths = []
        w = v.min_bucket
        while w < v.chunk:
            widths.append(w)
            w *= 2
        widths.append(v.chunk)
        for n in widths:
            junk = [bytes(row) for row in rng.integers(0, 256, (n, 128), np.uint8)]
            v.verify_batch_mask([j[:32] for j in junk], [j[32:64] for j in junk], [j[64:] for j in junk])
        v.verify_batch_mask([b"\x00" * 33], [bytes(32)], [bytes(64)])
        secs = time.perf_counter() - t0
        log.info("torch verifier warmup: widths %s in %.1f s", widths, secs)
        return secs

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
        committee: bool = False,
    ) -> list[bool]:
        """`committee` is accepted for the seam's signature; every batch
        takes the generic path in this backend."""
        n = len(messages)
        if n == 0:
            return []
        if n < self.crossover:
            with self._lock:
                self.stats["host_batches"] += 1
                self.stats["host_sigs"] += n
            return self._host.verify_batch_mask(messages, keys, signatures)
        with self._lock:
            self.stats["device_batches"] += 1
            self.stats["device_sigs"] += n
        return self._verifier.verify_batch_mask(
            list(messages), [k.data for k in keys], [s.data for s in signatures]
        ).tolist()
