"""Bucketed, chunked dispatcher for batched ed25519 verification.

Counterpart of `Ed25519TpuVerifier` (`hotstuff_tpu/ops/ed25519.py:876-1248`).
Generic path: batches are split at `chunk`,
each chunk is padded to a power-of-two lane width between `min_bucket` and
`max_bucket`, shipped as a (128, W) uint8 wire array and verified by the
four kernels (`ladder.verify_packed128(_dh)`); the host s < L mask is ANDed
into the device mask.

Committee path (`set_committee`, `verify_batch_mask_committee`): lanes
carry validator indices into a device-resident `CommitteeTable`; each chunk
ships a (96, W) uint8 wire array (R, S, h or M — no key row) and a (W,)
int32 index vector, verified by K2g, K5 and K4 (`committee.verify_committee96
(_dh)`). Padding lanes carry index 0; their mask bits are dropped.

When every message is a 32-byte digest (the protocol's hot path) h is
computed on the device (K2 / K2g); otherwise the host hashes (`hashlib`).
On the card a device-hash failure propagates: a kernel that fails to build
or launch is a fault, and its work never moves to the host. On the CPU,
where both hash forms run on the host, the verifier keeps the reference's
latch (`hotstuff_tpu/ops/ed25519.py:989-1008`, `:1164-1187`): a batch whose
device-hash run raises is logged, counted in `device_hash_fallbacks` and
redone with host hashing, and the device hash latches off only when that
retry succeeds; a retry that raises too propagates and leaves it on.

Chunks run one after another (upload, kernels, mask readback); overlapping
them with streams and pinned buffers is later work.
"""

from __future__ import annotations

import logging
import threading
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from . import committee as cm
from . import ed25519 as ed
from . import ladder

log = logging.getLogger(__name__)


def pad(a: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad the last (lane) axis of a staged array to `width` lanes."""
    out = np.zeros(a.shape[:-1] + (width,), a.dtype)
    out[..., : a.shape[-1]] = a
    return out


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
        self._committee: ed.CommitteeTable | None = None
        self._device_hash_ok = True
        self.device_hash_fallbacks = 0  # batches redone with host hashing (CPU only)
        # Callers on several threads (the sidecar's dispatches) share one
        # verifier; the fallback count is taken under this lock.
        self._latch_lock = threading.Lock()

    # -- committee-resident path ------------------------------------------

    @property
    def committee(self) -> ed.CommitteeTable | None:
        return self._committee

    def set_committee(self, keys: Sequence[bytes]) -> ed.CommitteeTable:
        """Install the device-resident committee table. An identical key
        sequence returns the same table object; a changed one builds a new
        table and replaces the old (the reconfiguration contract)."""
        keys = [bytes(k) for k in keys]
        if self._committee is None or self._committee.keys != keys:
            self._committee = ed.CommitteeTable(keys, self.device)
        return self._committee

    def verify_batch_mask_committee(
        self,
        messages: Sequence[bytes],
        indices: Sequence[int],
        signatures: Sequence[bytes],
        table: ed.CommitteeTable | None = None,
    ) -> np.ndarray:
        """Lanes carry validator INDICES into the registered table. `table`
        pins the table the indices were resolved against, so a
        re-registration cannot swap it under a batch in flight; it defaults
        to the registered one."""
        ct = table or self._committee
        if ct is None:
            raise RuntimeError("no committee registered (call set_committee first)")
        indices = list(indices)

        def run(device_hash: bool) -> np.ndarray:
            verify = cm.verify_committee96_dh if device_hash else cm.verify_committee96

            def stage(lo: int, hi: int) -> dict:
                if device_hash:
                    return ed.prepare_batch_committee_dh(messages[lo:hi], indices[lo:hi], signatures[lo:hi])
                return ed.prepare_batch_committee(
                    messages[lo:hi], [ct.keys[i] for i in indices[lo:hi]], indices[lo:hi], signatures[lo:hi]
                )

            return self._run_chunks(len(messages), stage, ("packed", "idx"), lambda p, i: verify(ct, i, p))

        return self._with_latch(messages, run)

    # -- generic path -----------------------------------------------------

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[bytes],
        signatures: Sequence[bytes],
    ) -> np.ndarray:
        def run(device_hash: bool) -> np.ndarray:
            prepare = ed.prepare_batch_packed_dh if device_hash else ed.prepare_batch_packed
            verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128
            stage = lambda lo, hi: prepare(messages[lo:hi], keys[lo:hi], signatures[lo:hi])
            return self._run_chunks(len(messages), stage, ("packed",), verify)

        return self._with_latch(messages, run)

    # -- the chunk loop both paths share ------------------------------------

    def _with_latch(self, messages: Sequence[bytes], run) -> np.ndarray:
        """`run(device_hash)` with the device hash when every message is a
        32-byte digest and the latch is on. On the CPU, a failure there gets
        one retry with host hashing, and the latch goes off only if it
        succeeds; on the card the failure propagates."""
        device_hash = self._device_hash_ok and all(len(m) == 32 for m in messages)
        if not device_hash or self.device.type == "cuda":
            return run(device_hash)
        try:
            return run(device_hash)
        except Exception:
            log.exception("device-hash verification failed; retrying with host hashing")
            with self._latch_lock:
                self.device_hash_fallbacks += 1
            out = run(False)
            self._device_hash_ok = False
            return out

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.max_bucket)

    def _run_chunks(self, n: int, stage, wire: tuple[str, ...], verify) -> np.ndarray:
        """Verify lanes [0, n) one chunk after another: `stage(lo, hi)` gives
        the chunk's staged host arrays; the `wire` ones are padded to the
        chunk's bucket width, uploaded and passed to `verify`, whose (W,)
        device mask is read back and ANDed with the host s < L mask."""
        out = np.empty(n, bool)
        for lo in range(0, n, self.chunk):
            hi = min(lo + self.chunk, n)
            staged = stage(lo, hi)
            width = self._bucket(hi - lo)
            tensors = [torch.from_numpy(pad(staged[k], width)).to(self.device) for k in wire]
            out[lo:hi] = verify(*tensors).cpu().numpy()[: hi - lo] & staged["s_ok"]
        return out
