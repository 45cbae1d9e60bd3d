"""TorchBackend: batched ed25519 verification on the card behind the
`CryptoBackend` seam.

Counterpart of `hotstuff_tpu/crypto/tpu_backend.py`. It carries the
reference's `Signature::verify_batch` (QC checks) and the fork's
`verify_batch_alt` (the mempool batch workload) to the CUDA kernels of
`ops/` through `Ed25519TorchVerifier`.

Committee routing (`supports_committee_routing = True`): after
`register_committee(keys)`, a batch tagged `committee=True` whose keys all
resolve against the registered table takes the committee path (validator
indices, device-resident tables: kernels K2g, K5, K4). A tagged batch with
any unregistered key takes the generic path and counts in
`stats["committee_misses"]`; without a registration the tag is ignored.
Correctness never depends on the tag.

Batches smaller than `crossover` are verified on the host (`HostBackend`,
exact integers with the card's verdicts), as the reference sends small
batches to the host CPU. That is a size rule, not a device fallback: both
sides give the same mask, and `stats` counts the host's lanes. The default, 1,
sends every batch to the card: on one H100 80GB HBM3 (700 W) the card
verified a single signature faster than the port's host verifier, on the
committee path and on the generic path alike, so one crossover serves both
(`chip_smoke.py`'s crossover sweep; numbers in PERF.md).

The verifier's dispatch pipeline runs at `HOTSTUFF_PIPELINE_DEPTH` chunks in
flight (default 2; 1 runs every chunk inline on the caller's thread);
`close()` drains its worker threads. `staging` picks the verifier's host
staging (`Ed25519TorchVerifier`): the native plane by default, numpy only
when asked for.

`sharded=True` splits every batch over every visible GPU, and `mesh=` over
the devices of a `parallel.DeviceMesh` (`tpu_backend.py:74-86`): the
verifier is then `ShardedEd25519TorchVerifier`, buckets are multiples of its
`mesh_alignment`, and a registered committee has a table replica per device.
Deliberate departure: the reference's mesh-aware committee crossover floor
(`tpu_backend.py:110-124`, `max(crossover // 4, mesh_alignment // 8)`) is
not carried over. Its host path is OpenSSL; this backend's is the
exact-integer verifier, far slower than the card even on a quorum padded
to a mesh bucket, and the floor would send every QC of a 4-device mesh to
it. The port has OpenSSL's route too now (`backend.CpuBackend`, which
`remote.RemoteBackend` takes below its crossover), so the floor can be
revisited. Routing never changes a verdict, only where it is computed.
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
from ..parallel.mesh import DeviceMesh, ShardedEd25519TorchVerifier, default_mesh
from .backend import CryptoBackend, HostBackend
from .primitives import PublicKey, Signature

log = logging.getLogger("hotstuff.crypto")


class TorchBackend(CryptoBackend):
    name = "torch"
    # BatchVerificationService probes this to tag committee flushes.
    supports_committee_routing = True

    def __init__(
        self,
        crossover: int = 1,
        max_bucket: int = 8192,
        min_bucket: int = 128,
        chunk: int | None = None,
        device: str | torch.device | None = None,
        sharded: bool = False,
        mesh: DeviceMesh | None = None,
        staging: str = "native",
    ):
        kw = dict(min_bucket=min_bucket, max_bucket=max_bucket, chunk=chunk, staging=staging)
        if sharded or mesh is not None:
            if device is not None:
                raise ValueError("a sharded backend takes its devices from its mesh, not device=")
            self._verifier = ShardedEd25519TorchVerifier(mesh=mesh or default_mesh(), **kw)
            log.info("batches split over %s", self._verifier.mesh)
        else:
            self._verifier = Ed25519TorchVerifier(device=device, **kw)
        self._host = HostBackend()
        self.crossover = crossover
        self._lock = threading.Lock()
        self.stats = {
            "device_batches": 0, "device_sigs": 0, "host_batches": 0, "host_sigs": 0,
            "committee_batches": 0, "committee_sigs": 0, "committee_misses": 0,
        }

    def close(self) -> None:
        """Drain the verifier's dispatch-pipeline workers
        (`ops/pipeline.py`). Optional: dropped backends are reaped by GC and
        at exit."""
        self._verifier.close()

    @property
    def device(self) -> torch.device:
        return self._verifier.device

    @property
    def bucket_alignment(self) -> int:
        """The bucket grid: the mesh's `mesh_alignment` on a sharded
        verifier, else the narrowest bucket width. The batch scheduler sizes
        bulk buckets against it so a closed bucket pads no lanes."""
        v = self._verifier
        return getattr(v, "mesh_alignment", 0) or v.min_bucket

    def register_committee(self, keys: Sequence[PublicKey | bytes], warmup: bool = False) -> int:
        """Install the committee keys as device-resident tables. Idempotent
        for an identical key sequence; a changed key set (reconfiguration)
        builds a new table. With `warmup`, runs the committee kernels at
        every width `warmup()` uses. Returns the committee size."""
        raw = [k.data if isinstance(k, PublicKey) else bytes(k) for k in keys]
        table = self._verifier.set_committee(raw)
        log.info("registered %d-key committee for device-resident verification", table.size)
        if warmup:
            self._warmup_committee()
        return table.size

    def _warmup_widths(self) -> list[int]:
        """Batch sizes that, run through the verifier, dispatch at every
        bucket width it uses, each once (`tpu_backend.py:175-205`): sizes
        doubling from `min_bucket` up to the chunk, then the chunk, each
        mapped through the verifier's own `_bucket` and kept only when its
        width is new (mesh alignment can land two sizes on one width)."""
        v = self._verifier
        sizes, w = [], v.min_bucket
        while w < v.chunk:
            sizes.append(w)
            w *= 2
        seen, out = set(), []
        for n in sizes + [v.chunk]:
            width = v._bucket(n)
            if width not in seen:
                seen.add(width)
                out.append(n)
        return out

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
        sizes = self._warmup_widths()
        for n in sizes:
            junk = [bytes(row) for row in rng.integers(0, 256, (n, 128), np.uint8)]
            v.verify_batch_mask([j[:32] for j in junk], [j[32:64] for j in junk], [j[64:] for j in junk])
        v.verify_batch_mask([b"\x00" * 33], [bytes(32)], [bytes(64)])
        secs = time.perf_counter() - t0
        log.info("torch verifier warmup: widths %s in %.1f s", [v._bucket(n) for n in sizes], secs)
        return secs

    def _warmup_committee(self) -> float:
        """`warmup()` for the committee kernels, against the registered
        table (validator 0 on every lane). Returns wall seconds."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.build_all()
        v = self._verifier
        rng = np.random.default_rng(1)
        sizes = self._warmup_widths()
        for n in sizes:
            junk = [bytes(row) for row in rng.integers(0, 256, (n, 96), np.uint8)]
            v.verify_batch_mask_committee([j[:32] for j in junk], [0] * n, [j[32:] for j in junk])
        v.verify_batch_mask_committee([b"\x00" * 33], [0], [bytes(64)])
        secs = time.perf_counter() - t0
        log.info("torch committee warmup: widths %s in %.1f s", [v._bucket(n) for n in sizes], secs)
        return secs

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[PublicKey],
        signatures: Sequence[Signature],
        committee: bool = False,
    ) -> list[bool]:
        """`committee=True` marks consensus traffic signed by registered
        validator keys: its indices are resolved against the registered
        table and the batch takes the committee kernels. A batch with any
        unregistered key (or no registration) takes the generic path."""
        n = len(messages)
        if n == 0:
            return []
        resolved = self._resolve_committee(keys) if committee else None
        if n < self.crossover:
            with self._lock:
                self.stats["host_batches"] += 1
                self.stats["host_sigs"] += n
            return self._host.verify_batch_mask(messages, keys, signatures)
        with self._lock:
            self.stats["device_batches"] += 1
            self.stats["device_sigs"] += n
            if resolved is not None:
                self.stats["committee_batches"] += 1
                self.stats["committee_sigs"] += n
        if resolved is not None:
            indices, table = resolved
            # `table` is pinned through the dispatch: a re-registration
            # cannot swap it under these indices.
            return self._verifier.verify_batch_mask_committee(
                list(messages), indices, [s.data for s in signatures], table=table
            ).tolist()
        return self._verifier.verify_batch_mask(
            list(messages), [k.data for k in keys], [s.data for s in signatures]
        ).tolist()

    def _resolve_committee(self, keys: Sequence[PublicKey]):
        """Validator indices of `keys` against ONE snapshot of the registered
        table -> (indices, table), or None (no registration, or a key
        outside the registered set: counted in `committee_misses`)."""
        table = self._verifier.committee
        if table is None:
            return None
        try:
            return [table.index[k.data] for k in keys], table
        except KeyError:
            with self._lock:
                self.stats["committee_misses"] += 1
            return None
