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

Batches smaller than the crossover are verified on the host, as the
reference sends small batches to the host CPU (`tpu_backend.py:276-316`).
That is a size rule, not a device fallback: every route gives the same
mask, and `stats` counts the host's lanes. The host verifier is chosen
once (`host`, see `backend.host_backend`): OpenSSL (`CpuBackend`, the
reference's host path) where `cryptography` imports, else the exact-integer
`HostBackend`; `host_route` says which ("openssl" or "exact").

A batch tagged `committee=True` that resolves against the registered table
is held to `committee_crossover`, any other batch to `crossover`; committee
routing is resolved before the size test, as in the reference
(`tpu_backend.py:289-296`). `crossover=None` means the measured default of
the route in use (`DEFAULT_CROSSOVERS`): on the OpenSSL route the least
batch size from which the card beat OpenSSL at every larger size in
`chip_smoke.py`'s crossover sweep, on each path; on the exact route 1,
since the card beat `HostBackend` from one signature on both paths.
`committee_crossover=None` means the route's measured committee default
when `crossover` is None too, else the reference's `crossover // 4` (at
least 1). Then, on a sharded verifier, it is floored at `mesh_alignment //
8` (`tpu_backend.py:110-124`): a quorum narrower than the mesh's bucket
pads to a whole mesh bucket, and the card pays for every padded lane. An
explicit `committee_crossover` is taken as given. Routing never changes a
verdict, only where it is computed.

The routing is mirrored into the port's metrics registry under the
reference's names (`crypto.tpu_batches` and `crypto.tpu_sigs` count the
card's batches, `crypto.cpu_*` the host's; `crypto.batch_size`,
`verifier.crossover_fallbacks`, `verifier.committee_misses`,
`verifier.rejected_sigs`, `verifier.committee_rejected_sigs`), so a dump of
either package reads the same; the first, tenth, hundredth, ... fallback
and miss are logged. Each route's verification is also a `metrics.span`:
`backend.generic_s` and `backend.committee_s` on the card, each around the
verifier's `verifier.e2e_s` and the lists the seam builds for it and from
its mask, and `backend.host_s` around the host verifier's call.

The verifier's dispatch pipeline runs at `HOTSTUFF_PIPELINE_DEPTH` chunks in
flight (default 2; 1 runs every chunk inline on the caller's thread);
`close()` drains its worker threads. `staging` picks the verifier's host
staging (`Ed25519TorchVerifier`): the native plane by default, numpy only
when asked for.

`sharded=True` splits every batch over every visible GPU, and `mesh=` over
the devices of a `parallel.DeviceMesh` (`tpu_backend.py:74-86`): the
verifier is then `ShardedEd25519TorchVerifier`, buckets are multiples of its
`mesh_alignment`, and a registered committee has a table replica per device.
The mesh may span processes (`mesh=parallel.init_multihost()`, as the
reference's `make_backend("tpu", mesh=init_multihost())`): then every
process must call the backend with the same batches in the same order
(SPMD), since each batch that reaches the card ends in a gather across the
processes; the routing (crossovers, committee resolution) depends on the
batch alone, so every process routes a batch alike.
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
from ..utils import metrics
from .backend import CryptoBackend, host_backend, host_route
from .primitives import PublicKey, Signature

log = logging.getLogger("hotstuff.crypto")

# The defaults of `crossover` and `committee_crossover` on each host route:
# the least batch size of `chip_smoke.py`'s crossover sweep (1, 2, 4, 8, 16,
# 32, 43, 64 signatures) from which the card beat the route's host verifier
# at every larger size of the sweep, on the generic and the committee path.
# Six sweeps in two runs of three (`phase_crossover`) on one NVIDIA H100
# 80GB HBM3 at a power limit of 700.00 W: OpenSSL's break-even read 8 in
# three and 16 in three, on both paths alike (the card took 1.2-1.8 ms a
# batch at every size up to 64 signatures, OpenSSL 1.09-1.58 ms at 8 and
# 2.24-3.56 ms at 16), so the default is 16, where the card won every
# sweep; the exact verifier lost to the card from one signature on both
# paths (3.0-4.0 ms for one signature).
CROSSOVER_OPENSSL = 16
COMMITTEE_CROSSOVER_OPENSSL = 16
DEFAULT_CROSSOVERS = {"openssl": (CROSSOVER_OPENSSL, COMMITTEE_CROSSOVER_OPENSSL), "exact": (1, 1)}

# The reference's routing metrics (`tpu_backend.py:31-47`): the card's
# batches count as `tpu_*`, the host's as `cpu_*`.
_M_TPU_BATCHES = metrics.counter("crypto.tpu_batches")
_M_TPU_SIGS = metrics.counter("crypto.tpu_sigs")
_M_CPU_BATCHES = metrics.counter("crypto.cpu_batches")
_M_CPU_SIGS = metrics.counter("crypto.cpu_sigs")
_M_BATCH_SIZE = metrics.histogram("crypto.batch_size", metrics.SIZE_BUCKETS)
_M_CROSSOVER_FALLBACKS = metrics.counter("verifier.crossover_fallbacks")
_M_COMMITTEE_MISSES = metrics.counter("verifier.committee_misses")
_M_REJECTED = metrics.counter("verifier.rejected_sigs")
_M_COMMITTEE_REJECTED = metrics.counter("verifier.committee_rejected_sigs")
# Each route's verification, a span around the host verifier's call or, on
# the card, around the verifier's `verifier.e2e_s` with the seam's own host
# work: the lists handed to the verifier, and the mask's `.tolist()`.
_M_GENERIC_S = metrics.histogram("backend.generic_s")
_M_COMMITTEE_S = metrics.histogram("backend.committee_s")
_M_HOST_S = metrics.histogram("backend.host_s")


def _is_decade(count: int) -> bool:
    """True on the 1st, 10th, 100th, ... occurrence: the log throttle of
    the fallback and miss lines."""
    return count >= 1 and count == 10 ** (len(str(count)) - 1)


class TorchBackend(CryptoBackend):
    name = "torch"
    # BatchVerificationService probes this to tag committee flushes.
    supports_committee_routing = True

    def __init__(
        self,
        crossover: int | None = None,
        max_bucket: int = 8192,
        min_bucket: int = 128,
        chunk: int | None = None,
        device: str | torch.device | None = None,
        sharded: bool = False,
        mesh: DeviceMesh | None = None,
        staging: str = "native",
        committee_crossover: int | None = None,
        host: str | None = None,
    ):
        kw = dict(min_bucket=min_bucket, max_bucket=max_bucket, chunk=chunk, staging=staging)
        if sharded or mesh is not None:
            if device is not None:
                raise ValueError("a sharded backend takes its devices from its mesh, not device=")
            self._verifier = ShardedEd25519TorchVerifier(mesh=mesh or default_mesh(), **kw)
            log.info("batches split over %s", self._verifier.mesh)
        else:
            self._verifier = Ed25519TorchVerifier(device=device, **kw)
        self._host = host_backend(host)
        self.host_route = host_route(self._host)
        generic, committee = DEFAULT_CROSSOVERS[self.host_route]
        self.crossover = generic if crossover is None else crossover
        if committee_crossover is not None:
            self.committee_crossover = committee_crossover
        else:
            self.committee_crossover = committee if crossover is None else max(1, crossover // 4)
            align = getattr(self._verifier, "mesh_alignment", 0)
            if align:
                self.committee_crossover = max(self.committee_crossover, align // 8)
        log.info("batches under %d (committee batches under %d) verify on the host (%s)",
                 self.crossover, self.committee_crossover, self.host_route)
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
        _M_BATCH_SIZE.record(n)
        resolved = self._resolve_committee(keys) if committee else None
        threshold = self.crossover if resolved is None else self.committee_crossover
        if n < threshold:
            with self._lock:
                self.stats["host_batches"] += 1
                self.stats["host_sigs"] += n
            _M_CPU_BATCHES.inc()
            _M_CPU_SIGS.inc(n)
            _M_CROSSOVER_FALLBACKS.inc()
            count = _M_CROSSOVER_FALLBACKS.value
            if _is_decade(count):
                log.info("sub-crossover fallback #%d: batch of %d < crossover %d verified on the host (%s)",
                         count, n, threshold, self.host_route)
            with metrics.span(_M_HOST_S):
                mask = self._host.verify_batch_mask(messages, keys, signatures)
            _count_rejections(mask, resolved is not None)
            return mask
        with self._lock:
            self.stats["device_batches"] += 1
            self.stats["device_sigs"] += n
            if resolved is not None:
                self.stats["committee_batches"] += 1
                self.stats["committee_sigs"] += n
        _M_TPU_BATCHES.inc()
        _M_TPU_SIGS.inc(n)
        if resolved is not None:
            indices, table = resolved
            # `table` is pinned through the dispatch: a re-registration
            # cannot swap it under these indices.
            with metrics.span(_M_COMMITTEE_S):
                mask = self._verifier.verify_batch_mask_committee(
                    list(messages), indices, [s.data for s in signatures], table=table
                ).tolist()
        else:
            with metrics.span(_M_GENERIC_S):
                mask = self._verifier.verify_batch_mask(
                    list(messages), [k.data for k in keys], [s.data for s in signatures]
                ).tolist()
        _count_rejections(mask, resolved is not None)
        return mask

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
            _M_COMMITTEE_MISSES.inc()
            count = _M_COMMITTEE_MISSES.value
            if _is_decade(count):
                log.info("committee miss #%d: tagged batch of %d holds unregistered key(s); it takes the "
                         "generic kernels (re-register after reconfiguration?)", count, len(keys))
            return None


def _count_rejections(mask: Sequence[bool], committee: bool) -> None:
    bad = mask.count(False)
    if bad:
        _M_REJECTED.inc(bad)
        if committee:
            _M_COMMITTEE_REJECTED.inc(bad)
