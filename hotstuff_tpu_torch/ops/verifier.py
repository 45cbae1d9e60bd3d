"""Bucketed, pipelined dispatcher for batched ed25519 verification.

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
computed on the device (K2 / K2g); otherwise the host hashes it while it
stages the chunk.

Staging (`staging=`) is the port's native plane by default, on the card
and on the CPU alike (`crypto/native_staging.py`, C++ through `ctypes`,
which releases the interpreter lock): one call per chunk writes the wire
rows straight into the chunk's pooled shard-major buffer and gives the
s < L mask. `staging="numpy"` runs the plain numpy staging of
`ops/ed25519.py` (`prepare_batch_*`) and copies its rows into that buffer;
nothing else reaches it. A native plane that does not build or load
raises when the verifier is made.
On the card a device-hash failure propagates: a kernel that fails to build
or launch is a fault, and its work never moves to the host. On the CPU,
where both hash forms run on the host, the verifier keeps the reference's
latch (`hotstuff_tpu/ops/ed25519.py:989-1008`, `:1164-1187`): a batch whose
device-hash run raises is logged, counted in `device_hash_fallbacks` and
redone with host hashing, and the device hash latches off only when that
retry succeeds; a retry that raises too propagates and leaves it on.

Both paths run their chunks through the verifier's own `DispatchPipeline`
(`ops/pipeline.py`, depth `pipeline_depth`, default 2): the caller thread
stages chunk N+1 into a pooled staging buffer while the upload worker
uploads and launches chunk N and the readback worker waits for chunk N-1's
mask. `pipeline_depth=1` runs every chunk inline on the caller thread.
On the card:
  * the staging buffers and the mask buffers are page-locked (the pool's
    `pin`), so the upload (`non_blocking`) and the mask's copy back are
    asynchronous;
  * the verifier owns two CUDA streams per shard (one shard here; one per
    mesh entry in the mesh verifier, `parallel/mesh.py`) and chunk k runs
    on stream k % 2 of each shard: its upload, its kernels, the torch ops
    between them and its mask's copy back are all issued inside
    `torch.cuda.stream(...)` on the thread that issues them (the current
    stream is per thread, and `Kernel.launch` launches on it), so chunk
    k+1's upload and kernels need not wait for chunk k's. The readback
    waits on the chunk's own `torch.cuda.Event`s, one per shard, never on
    the whole device;
  * the device constants (`field.const`) and a committee table's tensors
    (and its replicas, `CommitteeTable.to`) are made by blocking copies,
    which have landed before the copy returns, so kernels on any stream
    read them complete; a chunk's task holds its `CommitteeTable` until its
    readback, so a table replaced mid-batch cannot return to the allocator
    while a kernel still reads it.
A CUDA stream or pinned-memory failure raises; there is no pageable or
default-stream fallback.

Staging buffers are shard-major: a chunk's (rows, W) wire array is laid
out in a pooled (shards, rows, W / shards) buffer, so each shard uploads one
contiguous block, and shard s writes lanes [s W / shards, (s + 1) W /
shards) of the chunk's pooled mask buffer.

Kernel flavours (`kernel=`, as the reference's `:882-900`): "w4" (the
default), "pallas" and "bits". The packed paths above run K1 for every
flavour: the port's K1 stands in for both the jnp w4 ladder and the Pallas
ladder, and the reference's `_packed_fn` (`:1125-1130`) gives the packed w4
kernel to every flavour but "pallas", so `kernel="bits", packed=True` runs
K1 too. "pallas" keeps the reference's buckets: multiples of its 256-lane
Pallas block. `packed` defaults to `kernel != "bits"`.

`packed=False` is the f32-argument path (`:1154-1163`, `_run_chunk`
`:1273-1297`): the batch is split at `max_bucket` (not `chunk`) and each
piece runs serially on the caller's thread, outside the pipeline: staged
by `ed.prepare_batch` (the wire rows of `stage_packed_hh`, or of the numpy
staging, as separate uint8 arrays), padded to its bucket, uploaded and
verified by `ladder.verify_args` on the verifier's own streams (K3, then
K1 on digits or K7 `bit_ladder` on bits, then K4), read back and ANDed with
s < L. There is no device hash on this path.

The mesh verifier (`parallel/mesh.py`) splits each chunk over the devices
of a mesh through the hooks here (`shard_devices`, `local_shards`,
`_build_committee_table`, `_verify_args`, `_materialize`).

Deferred readback (`_defer_readback`, the reference's `:908-918`, `:1250-
1270`; on by itself on a mesh over several processes): each chunk's
readback returns the lanes of this process's shards, un-ANDed, and once
the pipeline's run has returned, on the calling thread, ONE
`_materialize_deferred` call turns every chunk's lanes into whole masks
(one gather a batch on a multi-process mesh; here the lanes are already
whole), which are then ANDed with s < L. The generic path, the committee
path and `packed=False` all take it. On one process it gives the same
masks, bit for bit, as the streamed readback.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..crypto import native_staging
from ..utils import metrics
from . import committee as cm
from . import ed25519 as ed
from . import ladder, timeline
from .pipeline import ChunkTask, DispatchPipeline

log = logging.getLogger(__name__)

# The reference verifier's metric names (`hotstuff_tpu/ops/ed25519.py:55-80`).
_M_STAGE = metrics.histogram("verifier.stage_s")
_M_UPLOAD = metrics.histogram("verifier.upload_s")
_M_DISPATCH = metrics.histogram("verifier.dispatch_s")
_M_READBACK = metrics.histogram("verifier.readback_s")
# One sample per non-empty batch of either path, the latch's retry inside
# `e2e_s` (the telemetry plane's verify.e2e SLO reads it).
_M_E2E = metrics.histogram("verifier.e2e_s")
_M_BATCH_SIZE = metrics.histogram("verifier.batch_size", metrics.SIZE_BUCKETS)
_M_SIGS = metrics.counter("verifier.sigs")
_M_BATCHES = metrics.counter("verifier.batches")
_M_CHUNKS = metrics.counter("verifier.chunks")
_M_PAD_LANES = metrics.counter("verifier.pad_lanes")
_M_DH_FALLBACKS = metrics.counter("verifier.device_hash_fallbacks")
# The generic kernels decompress every lane's key and build its -A table per
# chunk; the committee path reads precomputed tables and counts neither.
_M_DECOMPRESSIONS = metrics.counter("verifier.decompressions")
_M_TABLE_BUILDS = metrics.counter("verifier.table_builds")
_M_COMMITTEE_BATCHES = metrics.counter("verifier.committee_batches")
_M_COMMITTEE_SIGS = metrics.counter("verifier.committee_sigs")

STAGINGS = ("native", "numpy")
# Lanes of one program of the reference's Pallas grid
# (hotstuff_tpu/ops/pallas_ladder.py:36): `kernel="pallas"` keeps its
# buckets multiples of it, though K1 has no such block.
PALLAS_BLOCK = 256
# (path, device hash) -> (native entry, the numpy staging it stands for)
_STAGING = {
    ("generic", True): (native_staging.stage_packed_dh, ed.prepare_batch_packed_dh),
    ("generic", False): (native_staging.stage_packed_hh, ed.prepare_batch_packed),
    ("committee", True): (native_staging.stage_committee_dh, ed.prepare_batch_committee_dh),
    ("committee", False): (native_staging.stage_committee_hh, ed.prepare_batch_committee),
}


class Ed25519TorchVerifier:
    def __init__(
        self,
        device: str | torch.device | None = None,
        min_bucket: int = 128,
        max_bucket: int = 8192,
        chunk: int | None = None,
        pipeline_depth: int | None = None,
        staging: str = "native",
        kernel: str = "w4",
        packed: bool | None = None,
    ):
        self.device = resolve_device(device)
        if staging not in STAGINGS:
            raise ValueError(f"staging must be one of {STAGINGS}, got {staging!r}")
        if kernel not in ladder.KERNEL_FLAVOURS:
            raise ValueError(f"kernel must be one of {ladder.KERNEL_FLAVOURS}, got {kernel!r}")
        self.staging = staging
        if staging == "native":
            native_staging.load()
        self.kernel = kernel
        self.packed = packed if packed is not None else kernel != "bits"
        if kernel == "pallas":  # the reference's buckets tile its Pallas grid (:892-897)
            min_bucket = -(-max(min_bucket, PALLAS_BLOCK) // PALLAS_BLOCK) * PALLAS_BLOCK
            max_bucket = max(PALLAS_BLOCK, max_bucket // PALLAS_BLOCK * PALLAS_BLOCK)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.chunk = min(chunk or 4096, max_bucket)
        on_card = self.device.type == "cuda"
        # The owned dispatch pipeline; its worker threads start on the first
        # run at depth > 1, and close() (or GC, or atexit) reaps them.
        self.pipeline = DispatchPipeline(depth=pipeline_depth, name="ed25519-torch", pin=on_card)
        # Two streams per local shard; chunk k runs on stream k % 2 of each.
        self._streams = (
            [(torch.cuda.Stream(self.shard_devices[s]), torch.cuda.Stream(self.shard_devices[s]))
             for s in self.local_shards] if on_card else None
        )
        self._committee: ed.CommitteeTable | None = None
        # One gather a batch instead of a mask per chunk (module docstring).
        self._defer_readback = False
        self._device_hash_ok = True
        self.device_hash_fallbacks = 0  # batches redone with host hashing (CPU only)
        # Callers on several threads (the sidecar's dispatches) share one
        # verifier; the fallback count is taken under this lock.
        self._latch_lock = threading.Lock()

    @property
    def shard_devices(self) -> tuple[torch.device, ...]:
        """The device of each shard a chunk is split over, in lane order:
        this verifier's one device (the mesh verifier: its mesh's devices)."""
        return (self.device,)

    @property
    def local_shards(self) -> tuple[int, ...]:
        """The shards this process uploads, launches and reads back, as
        indices into `shard_devices`: every one (the mesh verifier on a mesh
        over several processes: this process's entries)."""
        return tuple(range(len(self.shard_devices)))

    def close(self) -> None:
        """Drain the owned pipeline's worker threads. Safe to call more than
        once; a closed verifier keeps working, every later batch inline."""
        self.pipeline.close()

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
            self._committee = self._build_committee_table(keys)
        return self._committee

    def _build_committee_table(self, keys: list[bytes]) -> ed.CommitteeTable:
        """Placement hook (the reference's, `hotstuff_tpu/ops/ed25519.py:954`):
        the mesh verifier overrides it to add a replica per device."""
        return ed.CommitteeTable(keys, self.device)

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
        n = len(messages)
        if n == 0:
            return np.empty(0, bool)
        _M_BATCHES.inc()
        _M_SIGS.inc(n)
        _M_BATCH_SIZE.record(n)
        _M_COMMITTEE_BATCHES.inc()
        _M_COMMITTEE_SIGS.inc(n)
        with metrics.span(_M_E2E):
            return self._verify_committee(ct, messages, list(indices), signatures)

    def _verify_committee(self, ct: ed.CommitteeTable, messages, indices: list[int], signatures) -> np.ndarray:
        n = len(messages)

        def run(device_hash: bool) -> np.ndarray:
            def stage(lo: int, hi: int, out: np.ndarray) -> dict:
                if device_hash:
                    args = (messages[lo:hi], indices[lo:hi], signatures[lo:hi])
                else:
                    keys = [ct.keys[i] for i in indices[lo:hi]]
                    args = (messages[lo:hi], keys, indices[lo:hi], signatures[lo:hi])
                return self.stage_wire("committee", device_hash, args, out)

            def dispatch(bufs, mask_buf, streams, tlkey):
                # `ct` stays pinned in this closure, which the chunk's task
                # holds until its readback.
                return self._upload_dispatch_committee(ct, device_hash, bufs, mask_buf, streams, tlkey)

            return self._run_chunks(n, 96, stage, dispatch)

        return self._with_latch(messages, run)

    # -- generic path -----------------------------------------------------

    def verify_batch_mask(
        self,
        messages: Sequence[bytes],
        keys: Sequence[bytes],
        signatures: Sequence[bytes],
    ) -> np.ndarray:
        n = len(messages)
        if n == 0:
            return np.empty(0, bool)
        _M_BATCHES.inc()
        _M_SIGS.inc(n)
        _M_BATCH_SIZE.record(n)
        with metrics.span(_M_E2E):
            return self._verify_generic(messages, keys, signatures)

    def _verify_generic(self, messages, keys, signatures) -> np.ndarray:
        n = len(messages)
        if not self.packed:
            out = np.empty(n, bool)
            spans = [(lo, min(lo + self.max_bucket, n)) for lo in range(0, n, self.max_bucket)]
            if not self._defer_readback:
                for lo, hi in spans:
                    out[lo:hi] = self._run_chunk(messages[lo:hi], keys[lo:hi], signatures[lo:hi])
                return out
            pieces = [self._verify_piece(messages[lo:hi], keys[lo:hi], signatures[lo:hi]) for lo, hi in spans]
            masks = self._materialize_deferred([p for p, _, _ in pieces], [w for _, _, w in pieces])
            for (lo, hi), (_, s_ok, _), mask in zip(spans, pieces, masks):
                out[lo:hi] = mask[: hi - lo] & s_ok
            return out

        def run(device_hash: bool) -> np.ndarray:
            verify = ladder.verify_packed128_dh if device_hash else ladder.verify_packed128

            def stage(lo: int, hi: int, out: np.ndarray) -> dict:
                _M_TABLE_BUILDS.inc()
                _M_DECOMPRESSIONS.inc(hi - lo)
                return self.stage_wire("generic", device_hash, (messages[lo:hi], keys[lo:hi], signatures[lo:hi]), out)

            def dispatch(bufs, mask_buf, streams, tlkey):
                return self._upload_dispatch(lambda dev, packed: verify(packed), bufs, mask_buf, streams, tlkey)

            return self._run_chunks(n, 128, stage, dispatch)

        return self._with_latch(messages, run)

    # -- the f32-argument path (packed=False) ---------------------------------

    def _run_chunk(self, messages, keys, signatures) -> np.ndarray:
        """One piece of at most `max_bucket` lanes on the f32-argument path
        (the reference's `_run_chunk`, :1273-1297), serially on the caller's
        thread: `_verify_piece`, then its lanes made whole (`_materialize`)
        and ANDed with s < L."""
        local, s_ok, width = self._verify_piece(messages, keys, signatures)
        return self._materialize([local], [width])[0][: len(messages)] & s_ok

    def _verify_piece(self, messages, keys, signatures) -> tuple[np.ndarray, np.ndarray, int]:
        """Stage one f32-path piece (`ed.prepare_batch`, bits for
        `kernel="bits"`), pad it to its bucket, upload and verify it
        (`_verify_args`) on the verifier's own streams and read this
        process's lanes of the mask back. Returns (those lanes, the piece's
        s < L mask, the bucket width). Counts one chunk, one table build and
        n decompressions, and records the timeline's stage, dispatch and
        readback spans (no upload span: the upload is part of the dispatch,
        as in the reference)."""
        n = len(messages)
        _M_CHUNKS.inc()
        _M_TABLE_BUILDS.inc()
        _M_DECOMPRESSIONS.inc(n)
        tlkey = (timeline.TIMELINE.next_batch(), 0, n) if timeline.enabled() else None
        with metrics.span(_M_STAGE), timeline.span_for("stage", tlkey):
            staged = ed.prepare_batch(messages, keys, signatures, want_bits=self.kernel == "bits",
                                      staging=self.staging)
        width = self._bucket(n)
        _M_PAD_LANES.inc(width - n)
        with self._own_streams():
            with timeline.span_for("dispatch", tlkey):
                mask = self._verify_args(ed.kernel_args(staged, width, self.kernel))
            with metrics.span(_M_READBACK), timeline.span_for("readback", tlkey):
                host = mask.cpu().numpy()
        return host, staged["s_ok"], width

    def _verify_args(self, args: tuple) -> torch.Tensor:
        """Upload the padded f32-form arrays to this verifier's device and
        run `ladder.verify_args`; the (W,) device mask (the mesh verifier
        splits the lanes over its mesh, `parallel/mesh.py`, and returns its
        own shards' lanes, in mesh order)."""
        tensors = [torch.from_numpy(a).to(self.device) for a in args]
        return ladder.verify_args(*tensors, kernel=self.kernel)

    def _own_streams(self) -> contextlib.ExitStack:
        """Make one of this verifier's own streams current on each distinct
        shard device: the f32 path's uploads, kernels and copies never run
        on a default stream. Nothing on the CPU."""
        stack = contextlib.ExitStack()
        if self._streams:
            local = [self.shard_devices[s] for s in self.local_shards]
            for pair in dict(zip(local, self._streams)).values():
                stack.enter_context(torch.cuda.stream(pair[0]))
        return stack

    # -- deferred readback ---------------------------------------------------

    def _local_lanes(self, mask_buf: np.ndarray) -> np.ndarray:
        """A fresh copy of this process's shards' lanes of a chunk's pooled
        (W,) mask buffer, in mesh order (every lane on one process)."""
        shards, local = len(self.shard_devices), self.local_shards
        if len(local) == shards:
            return mask_buf.copy()
        w = mask_buf.shape[0] // shards
        return np.concatenate([mask_buf[s * w : (s + 1) * w] for s in local])

    def _materialize(self, pieces: list[np.ndarray], widths: list[int]) -> list[np.ndarray]:
        """Each chunk's lanes of this process (`pieces`, at bucket widths
        `widths`) -> each chunk's whole (W,) mask. On one process the lanes
        are whole already; the mesh verifier gathers them from every process
        of its mesh, once for all the chunks given."""
        return pieces

    def _materialize_deferred(self, pieces: list[np.ndarray], widths: list[int]) -> list[np.ndarray]:
        """The deferred readback's tail (the reference's `:1254-1270`): ONE
        `_materialize` over every chunk of the batch, on the calling thread,
        after the pipeline's run has returned."""
        with metrics.span(_M_READBACK):
            return self._materialize(pieces, widths)

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
            _M_DH_FALLBACKS.inc()
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

    def stage_wire(self, path: str, device_hash: bool, args: tuple, out: np.ndarray) -> dict:
        """Stage one chunk into `out`, a pooled shard-major (shards, rows,
        W / shards) uint8 buffer, with this verifier's staging. `args` are
        the numpy staging function's arguments (`ops/ed25519.py`
        `prepare_batch_packed(_dh)` on the generic path,
        `prepare_batch_committee(_dh)` on the committee path). The native
        entry writes into `out`; the numpy function stages on its own and
        `fill_shards` copies its rows in. Returns the staged dict with
        `packed` = `out`, `s_ok` and, on the committee path, `idx`."""
        native, plain = _STAGING[(path, device_hash)]
        shards, _, w = out.shape
        if self.staging == "native":
            return native(*args, out, shards * w, shards)
        staged = plain(*args)
        fill_shards(out, staged["packed"])
        return dict(staged, packed=out)

    def _run_chunks(self, n: int, rows: int, stage, dispatch) -> np.ndarray:
        """Verify lanes [0, n) chunk by chunk through the pipeline.
        `stage(lo, hi, out)` stages the chunk's `rows` wire rows into `out`,
        a pooled shard-major buffer of the chunk's bucket width, and returns
        the staged dict (`stage_wire`); a committee chunk's `idx` is padded
        into a pooled buffer of its own. `dispatch(bufs, mask_buf, streams,
        tlkey)` uploads the buffers, launches the kernels and queues the (W,)
        mask's copy into `mask_buf`, returning the events to wait on (none on
        the CPU). The readback ANDs the mask with the host s < L mask."""
        pool = self.pipeline.pool
        tl_on = timeline.enabled()
        tl_batch = timeline.TIMELINE.next_batch() if tl_on else 0
        streams = self._streams
        shards = len(self.shard_devices)
        defer = self._defer_readback

        def make_task(ci: int, lo: int, hi: int) -> ChunkTask:
            tlkey = (tl_batch, ci, hi - lo) if tl_on else None
            release: list = []

            def stage_chunk():
                _M_CHUNKS.inc()
                width = self._bucket(hi - lo)
                _M_PAD_LANES.inc(width - (hi - lo))
                packed = pool.take((shards, rows, width // shards), np.uint8)
                release.append(packed)
                with metrics.span(_M_STAGE):
                    staged = stage(lo, hi, packed)
                bufs = [packed]
                if "idx" in staged:
                    bufs.append(pad_shards(pool, staged["idx"], width, shards))
                    release.append(bufs[-1])
                mask_buf = pool.take((width,), np.bool_)
                release.append(mask_buf)
                return bufs, mask_buf, staged["s_ok"]

            def submit(payload):
                bufs, mask_buf, s_ok = payload
                chunk_streams = [pair[ci % 2] for pair in streams] if streams else [None] * len(self.local_shards)
                return dispatch(bufs, mask_buf, chunk_streams, tlkey), mask_buf, s_ok

            def readback(handle):
                events, mask_buf, s_ok = handle
                with metrics.span(_M_READBACK):
                    for event in events:
                        event.synchronize()
                    # Fresh arrays: mask_buf goes back to the pool next.
                    if defer:
                        return self._local_lanes(mask_buf), s_ok
                    return mask_buf[: hi - lo] & s_ok

            return ChunkTask(stage=stage_chunk, submit=submit, readback=readback, tlkey=tlkey, release=release)

        spans = [(lo, min(lo + self.chunk, n)) for lo in range(0, n, self.chunk)]
        results = self.pipeline.run([make_task(ci, lo, hi) for ci, (lo, hi) in enumerate(spans)])
        if not defer:
            return np.concatenate(results)
        masks = self._materialize_deferred([p for p, _ in results], [self._bucket(hi - lo) for lo, hi in spans])
        return np.concatenate([m[: hi - lo] & ok for (lo, hi), (_, ok), m in zip(spans, results, masks)])

    def _upload_dispatch(self, verify, bufs, mask_buf, streams, tlkey):
        """Upload-worker leg of a chunk (the seam of the reference's
        `_upload_dispatch`): upload each local shard's block of the pooled
        shard-major wire buffers to its device, launch `verify(device,
        *tensors)` there and queue the shard's mask's copy into its slice of
        the pooled `mask_buf`, all on the shard's stream (None on the CPU;
        `streams` follows `local_shards`). Every shard's upload is issued
        before any shard's kernels. Returns the events recorded after each
        shard's copy: none on the CPU, where everything has run by the time
        this returns."""
        local = self.local_shards
        devices = [self.shard_devices[s] for s in local]
        width = mask_buf.shape[0] // len(self.shard_devices)
        with metrics.span(_M_UPLOAD), timeline.span_for("upload", tlkey):
            uploads = []
            for s, dev, stream in zip(local, devices, streams):
                with _on(stream):
                    uploads.append([torch.from_numpy(b[s]).to(dev, non_blocking=True) for b in bufs])
        with metrics.span(_M_DISPATCH), timeline.span_for("dispatch", tlkey):
            events = []
            for s, dev, stream, tensors in zip(local, devices, streams, uploads):
                with _on(stream):
                    mask = verify(dev, *tensors)
                    torch.from_numpy(mask_buf[s * width : (s + 1) * width]).copy_(mask, non_blocking=True)
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                        events.append(event)
            return events

    def _upload_dispatch_committee(self, ct, device_hash: bool, bufs, mask_buf, streams, tlkey):
        """The committee path's upload-worker leg (the reference's
        `_upload_dispatch_committee`): as `_upload_dispatch`, each shard
        against the replica on its device of `ct` (pinned by the caller,
        never re-read from self), with the (96, W) wire rows and the (W,)
        indices."""
        verify = cm.verify_committee96_dh if device_hash else cm.verify_committee96
        return self._upload_dispatch(
            lambda dev, packed, idx: verify(ct.replicas[dev], idx, packed), bufs, mask_buf, streams, tlkey
        )


def _on(stream):
    """`torch.cuda.stream(stream)`, or nothing for the CPU's None."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def pad_shards(pool, arr: np.ndarray, width: int, shards: int) -> np.ndarray:
    """`arr` (..., n) zero-padded to `width` lanes and split on lanes into
    `shards` equal blocks, in a pooled shard-major (shards, ..., width /
    shards) buffer: block s holds lanes [s w, (s + 1) w). Always copies,
    as `StagingBufferPool.pad`."""
    out = pool.take((shards, *arr.shape[:-1], width // shards), arr.dtype)
    fill_shards(out, arr)
    return out


def fill_shards(out: np.ndarray, arr: np.ndarray) -> None:
    """Write `arr` (..., n) into the shard-major (shards, ..., w) buffer
    `out`: block s takes lanes [s w, (s + 1) w), lanes past n are zeroed."""
    shards, w = out.shape[0], out.shape[-1]
    n = arr.shape[-1]
    for s in range(shards):
        lo = s * w
        k = max(0, min(w, n - lo))
        out[s, ..., :k] = arr[..., lo : lo + k]
        out[s, ..., k:] = 0
