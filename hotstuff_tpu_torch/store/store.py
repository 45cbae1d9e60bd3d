"""Persistent keyed byte store with a single-writer actor and notify_read.

Capability parity with the reference `store` crate (store/src/lib.rs:15-92):
  * one writer task owns all state; commands arrive over a channel
  * Write / Read / NotifyRead commands with oneshot replies
  * NotifyRead registers an obligation resolved by a FUTURE Write of that key
    -- the synchronizers' wait primitive for out-of-order block/payload arrival

The reference persists via rocksdb; here the data plane sits behind the
same command protocol:
  * a C++ log-structured engine (`hotstuff_tpu_torch/native/store.cpp`,
    the port's copy of the reference's `native/store.cpp`, via ctypes) —
    hash index + append-only length-prefixed log + crash-safe torn-tail
    truncate — for every file-backed store;
  * a plain dict for path-less (in-memory, test) stores.

The engine COMPACTS: when the log grows past an adaptive threshold the
live keys are rewritten and the file atomically replaced — the role
rocksdb's background compaction plays in the reference. Without it, the
safety-state key rewritten every round (consensus/core.py) would grow the
log and the restart replay time without bound.

The port's copy of `hotstuff_tpu/store/store.py`, its imports rewritten to
this package. The engine is built with `g++` at first use into the
git-ignored `hotstuff_tpu_torch/native/build/`, as the staging plane is
(`crypto/native_staging.py`). Unlike the reference, a file-backed store
has no quiet fallback to a pure-Python engine: a build or open that fails
raises. Its log format is the reference's, so each package's engine
replays the other's log.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import threading
from collections import defaultdict, deque
from pathlib import Path

from ..utils.actors import channel, spawn

log = logging.getLogger("hotstuff.store")

# Compact when the log exceeds this many bytes AND twice the live size.
MIN_COMPACT_BYTES = 8 * 1024 * 1024


class _MemEngine:
    """Path-less store: a dict, no durability (tests, MockMempool)."""

    log_bytes = 0

    def __init__(self) -> None:
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        return self._data.get(key)

    def put(self, key: bytes, value: bytes) -> None:
        self._data[key] = value

    def compact(self) -> int:
        return 0

    def close(self) -> None:
        pass


class _NativeEngine:
    """The C++ engine (native/store.cpp): index and values live outside the
    Python heap; replay, torn-tail truncate, and compaction are native."""

    SOURCE = Path(__file__).resolve().parents[1] / "native" / "store.cpp"

    def __init__(self, lib, path: str) -> None:
        self._lib = lib
        handle = lib.hs_store_open(path.encode(), 0)
        if not handle:
            raise OSError(f"hs_store_open failed for {path}")
        self._handle = ctypes.c_void_p(handle)
        self.log_bytes = os.path.getsize(path) if os.path.exists(path) else 0

    def get(self, key: bytes) -> bytes | None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        kbuf = (ctypes.c_uint8 * len(key)).from_buffer_copy(key)
        n = self._lib.hs_store_read(
            self._handle, kbuf, len(key), ctypes.byref(out)
        )
        if n < 0:
            return None
        try:
            return ctypes.string_at(out, n)
        finally:
            self._lib.hs_free(out)

    def put(self, key: bytes, value: bytes) -> None:
        kbuf = (ctypes.c_uint8 * len(key)).from_buffer_copy(key)
        vbuf = (ctypes.c_uint8 * max(1, len(value))).from_buffer_copy(
            value or b"\x00"
        )
        rc = self._lib.hs_store_write(
            self._handle, kbuf, len(key), vbuf, len(value)
        )
        if rc != 0:
            raise OSError("hs_store_write failed")
        self.log_bytes += 8 + len(key) + len(value)

    def compact(self) -> int:
        new_size = self._lib.hs_store_compact(self._handle)
        if new_size >= 0:
            self.log_bytes = new_size
        return new_size

    def close(self) -> None:
        if self._handle:
            self._lib.hs_store_close(self._handle)
            self._handle = None


def _load_library() -> ctypes.CDLL:
    """The store engine's library, built first if needed (raises when it
    cannot be built or loaded)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ..crypto import native_staging

            lib = ctypes.CDLL(str(native_staging.build(_NativeEngine.SOURCE, "the store engine")))
            lib.hs_store_open.argtypes = (ctypes.c_char_p, ctypes.c_int)
            lib.hs_store_open.restype = ctypes.c_void_p
            lib.hs_store_compact.argtypes = (ctypes.c_void_p,)
            lib.hs_store_compact.restype = ctypes.c_int64
            lib.hs_store_write.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_int64)
            lib.hs_store_write.restype = ctypes.c_int
            lib.hs_store_read.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)))
            lib.hs_store_read.restype = ctypes.c_int64
            lib.hs_store_close.argtypes = (ctypes.c_void_p,)
            lib.hs_store_close.restype = None
            lib.hs_free.argtypes = (ctypes.c_void_p,)
            lib.hs_free.restype = None
            _LIB = lib
        return _LIB


_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def _make_engine(path: str | None):
    if path is None:
        return _MemEngine()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return _NativeEngine(_load_library(), path)


class Store:
    """Async KV store handle; cheap to share (all ops go through one queue)."""

    def __init__(self, path: str | None = None) -> None:
        self._engine = _make_engine(path)
        # Direct index access for the in-memory engine (tests introspect
        # it); None for the native engine.
        self._data = getattr(self._engine, "_data", None)
        self._obligations: dict[bytes, deque[asyncio.Future]] = defaultdict(deque)
        self._queue = channel()
        self._path = path
        self._compact_threshold = MIN_COMPACT_BYTES
        self.compactions = 0
        self._cmd_count = 0
        self._task = spawn(self._run(), name="store-writer")

    def _sweep_obligations(self) -> None:
        """Drop cancelled waiters and empty keys. Obligations for keys that
        are NEVER written (e.g. a Byzantine block referencing bogus payload
        digests, whose waiter the synchronizer later cancels) would otherwise
        accumulate without bound; amortized over the command stream."""
        dead = []
        for key, waiters in self._obligations.items():
            if not any(w.cancelled() for w in waiters):
                continue  # nothing to prune; avoid rebuilding live deques
            live = deque(w for w in waiters if not w.cancelled())
            if live:
                self._obligations[key] = live
            else:
                dead.append(key)
        for key in dead:
            del self._obligations[key]

    @property
    def engine_name(self) -> str:
        return type(self._engine).__name__.strip("_")

    async def _maybe_compact(self) -> None:
        if self._engine.log_bytes <= self._compact_threshold:
            return
        # Off the event loop: a full live-set rewrite + fsync would stall
        # consensus timers and network I/O. Store commands queue behind it
        # (the actor serializes), the rest of the node keeps running.
        new_size = await asyncio.to_thread(self._engine.compact)
        self.compactions += 1
        if new_size < 0:
            # Failed (e.g. disk full): back off relative to the CURRENT log
            # so every subsequent write doesn't re-attempt a full rewrite.
            self._compact_threshold = max(
                MIN_COMPACT_BYTES, 2 * self._engine.log_bytes
            )
            log.error("store compaction failed; next attempt at %s bytes",
                      self._compact_threshold)
            return
        # Adaptive: if most of the log was live, double the threshold so
        # steady-state growth doesn't trigger quadratic rewrites.
        self._compact_threshold = max(MIN_COMPACT_BYTES, 2 * new_size)

    async def _run(self) -> None:
        while True:
            cmd, args, fut = await self._queue.get()
            self._cmd_count += 1
            if self._cmd_count % 4096 == 0:
                self._sweep_obligations()
            if cmd == "write":
                key, value = args
                try:
                    self._engine.put(key, value)
                    await self._maybe_compact()
                except (OSError, ValueError) as e:
                    # A failed write (disk full, failed compact) must neither
                    # kill the writer actor (every later command would hang
                    # forever) nor resolve the caller as if durable.
                    log.error("store write failed: %r", e)
                    if fut is not None and not fut.cancelled():
                        fut.set_exception(e)
                    continue
                # Resolve pending notify_read obligations for this key
                # (store/src/lib.rs:36-47).
                for waiter in self._obligations.pop(key, ()):
                    if not waiter.cancelled():
                        waiter.set_result(value)
                if fut is not None and not fut.cancelled():
                    fut.set_result(None)
            elif cmd == "read":
                (key,) = args
                if not fut.cancelled():
                    fut.set_result(self._engine.get(key))
            elif cmd == "notify_read":
                (key,) = args
                value = self._engine.get(key)
                if value is not None:
                    if not fut.cancelled():
                        fut.set_result(value)
                else:
                    self._obligations[key].append(fut)

    async def write(self, key: bytes, value: bytes) -> None:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(("write", (key, value), fut))
        await fut

    async def read(self, key: bytes) -> bytes | None:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(("read", (key,), fut))
        return await fut

    async def notify_read(self, key: bytes) -> bytes:
        """Blocking read: resolves immediately if present, else when a later
        write stores the key (store/src/lib.rs:49-57)."""
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(("notify_read", (key,), fut))
        return await fut

    def close(self) -> None:
        self._task.cancel()
        self._engine.close()
