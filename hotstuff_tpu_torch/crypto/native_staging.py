"""The port's native staging plane: `native/staging.cpp`, built with `g++`
at first use and bound with `ctypes`.

Counterpart of `hotstuff_tpu/crypto/native_staging.py`, with the port's
own trimmed C++ source (`hotstuff_tpu_torch/native/staging.cpp`). Each of
the four wrappers takes the arguments of its numpy counterpart in
`ops/ed25519.py` plus `out`, `width` and `shards`, writes the chunk's wire
rows straight into `out`, a shard-major (shards, rows, width / shards)
uint8 buffer (a pooled staging buffer of the verifier), zeroes the pad
lanes [n, width), and returns the numpy function's dict with `packed` =
`out`:

    stage_packed_hh      prepare_batch_packed         128 rows, h hashed here
    stage_packed_dh      prepare_batch_packed_dh      128 rows, 32-byte messages
    stage_committee_hh   prepare_batch_committee       96 rows, h hashed here
    stage_committee_dh   prepare_batch_committee_dh    96 rows, 32-byte messages

The library is loaded with `ctypes.CDLL`, so every call releases the
interpreter lock while the C++ runs. The build goes to
`native/build/<source hash>/` (git-ignored), one `g++` per source hash
across processes (an `fcntl` lock), through a temporary file and a rename.
There is no fallback: a build that fails or a library that does not load
raises, with the compiler's output; the numpy staging runs only where a
caller asks for it (`Ed25519TorchVerifier(staging="numpy")`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "staging.cpp"
BUILD = SOURCE.parent / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# Entry -> argument types; each returns int (0, or 1 on inconsistent sizes).
SIGNATURES = {
    "stage_packed_hh": (_P, _P, _P, _P, _I64, _P, _I64, _I64, _P),
    "stage_packed_dh": (_P, _P, _P, _I64, _P, _I64, _I64, _P),
    "stage_committee_hh": (_P, _P, _P, _P, _I64, _P, _I64, _I64, _P),
    "stage_committee_dh": (_P, _P, _I64, _P, _I64, _I64, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_calls = dict.fromkeys(SIGNATURES, 0)


def source_hash(source: Path | None = None) -> str:
    source = source or SOURCE
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(source.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: Path | None = None) -> Path:
    source = source or SOURCE
    return BUILD / source_hash(source) / f"lib{source.stem}.so"


def build(source: Path | None = None, what: str = "native staging") -> Path:
    """Build the library of the current `source` (a C++ file of
    `native/`: this module's staging plane by default, or the store engine
    of `store/store.py`) unless it is built; return its path. Raises
    RuntimeError with the compiler's output when the build fails or the
    compiler is missing, naming the library `what`."""
    source = source or SOURCE
    lib = library_path(source)
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / "build.lock", "w") as lock:
        # Test workers, sidecar and node processes may all start here at once.
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [CXX, *CXX_FLAGS, str(source), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"{what} cannot be built: {CXX} not found ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{what} build failed ({' '.join(cmd)}, exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, f"hs_{name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def calls() -> dict[str, int]:
    """Calls of each entry since the last `reset_calls`."""
    with _lock:
        return dict(_calls)


def reset_calls() -> None:
    with _lock:
        for name in _calls:
            _calls[name] = 0


def _blob(parts: Sequence[bytes], size: int, what: str) -> np.ndarray:
    arr = np.frombuffer(b"".join(parts), np.uint8)
    if arr.size != size:
        raise ValueError(f"{what}: {arr.size} bytes, expected {size}")
    return arr


def _messages(messages: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Any-length messages as one blob and n + 1 int64 offsets."""
    offsets = np.zeros(len(messages) + 1, np.int64)
    np.cumsum(np.fromiter(map(len, messages), np.int64, len(messages)), out=offsets[1:])
    return np.frombuffer(b"".join(messages), np.uint8), offsets


def _call(name: str, rows: int, n: int, out: np.ndarray, width: int, shards: int, *inputs) -> np.ndarray:
    """Check `out` and the sizes, run entry `name` over `inputs` (arrays,
    then n), and return the (n,) bool s < L mask."""
    if shards < 1 or width < n or width % shards:
        raise ValueError(f"width {width} must be >= n = {n} and split into {shards} equal shards")
    shape = (shards, rows, width // shards)
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.shape == shape
            and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous uint8 array of shape {shape}")
    s_ok = np.empty(n, np.uint8)
    args = [a.ctypes.data for a in inputs] + [n, out.ctypes.data, width, shards, s_ok.ctypes.data]
    fn = getattr(load(), f"hs_{name}")
    if fn(*args) != 0:
        raise RuntimeError(f"hs_{name} refused n={n}, width={width}, shards={shards}")
    with _lock:
        _calls[name] += 1
    return s_ok.view(bool)


def stage_packed_hh(messages, keys, signatures, out, width: int, shards: int) -> dict:
    """`prepare_batch_packed` into `out`: rows A, R, S, h; any message length."""
    n = len(messages)
    msgs, offsets = _messages(messages)
    k, s = _blob(keys, 32 * n, "keys"), _blob(signatures, 64 * n, "signatures")
    s_ok = _call("stage_packed_hh", 128, n, out, width, shards, msgs, offsets, k, s)
    return dict(packed=out, s_ok=s_ok)


def stage_packed_dh(messages, keys, signatures, out, width: int, shards: int) -> dict:
    """`prepare_batch_packed_dh` into `out`: rows A, R, S, M; 32-byte messages."""
    n = len(messages)
    m = _blob(messages, 32 * n, "messages")
    k, s = _blob(keys, 32 * n, "keys"), _blob(signatures, 64 * n, "signatures")
    s_ok = _call("stage_packed_dh", 128, n, out, width, shards, m, k, s)
    return dict(packed=out, s_ok=s_ok)


def stage_committee_hh(messages, key_bytes, indices, signatures, out, width: int, shards: int) -> dict:
    """`prepare_batch_committee` into `out`: rows R, S, h; the keys feed the
    hash only. `idx` is the (n,) int32 index vector, as the numpy function
    gives it."""
    n = len(messages)
    msgs, offsets = _messages(messages)
    k, s = _blob(key_bytes, 32 * n, "keys"), _blob(signatures, 64 * n, "signatures")
    s_ok = _call("stage_committee_hh", 96, n, out, width, shards, msgs, offsets, k, s)
    return dict(packed=out, idx=np.asarray(indices, np.int32), s_ok=s_ok)


def stage_committee_dh(messages, indices, signatures, out, width: int, shards: int) -> dict:
    """`prepare_batch_committee_dh` into `out`: rows R, S, M; 32-byte messages."""
    n = len(messages)
    m, s = _blob(messages, 32 * n, "messages"), _blob(signatures, 64 * n, "signatures")
    s_ok = _call("stage_committee_dh", 96, n, out, width, shards, m, s)
    return dict(packed=out, idx=np.asarray(indices, np.int32), s_ok=s_ok)
