"""Build and bind the CUDA kernels of `csrc/`.

Each kernel source `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into
its own shared library with a plain C interface and loaded with `ctypes`
(no PyTorch headers, so a build takes seconds). Builds happen at first use,
all sources at once in parallel, into `build/<hash>/`, keyed by a hash of
every file in `csrc/` and the flags — an edited source gets a fresh
directory. `build/` is git-ignored.

Every exported C function has the shape
    int hs_<name>(<pointers and ints>, int batch, void *stream)
launches on the given stream, and returns `cudaGetLastError()`;
`Kernel.launch` raises when that is not 0. There is no fallback: a kernel
that does not build or launch is an error. A source may export more than
one entry point (`h_digits.cu`: `hs_h_digits`, `hs_h_digits_idx` and the
test entry `hs_reduce_mod_l`; `g1_aggregate.cu`: `hs_g1_aggregate`,
`hs_g1_aggregate_affine` and the test entry `hs_bls_mont_mul`; `field12.cu`: `hs_field12`, `hs_field12_mul`,
`hs_field12_sub` and `hs_field12_canonical`); each entry point is a
`Kernel` with its own launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("build")
NAMES = ("ladder", "h_digits", "decompress_table", "compress_eq", "committee_ladder", "g1_aggregate", "bit_ladder",
         "field12", "field_sqr_n", "alu_chain")
# Entry points beyond `hs_<source name>`: kernel name -> its source.
EXTRA_ENTRY_POINTS = {"h_digits_idx": "h_digits", "reduce_mod_l": "h_digits", "bls_mont_mul": "g1_aggregate",
                      "g1_aggregate_affine": "g1_aggregate", "field12_mul": "field12", "field12_sub": "field12",
                      "field12_canonical": "field12"}
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if Path(NVCC_DEFAULT).exists():
        return NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD / source_hash()


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def all_built() -> bool:
    return all(_lib_path(n).exists() for n in NAMES)


def build_all() -> float:
    """Build every kernel not yet built, one `nvcc` per source, all started
    together. Returns wall seconds. Raises with the compiler's output when
    a build fails. `build/<hash>/<name>.log` keeps what ptxas said
    (registers, spills) for each kernel."""
    with _lock:
        t0 = time.perf_counter()
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        todo = [n for n in NAMES if not _lib_path(n).exists()]
        nvcc = _nvcc() if todo else ""
        procs = []
        for name in todo:
            lib = _lib_path(name)
            tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            log = open(out / f"{name}.log", "w")
            procs.append((name, tmp, lib, log,
                          subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, tmp, lib, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, lib)
            else:
                failed.append((name, (out / f"{name}.log").read_text()))
        if failed:
            raise RuntimeError(
                "CUDA kernel build failed:\n"
                + "\n".join(f"--- {n}\n{text}" for n, text in failed)
            )
        return time.perf_counter() - t0


def ptxas_report() -> dict[str, str]:
    """Per kernel source, the ptxas lines of its last build on each entry
    function, its registers, stack frame and spills."""
    out = {}
    for name in NAMES:
        log = build_dir() / f"{name}.log"
        if log.exists():
            lines = [ln.strip() for ln in log.read_text().splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
            out[name] = " | ".join(lines)
    return out


_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def spill_bytes(ptxas_text: str) -> int:
    """Spill stores + loads, in bytes, over every function of a ptxas -v
    report (a `ptxas_report` value or a build log)."""
    return sum(int(a) + int(b) for a, b in _SPILL.findall(ptxas_text))


_STACK = re.compile(r"(\d+) bytes stack frame")


def stack_bytes(ptxas_text: str) -> int:
    """Stack frame bytes summed over every function of a ptxas -v report."""
    return sum(int(a) for a in _STACK.findall(ptxas_text))


def check(t: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape/dtype/device."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("expected a contiguous tensor")


class Kernel:
    """One CUDA kernel's binding (`hs_<name>` in the library built from
    `csrc/<source>.cu`, or in the library `lib` built elsewhere) and its
    launch count (`launches` goes up by one per launch of the kernel, and
    nowhere else). Threads may launch one kernel concurrently (the crypto
    sidecar dispatches each flush on its own thread): the binding and the
    count are taken under the kernel's lock."""

    def __init__(self, name: str, source: str | None = None, lib: Path | None = None) -> None:
        self.name = name
        self.source = source or name
        self.lib = lib
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _bind(self):
        with self._lock:
            if self._fn is None:
                if self.lib is None:
                    build_all()
                lib = ctypes.CDLL(str(self.lib or _lib_path(self.source)))
                fn = getattr(lib, f"hs_{self.name}")
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream of the first tensor's device.
        Tensors pass as pointers, ints as C ints."""
        fn = self._bind()
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        c_args = []
        for a in args:
            if isinstance(a, torch.Tensor):
                c_args.append(ctypes.c_void_p(a.data_ptr()))
            else:
                c_args.append(ctypes.c_int(int(a)))
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = fn(*c_args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch (cudaError {rc})")
        with self._lock:
            self.launches += 1


KERNELS = {name: Kernel(name) for name in NAMES}
KERNELS.update({name: Kernel(name, src) for name, src in EXTRA_ENTRY_POINTS.items()})


def reset_launches() -> None:
    for k in KERNELS.values():
        with k._lock:
            k.launches = 0


def launches() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
