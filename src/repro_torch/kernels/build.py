"""Build and load the port's CUDA kernels (``kernels/csrc/zebra_stream.cu``).

The source is compiled by ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``. Nothing is built when a module is
imported: the first launch builds. The build goes to
``build/repro_torch/<digest>/`` at the root of the checkout, keyed by a
hash of the sources and flags, so an edited source never loads a stale
library.

Without ``nvcc`` the build raises: a CUDA tensor never falls back to a
plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCE = CSRC / "zebra_stream.cu"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location. Raises if none exists."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the repro_torch CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the source unless its library exists; return the library's
    path. Compiler output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside it as ``<name>.log``."""
    out = build_dir()
    lib = out / f"lib{SOURCE.stem}.so"
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = out / f"{SOURCE.stem}.log"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(SOURCE)]
    with open(log, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"CUDA kernel build failed: {SOURCE.name}: nvcc exit "
                           f"{rc}\n{log.read_text()}")
    os.replace(tmp, lib)        # atomic: a reader sees all or nothing
    return lib


def _declare(lib: ctypes.CDLL) -> None:
    """Argument types of the C entry points (pointers and the stream as
    ``c_void_p``, so ctypes never truncates them to 32 bits)."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "zebra_bitmap_launch": [P, P, L, L, I, I, ctypes.c_float, I, P],
        "zebra_pack_launch": [P, P, P, P, P, L, L, I, I, I, P],
        "zebra_unpack_launch": [P, P, P, P, L, L, I, I, I, P],
        "zebra_mask_launch": [P, P, P, L, L, I, I, ctypes.c_float, I, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def cuda_library(t: torch.Tensor, kernel: str) -> ctypes.CDLL:
    """The GPU branch's entry: the tensor must lie on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    return load_library()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
