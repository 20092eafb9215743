"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by its own ``nvcc``, all started together, into a
shared library with a plain C interface (``lib<source>.so``), loaded with
``ctypes``. Nothing is built when a module is imported: the first launch
builds. The build goes to ``build/repro_torch/<digest>/`` at the root of
the checkout, keyed by a hash of the sources and flags, so an edited
source never loads a stale library.

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
# the C entry points of each source, with their argument types (pointers
# and the stream as c_void_p, so ctypes never truncates them to 32 bits)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = {
    "zebra_stream.cu": {
        "zebra_bitmap_launch": [_P, _P, _L, _L, _I, _I, _F, _I, _P],
        "zebra_pack_launch": [_P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
        "zebra_unpack_launch": [_P, _P, _P, _P, _L, _L, _I, _I, _I, _P],
        "zebra_mask_launch": [_P, _P, _P, _L, _L, _I, _I, _F, _I, _P],
    },
    "zebra_gemm.cu": {
        "zebra_spmm_launch": [_P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P],
        "zebra_spmm_cs_launch": [_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _P],
    },
}
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: "KernelLibrary | None" = None


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


def build() -> dict[str, Path]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    each, all at once; return {source: library path}. Each compiler's
    output (``-Xptxas -v``: registers, shared memory and spills per
    kernel) is kept beside its library as ``lib<source>.log``."""
    out = build_dir()
    libs = {src: out / f"lib{Path(src).stem}.so" for src in SOURCES}
    todo = {src: lib for src, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[src] = (tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    failed = []
    for src, (tmp, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src}: nvcc exit {rc}\n{Path(log.name).read_text()}")
        else:
            os.replace(tmp, libs[src])      # atomic: a reader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return libs


class KernelLibrary:
    """The C entry points of every source, as attributes."""

    def __init__(self, paths: dict[str, Path]):
        for src, entries in SOURCES.items():
            lib = ctypes.CDLL(str(paths[src]))
            for name, argtypes in entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(self, name, fn)


def load_library() -> KernelLibrary:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = KernelLibrary(build())
        return _lib


def cuda_library(t: torch.Tensor, kernel: str) -> KernelLibrary:
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
