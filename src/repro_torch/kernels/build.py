"""Build and load the port's CUDA kernels (``repro_torch/csrc/entropy_decode.cu``).

The source compiles with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with :mod:`ctypes`; no PyTorch header is
included, so a build takes seconds.  The library lands in
``<checkout>/build/kernels/`` (listed in ``.gitignore``) under a name that
carries the hash of the source and the flags, so an edited source is rebuilt
at its next use and an unchanged one is reused.

Nothing here runs at import: :func:`load` builds on first use (the smoke
script calls :func:`build` up front to time it).  ``launches`` counts each
kernel's launches; a wrapper calls :func:`count_launch` right after its
kernel launched, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "entropy_decode.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _i = ctypes.c_void_p, ctypes.c_int
# C entry points: (mat, B, counts, *tables, ...scalars, out, stream) -> error
SIGNATURES = {
    "prefix_decode": [_p, ctypes.c_longlong, _p, _p, _p, _i, _i, _i, _i, _p,
                      _p],
    "tans_decode": [_p, ctypes.c_longlong, _p, _p, _p, _p, _i, _i, _i, _p, _p],
}

launches: Dict[str, int] = {"huffman_decode": 0, "ans_decode": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libentropy_decode-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library unless a current one exists; returns the
    ``ptxas`` report ("" when nothing was compiled).  Raises on a failed
    build."""
    out = lib_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(lib_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({load().cuda_error_string(err).decode()})")


def count_launch(name: str) -> None:
    with _lock:
        launches[name] += 1
