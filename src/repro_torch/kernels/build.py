"""Build and load the port's CUDA kernels (every ``*.cu`` under
``repro_torch/csrc/``: ``entropy_decode.cu`` and ``fused_decode_matmul.cu``,
which share ``entropy_common.cuh``, and ``dequant_matmul.cu``, which shares
``mma_bf16.cuh`` with the fused kernels).

Each source compiles for ``sm_90a`` in its own ``nvcc`` process, all
started together, and one more ``nvcc`` call links the objects into one
shared library with a plain C interface, loaded with :mod:`ctypes`; no
PyTorch header is included, so a build takes seconds.  The library lands in
``<checkout>/build/kernels/`` (listed in ``.gitignore``) under a name that
carries the hash of every source and header under ``csrc/`` and of the
flags, so an edited source or header is rebuilt at its next use and an
unchanged one is reused.

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
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_p, _i, _l = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points, each returning a cudaError_t:
#   decode: (mat, B, counts, *tables, ...scalars, out, scratch, stats,
#            stream); decode_table_fits_shared: (log)
#   fused:  (x, M, K, N, mat, B, S, seg, *tables, table_bits, scale,
#            ssk, ssn, zero, szk, szn, tile, partial, out, scratch, stats,
#            stream); fused_table_fits_shared: (log, symbol tile bytes)
#   dequant_matmul: (x, M, K, N, wq, int4, scale, ssn, zero, szn, out,
#            variant, bm, splits, k_per_split, partial, tickets, stream)
_AFFINE = [_p, _l, _l, _p, _l, _l, _i, _p, _p, _p, _p, _p]
SIGNATURES = {
    "prefix_decode": [_p, _l, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p],
    "tans_decode": [_p, _l, _p, _p, _p, _p, _i, _i, _i, _p, _p, _p, _p],
    "decode_table_fits_shared": [_i],
    "fused_prefix_matmul": [_p, _i, _i, _i, _p, _l, _i, _i, _p, _p, _i,
                            *_AFFINE],
    "fused_tans_matmul": [_p, _i, _i, _i, _p, _l, _i, _i, _p, _p, _p, _i,
                          *_AFFINE],
    "fused_table_fits_shared": [_i, _l],
    "dequant_matmul": [_p, _i, _i, _i, _p, _i, _p, _l, _p, _l, _p, _i, _i,
                       _i, _i, _p, _p, _p],
}

launches: Dict[str, int] = {"huffman_decode": 0, "ans_decode": 0,
                            "fused_prefix": 0, "fused_tans": 0,
                            "dequant_matmul": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> List[Path]:
    """The ``.cu`` files compiled into the library, in name order."""
    return sorted(CSRC.glob("*.cu"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libentropy_decode-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the library unless a current one exists; returns the
    ``ptxas`` report ("" when nothing was compiled).  Raises on a failed
    build."""
    out = lib_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objs)]
    report = ""
    for proc in procs:
        report += proc.communicate()[0]
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc(), *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        report += link.stdout
        failed = [link.returncode] if link.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"CUDA kernel build failed: nvcc exited "
                           f"{failed}\n{report}")
    os.replace(tmp, out)
    return report


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
