"""Pluggable decoder backends for the multi-stream entropy decode.

One decode *call* takes a packed stream matrix (S segments x B bytes, guard
padded), per-segment symbol counts, and a codec's decode tables, and returns
the (S, max_count) int32 symbol matrix.  Two **kernel families** cover every
registered codec (see :mod:`repro_torch.core.codecs`):

* ``"prefix"`` — canonical-code LUT loop (``huffman`` and the ``raw``
  bit-packed baseline): ``core.bitstream.decode_streams`` (numpy),
  ``kernels.huffman_decode.decode_streams_plain`` (torch),
  ``kernels.huffman_decode.decode_streams`` (CUDA kernel).
* ``"tans"`` — carried-state tANS loop (``rans``):
  ``core.bitstream.decode_streams_tans``,
  ``kernels.ans_decode.decode_streams_tans_plain``,
  ``kernels.ans_decode.decode_streams_tans``.

Registered backends:

* ``numpy`` — the host loops; always available.
* ``torch`` — the kernels' plain versions on CPU tensors, fed the same
  power-of-two buckets as the JAX package's ``jax`` backend.
* ``cuda`` — the CUDA kernels.  Available only where a card is; asked for
  by name on a host without one, :func:`get_backend` raises.  A kernel that
  fails to build or launch raises too: no backend falls back to another.

``auto`` (or ``None``) follows the device: ``cuda`` for a CUDA device (the
default), ``torch`` for the CPU.

Each backend also has the *fused* capability (decode→dequant→matmul in one
pass, :mod:`repro_torch.kernels.fused_decode_matmul`): ``numpy`` decodes on
the host and then runs the serving dequant and product (the counterpart of
the JAX package's ``_fused_ref``), ``torch`` runs the fused plain version on
the CPU, ``cuda`` launches the fused kernels.  There is no separate fused
probe: a backend that runs here runs its fused path.

Every backend returns **host** int32 arrays: the ``cuda`` backend copies its
result back (``.cpu()``, which also waits for the kernel), so the scheduler
and the container code stay device-agnostic at the price of one round trip
over PCIe per call.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from .. import device as _device
from .bitstream import decode_streams, decode_streams_tans


@dataclasses.dataclass(frozen=True)
class DecoderBackend:
    """A named decode implementation + its capability probe.

    ``fns`` maps kernel family -> callable:
      ``fns["prefix"](mat, counts, lut_sym, lut_len, max_len, max_count,
      out=None)``
      ``fns["tans"](mat, counts, tab_sym, tab_bits, tab_base, table_log,
      max_count, out=None)`` — both return an (S', >=max_count) int32
      ndarray with ``S' >= S`` (bucket padding rows may trail).
    ``out`` is an optional preallocated int32 host buffer (the
    decode-into-buffer contract): the numpy family decodes straight into it,
    the torch and cuda families copy their result into it — either way the
    caller's buffer holds the symbols on return.
    ``probe`` answers "can this backend run here at all?".
    ``fused_fns`` maps kernel family -> the fused decode→dequant→matmul
    ``fused_fns[fam](table, x, mat, scale, zero, *, seg_symbols, K, N,
    bits)`` -> (..., N) activations on ``x``'s device.
    """

    name: str
    fns: Mapping[str, Callable[..., np.ndarray]]
    probe: Callable[[], bool]
    fused_fns: Optional[Mapping[str, Callable]] = None

    def available(self) -> bool:
        return bool(self.probe())

    def kernel_families(self) -> List[str]:
        return sorted(self.fns)

    def fused_available(self) -> bool:
        """Can this backend run the fused decode→dequant→matmul here?"""
        return bool(self.fused_fns) and self.available()

    def fused_families(self) -> List[str]:
        return sorted(self.fused_fns or ())

    def fused_matmul(self, table, x: torch.Tensor, mat: np.ndarray, scale,
                     zero, *, seg_symbols: int, K: int, N: int,
                     bits: int = 8) -> torch.Tensor:
        """Fused ``x @ dequant(decode(mat))`` through this backend (same
        family routing as :meth:`decode_table`)."""
        fn = (self.fused_fns or {}).get(table.kernel)
        if fn is None:
            raise RuntimeError(
                f"decoder backend {self.name!r} has no fused {table.kernel!r} "
                f"kernel (fused families: {self.fused_families()})")
        return fn(table, x, mat, scale, zero, seg_symbols=seg_symbols,
                  K=K, N=N, bits=bits)

    def decode(self, mat: np.ndarray, counts: np.ndarray, lut_sym: np.ndarray,
               lut_len: np.ndarray, *, max_len: int,
               max_count: Optional[int] = None,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Prefix-family decode (the pre-codec-registry contract, kept for
        direct callers); codec-aware callers use :meth:`decode_table`."""
        counts = np.asarray(counts, dtype=np.int64)
        mc = int(counts.max(initial=0)) if max_count is None else int(max_count)
        res = self.fns["prefix"](mat, counts, lut_sym, lut_len, max_len, mc,
                                 out=out)
        return np.asarray(res)[:, :mc] if mc else np.asarray(res)

    def decode_table(self, table, mat: np.ndarray, counts: np.ndarray, *,
                     max_count: Optional[int] = None,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
        """Decode streams encoded under ``table`` (a codecs.CodeTable): the
        table names its kernel family and supplies the gather arrays."""
        try:
            fn = self.fns[table.kernel]
        except KeyError:
            raise RuntimeError(
                f"decoder backend {self.name!r} has no {table.kernel!r} "
                f"kernel (families: {self.kernel_families()})") from None
        counts = np.asarray(counts, dtype=np.int64)
        mc = int(counts.max(initial=0)) if max_count is None else int(max_count)
        a = table.decode_arrays()
        if table.kernel == "prefix":
            res = fn(mat, counts, a["lut_sym"], a["lut_len"],
                     table.peek_bits, mc, out=out)
        elif table.kernel == "tans":
            res = fn(mat, counts, a["tab_sym"], a["tab_bits"], a["tab_base"],
                     table.table_log, mc, out=out)
        else:
            raise RuntimeError(f"unknown kernel family {table.kernel!r}")
        return np.asarray(res)[:, :mc] if mc else np.asarray(res)


_REGISTRY: Dict[str, DecoderBackend] = {}


def register_backend(backend: DecoderBackend) -> DecoderBackend:
    _REGISTRY[backend.name] = backend
    return backend


def backend_names() -> List[str]:
    return sorted(_REGISTRY)


def available_backends() -> List[str]:
    return [n for n in backend_names() if _REGISTRY[n].available()]


def get_backend(name: Optional[str] = None, *, device=None) -> DecoderBackend:
    """Resolve a backend by name; ``None`` / ``"auto"`` follows ``device``
    (``cuda`` unless the caller names the CPU).

    Asking for an unavailable backend — or ``auto`` for a CUDA device on a
    host without one — raises.
    """
    if name is None or name == "auto":
        dev = _device.resolve(device)
        return _REGISTRY["cuda" if dev.type == "cuda" else "torch"]
    try:
        b = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown decoder backend {name!r}; "
                       f"registered: {backend_names()}") from None
    if not b.available():
        raise RuntimeError(f"decoder backend {name!r} is not available on "
                           f"this host (available: {available_backends()})")
    return b


def _fill_out(out, res, rows, max_count):
    """Decode-into-buffer for kernels that return fresh (possibly
    bucket-padded) arrays: copy the ``rows`` real streams' symbols into the
    caller's buffer and return the written view.  Same contract — including
    the undersized-buffer ValueError — as the numpy family's in-place path
    (``bitstream._decode_out``); ``rows`` is the pre-bucketing stream count,
    so bucket-padding rows are never copied and never required to fit."""
    if out is None:
        return res
    if out.dtype != np.int32 or out.shape[0] < rows \
            or out.shape[1] < max_count:
        raise ValueError(
            f"decode out buffer {out.dtype}{out.shape} too small for "
            f"({rows}, {max_count}) int32")
    res = np.asarray(res)
    out[:rows, :max_count] = res[:rows, :max_count]
    return out[:rows, :max_count]


def _tensors(device, mat, counts, *tables):
    """Host arrays -> contiguous tensors on ``device`` (uint8 streams, int32
    counts and tables), the layout both kernel wrappers take."""
    t = [torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8)),
         torch.from_numpy(np.asarray(counts, dtype=np.int32))]
    t += [torch.from_numpy(np.asarray(a, dtype=np.int32)) for a in tables]
    return [x.to(device) for x in t]


# ---------------------------------------------------------- fused capability
def _fused_host(table, x, mat, scale, zero, *, seg_symbols, K, N, bits=8):
    """Host decode through the numpy loop, then the serving dequant and
    product on ``x``'s device (the counterpart of the JAX package's
    ``_fused_ref`` / ``kernels.ref.fused_decode_matmul_ref``)."""
    from ..models.layers import QT, deq
    counts = np.full(mat.shape[0], seg_symbols, np.int64)
    dec = _REGISTRY["numpy"].decode_table(table, mat, counts,
                                          max_count=seg_symbols)
    t = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.asarray(a).astype(dt)).to(x.device)
    q = t(dec.reshape(K, N), np.uint8)
    return x @ deq(QT(q, t(scale, np.float32), t(zero, np.float32)), x.dtype)


def _fused_on(device: str):
    def fn(table, x, mat, scale, zero, *, seg_symbols, K, N, bits=8):
        from ..kernels.fused_decode_matmul import (build_fused_qt,
                                                   fused_decode_matmul)
        fq = build_fused_qt(table, mat, scale, zero, seg_symbols=seg_symbols,
                            K=K, N=N, bits=bits, device=device)
        return fused_decode_matmul(x, fq)
    return fn


# ------------------------------------------------------------------ numpy
def _numpy_decode(mat, counts, lut_sym, lut_len, max_len, max_count,
                  out=None):
    return decode_streams(mat, counts, lut_sym, lut_len, max_len, out=out)


def _numpy_decode_tans(mat, counts, tab_sym, tab_bits, tab_base, table_log,
                       max_count, out=None):
    return decode_streams_tans(mat, counts, tab_sym, tab_bits, tab_base,
                               table_log, out=out)


register_backend(DecoderBackend(
    name="numpy",
    fns={"prefix": _numpy_decode, "tans": _numpy_decode_tans},
    probe=lambda: True,
    fused_fns={"prefix": _fused_host, "tans": _fused_host}))


# ------------------------------------------------------------------ torch
def _torch_decode(mat, counts, lut_sym, lut_len, max_len, max_count,
                  out=None):
    from ..kernels.huffman_decode import decode_streams_plain
    from .decode_torch import bucket_streams
    rows = mat.shape[0]
    mat, counts, mc = bucket_streams(mat, counts, max_count)
    res = decode_streams_plain(*_tensors("cpu", mat, counts, lut_sym,
                                         lut_len),
                               max_len=max_len, max_count=mc)
    return _fill_out(out, res.numpy(), rows, max_count)


def _torch_decode_tans(mat, counts, tab_sym, tab_bits, tab_base, table_log,
                       max_count, out=None):
    from ..kernels.ans_decode import decode_streams_tans_plain
    from .decode_torch import bucket_streams
    rows = mat.shape[0]
    mat, counts, mc = bucket_streams(mat, counts, max_count)
    res = decode_streams_tans_plain(
        *_tensors("cpu", mat, counts, tab_sym, tab_bits, tab_base),
        table_log=table_log, max_count=mc)
    return _fill_out(out, res.numpy(), rows, max_count)


register_backend(DecoderBackend(
    name="torch",
    fns={"prefix": _torch_decode, "tans": _torch_decode_tans},
    probe=lambda: True,
    fused_fns={"prefix": _fused_on("cpu"), "tans": _fused_on("cpu")}))


# ------------------------------------------------------------------- cuda
# The kernels compile nothing per shape, so the cuda backend decodes the
# packed matrix as it is (no bucket padding); the trimmed result is the same.
def _cuda_decode(mat, counts, lut_sym, lut_len, max_len, max_count,
                 out=None):
    from ..kernels.huffman_decode import decode_streams as kernel
    res = kernel(*_tensors("cuda", mat, counts, lut_sym, lut_len),
                 max_len=max_len, max_count=max_count).cpu().numpy()
    return _fill_out(out, res, mat.shape[0], max_count)


def _cuda_decode_tans(mat, counts, tab_sym, tab_bits, tab_base, table_log,
                      max_count, out=None):
    from ..kernels.ans_decode import decode_streams_tans as kernel
    res = kernel(*_tensors("cuda", mat, counts, tab_sym, tab_bits, tab_base),
                 table_log=table_log, max_count=max_count).cpu().numpy()
    return _fill_out(out, res, mat.shape[0], max_count)


register_backend(DecoderBackend(
    name="cuda",
    fns={"prefix": _cuda_decode, "tans": _cuda_decode_tans},
    probe=torch.cuda.is_available,
    fused_fns={"prefix": _fused_on("cuda"), "tans": _fused_on("cuda")}))
