"""Oracles of the port's kernels (counterpart of
``src/repro/kernels/ref.py``): thin names over the plain versions and the
host decoders the kernels are held to."""
from __future__ import annotations

import numpy as np
import torch

from ..core import bitstream
from .dequant_matmul import dequant_matmul_plain


def dequant_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale, zero, *,
                       int4: bool = False) -> torch.Tensor:
    """Same arithmetic as ``kernels.dequant_matmul`` in plain torch ops."""
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        v, dtype=torch.float32, device=x.device)
    return dequant_matmul_plain(x, wq, f32(scale), f32(zero), int4=int4)


def decode_streams_ref(mat: np.ndarray, counts: np.ndarray,
                       lut_sym: np.ndarray, lut_len: np.ndarray,
                       max_len: int) -> np.ndarray:
    """Host-side multi-stream prefix decode (``core.bitstream``)."""
    return bitstream.decode_streams(mat, counts, lut_sym, lut_len, max_len)


def fused_decode_matmul_ref(x: torch.Tensor, mat: np.ndarray, table, scale,
                            zero, *, seg_symbols: int, K: int,
                            N: int) -> torch.Tensor:
    """Numpy-decode oracle of ``kernels.fused_decode_matmul``: every lane
    decoded on the host by the numpy backend, then exactly ``layers.deq``
    and ``x @ w``."""
    from ..core.decode_backends import get_backend
    from ..models.layers import QT, deq
    mat = np.asarray(mat)
    counts = np.full(mat.shape[0], seg_symbols, np.int64)
    dec = get_backend("numpy").decode_table(table, mat, counts,
                                            max_count=seg_symbols)
    q = torch.from_numpy(np.asarray(dec).reshape(K, N).astype(np.uint8))
    f32 = lambda v: torch.as_tensor(  # noqa: E731
        np.asarray(v, np.float32))
    return x @ deq(QT(q.to(x.device), f32(scale).to(x.device),
                      f32(zero).to(x.device)), x.dtype)
