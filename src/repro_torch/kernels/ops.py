"""Public wrappers of the port's kernels and the K-packing utilities
(counterpart of ``src/repro/kernels/ops.py``).

``dequant_matmul`` takes any M, K and N (the kernel masks the ragged edge)
and scale / zero as Python or numpy scalars, arrays or tensors;
``huffman_decode`` is the prefix-family decode.  Each goes to its kernel
for CUDA tensors and to the kernel's plain version for CPU tensors: the
tensor's device decides.  The JAX package's ``REPRO_DISABLE_PALLAS``
switch and ``interpret=None`` probe are not ported — both pick a path
other than the one the caller's tensors name.
"""
from __future__ import annotations

import numpy as np
import torch

from .dequant_matmul import dequant_matmul as _dequant_matmul
from .huffman_decode import decode_streams


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(K, N) uint8 symbols < 16 -> (K // 2, N) packed bytes (even k low
    nibble)."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_nibbles packs K in pairs; shape {q.shape}")
    lo = q[0::2]
    hi = q[1::2]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles(p: np.ndarray) -> np.ndarray:
    """(K // 2, N) packed bytes -> (K, N) uint8 symbols."""
    K2, N = p.shape
    out = np.empty((K2 * 2, N), np.uint8)
    out[0::2] = p & 0x0F
    out[1::2] = p >> 4
    return out


def _affine(v, device) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=device)
    return t.reshape(-1) if t.numel() > 1 else t.reshape(())


def dequant_matmul(x: torch.Tensor, wq: torch.Tensor, scale, zero, *,
                   int4: bool = False) -> torch.Tensor:
    """``bf16(x @ bf16(f32(q) * scale + zero))`` on ``x``'s device.

    ``x`` (M, K) any float dtype (cast to bf16, as the JAX package does);
    ``wq`` (K, N) uint8, or (K // 2, N) packed along K with ``int4``;
    ``scale`` / ``zero`` scalars or one value per output channel.
    """
    dev = x.device
    return _dequant_matmul(x.to(torch.bfloat16).contiguous(),
                           wq.contiguous(), _affine(scale, dev),
                           _affine(zero, dev), int4=int4)


def huffman_decode(mat: torch.Tensor, counts: torch.Tensor,
                   lut_sym: torch.Tensor, lut_len: torch.Tensor, *,
                   max_len: int, max_count: int) -> torch.Tensor:
    """Multi-stream prefix-code decode (see ``kernels.huffman_decode``):
    (S, B) uint8 streams -> (S, max_count) int32."""
    return decode_streams(mat, counts, lut_sym, lut_len, max_len=max_len,
                          max_count=max_count)
