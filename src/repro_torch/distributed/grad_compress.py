"""Gradient compression for a bandwidth-bound all-reduce (PyTorch port of
``repro/distributed/grad_compress.py``; local math only).

The uint8 mixed symmetric / asymmetric grid the paper applies to weights,
applied to the gradient's wire format in blocks of 256 elements, with
**error feedback**: the local quantization residual is added back into the
next step's gradient, so the compression error does not accumulate as a
bias (EF-SGD).  Gradients are flat ``{name: tensor}`` dicts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

f32 = torch.float32
_BLOCK = 256

Grads = Dict[str, torch.Tensor]


def _q8_blockwise(g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block symmetric / asymmetric uint8 quantization of one gradient
    (flattened, zero-padded to whole blocks)."""
    flat = g.reshape(-1).to(f32)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    xb = flat.reshape(-1, _BLOCK)
    lo = torch.amin(xb, dim=1, keepdim=True)
    hi = torch.amax(xb, dim=1, keepdim=True)
    single = lo * hi >= 0.0
    absmax = torch.where(torch.abs(hi) >= torch.abs(lo), hi, lo)
    scale = torch.where(single,
                        torch.where(absmax == 0.0, 1.0, absmax / 255.0),
                        torch.where(hi == lo, 1.0, (hi - lo) / 255.0))
    zero = torch.where(single, 0.0, lo)
    q = torch.clamp(torch.round((xb - zero) / scale), 0.0, 255.0
                    ).to(torch.uint8)
    return q, scale, zero


def _dq8_blockwise(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   shape) -> torch.Tensor:
    x = q.to(f32) * scale + zero
    n = 1
    for d in shape:
        n *= int(d)
    return x.reshape(-1)[:n].reshape(shape)


@torch.no_grad()
def compress_decompress(grads: Grads) -> Grads:
    """Quantize and dequantize every gradient (the wire format simulated);
    leaves under one block ride along uncompressed."""
    def qdq(g):
        if g.numel() < _BLOCK:
            return g
        q, s, z = _q8_blockwise(g)
        return _dq8_blockwise(q, s, z, g.shape).to(g.dtype)
    return {n: qdq(g) for n, g in grads.items()}


@torch.no_grad()
def ef_compress(grads: Grads, residual: Optional[Grads]
                ) -> Tuple[Grads, Grads]:
    """Error-feedback compression: returns (compressed grads, new residual),
    ``new_residual = (g + residual) - Q(g + residual)``."""
    if residual is None:
        residual = {n: torch.zeros(g.shape, dtype=f32, device=g.device)
                    for n, g in grads.items()}
    comp, new_res = {}, {}
    for n, g in grads.items():
        r = residual[n]
        if g.numel() < _BLOCK:
            comp[n], new_res[n] = g, torch.zeros_like(r)
            continue
        corrected = g.to(f32) + r
        q, s, z = _q8_blockwise(corrected)
        dq = _dq8_blockwise(q, s, z, g.shape)
        comp[n], new_res[n] = dq.to(g.dtype), corrected - dq
    return comp, new_res


def wire_bytes(grads: Grads, *, compressed: bool) -> int:
    """Bytes a gradient all-reduce moves a hop: 4 a float32 element, or
    with compression 1 an element plus a scale and zero (8 bytes) a block
    for every leaf of at least one block."""
    total = 0
    for g in grads.values():
        n = int(g.numel())
        if compressed and n >= _BLOCK:
            total += n + -(-n // _BLOCK) * 8
        else:
            total += n * 4
    return total
