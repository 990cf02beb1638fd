"""Shared model-building blocks (PyTorch port of ``repro/models/layers.py``).

Parameters live in a flat ``{name: tensor}`` dict; a parallel schema maps each
name to ``(shape, logical_axes, init, dtype)``, the same layout as the JAX
package, so a parameter dict converts between the two by name.

Weight tensors may be plain tensors OR :class:`QT` / :class:`QT4` triples
(quantized symbols + scale + zero): ``matmul`` / ``take_rows`` dequantize at
use, in bf16, exactly as the JAX package does before it hands the product to
its compiler.  The products themselves are plain ``torch.matmul`` calls (the
JAX package leaves them to XLA, not to a kernel of its own).  A
:class:`~repro_torch.kernels.fused_decode_matmul.FusedQT` weight (the
compressed-resident mode's payload handle) goes to the fused
decode→dequant→matmul kernel instead.

Numerics follow the JAX package op for op: dequantize in bf16, attention
scores from bf16 operands accumulated in float32, RMS norm statistics in
float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.fused_decode_matmul import FusedQT, fused_decode_matmul

# --------------------------------------------------------------------------- schema

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis names, len == len(shape)
    init: Any = 0.02                # float std | "zeros" | "ones"
    dtype: torch.dtype = torch.bfloat16   # norms use f32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = Dict[str, Spec]


def init_param(gen: torch.Generator, spec: Spec,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    std = float(spec.init)
    w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (std * w).to(spec.dtype)


def init_params(schema: Schema, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Random parameters from one seeded generator on ``device``, drawn in
    sorted name order (torch and JAX give different numbers from one seed;
    tests that compare the packages hand both the same numpy weights)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {n: init_param(gen, schema[n], device) for n in sorted(schema)}


# ----------------------------------------------------------------- quantized weights

class QT(NamedTuple):
    """Quantized weight triple; integer bytes stay in device memory."""
    q: torch.Tensor        # uint8 symbols
    scale: torch.Tensor    # f32 broadcastable
    zero: torch.Tensor     # f32 broadcastable


class QT4(NamedTuple):
    """int4 weights packed two-per-byte along the LAST axis: q[..., j] holds
    symbol 2j in the low nibble and symbol 2j+1 in the high nibble."""
    q: torch.Tensor        # uint8, last dim = N/2
    scale: torch.Tensor
    zero: torch.Tensor


def _unpack4(q: torch.Tensor) -> torch.Tensor:
    lo = q & 0x0F
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                 q.shape[-1] * 2)


def pack_qt(q: np.ndarray, scale: np.ndarray, zero: np.ndarray, *,
            bits: int, pack_int4: bool = True) -> "QT | QT4":
    """Host ``(q, scale, zero)`` symbols -> the serving-resident triple (CPU
    tensors; the loader moves them to the device).

    4-bit symbols with an even last dim pack nibble pairs into :class:`QT4`
    (0.5 bytes/param resident) unless ``pack_int4`` is off, everything else
    stays a :class:`QT` of uint8 symbols — the JAX package's rule, byte for
    byte.  Both weight loaders (whole-model and per-layer resident) share it.
    """
    q = np.asarray(q)
    if bits == 4 and pack_int4 and q.shape[-1] % 2 == 0:
        packed = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
        return QT4(torch.from_numpy(packed), torch.from_numpy(np.asarray(scale)),
                   torch.from_numpy(np.asarray(zero)))
    return QT(torch.from_numpy(np.ascontiguousarray(q)),
              torch.from_numpy(np.asarray(scale)),
              torch.from_numpy(np.asarray(zero)))


def to_device(w: Any, device: torch.device) -> Any:
    """Move a tensor or each part of a QT / QT4 triple to ``device``."""
    if isinstance(w, (QT, QT4)):
        return type(w)(*(p.to(device) for p in w))
    return w.to(device)


def layer_slice(w: Any, l: int) -> Any:
    """Layer ``l`` of a layer-stacked tensor or QT / QT4 triple (the slice
    ``lax.scan`` hands each iteration in the JAX package)."""
    if isinstance(w, (QT, QT4)):
        return type(w)(*(p[l] for p in w))
    return w[l]


def deq(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(w, QT):
        return w.q.to(dtype) * w.scale.to(dtype) + w.zero.to(dtype)
    if isinstance(w, QT4):
        return (_unpack4(w.q).to(dtype) * w.scale.to(dtype)
                + w.zero.to(dtype))
    return w.to(dtype) if w.dtype != dtype else w


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w with dequantization at use (bf16 for QT / QT4 weights); a
    :class:`FusedQT` weight decodes inside the fused kernel (plain ``x @ w``
    only, as in the JAX package)."""
    if isinstance(w, FusedQT):
        return fused_decode_matmul(x, w)
    return x @ deq(w, x.dtype)


def take_rows(w: Any, idx: torch.Tensor) -> torch.Tensor:
    """Embedding lookup honoring quantized tables (dequantize only gathered
    rows)."""
    if isinstance(w, (QT, QT4)):
        rows = w.q[idx]
        if isinstance(w, QT4):
            rows = _unpack4(rows)
        scale = w.scale if w.scale.dim() == 0 or w.scale.shape[0] == 1 \
            else w.scale[idx]
        zero = w.zero if w.zero.dim() == 0 or w.zero.shape[0] == 1 \
            else w.zero[idx]
        return rows.to(torch.bfloat16) * scale.to(torch.bfloat16) \
            + zero.to(torch.bfloat16)
    return w[idx]


# ------------------------------------------------------------------------ primitives

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)            # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` op by op as the JAX package lowers it (negate, exp,
    add, divide, multiply, each rounded to ``x.dtype``); ``F.silu`` rounds
    once and differs in the last bf16 bit on about a third of the inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(x: torch.Tensor, w_gate: Any, w_up: Any, w_down: Any) -> torch.Tensor:
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    return matmul(silu(g) * u, w_down)


# -------------------------------------------------------------------------- attention

NEG_INF = -1e9


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """Grouped-query attention for a lockstep batch (one scalar position).

    q: (B, S, H, hd); k, v: (B, T, KV, hd).  KV heads are broadcast up to H,
    scores come from bf16 operands accumulated in float32, the softmax runs
    in float32 and the probabilities are cast to ``v``'s dtype for the
    second product — the JAX package's contract.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    # JAX rounds a Python scalar to the dtype of the array it meets (weak
    # typing): hd**-0.5 becomes a bf16 value before it scales bf16 q
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    if G > 1:
        k = k[:, :, :, None, :].expand(B, T, KV, G, hd).reshape(B, T, H, hd)
        v = v[:, :, :, None, :].expand(B, T, KV, G, hd).reshape(B, T, H, hd)
    s = torch.einsum("bsnh,btnh->bnst",
                     (q * scale).to(torch.bfloat16).float(),
                     k.to(torch.bfloat16).float())
    tpos = torch.arange(T, device=q.device)
    qpos = q_offset + torch.arange(S, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= tpos <= qpos[:, None]
    if kv_len is not None:
        mask &= tpos < kv_len
    s = torch.where(mask, s, NEG_INF)
    # softmax written out as the JAX package computes it (exp of the
    # max-shifted scores, divided by their sum)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bnst,btnh->bsnh", p.to(v.dtype), v)


def update_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
    """Write step-k/v (B, S, KV, hd) into preallocated (B, T, KV, hd) caches
    at offset ``pos`` along T, **in place** (the JAX package returns updated
    copies; the port reuses the cache's memory)."""
    S = k.shape[1]
    cache_k[:, pos:pos + S] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v.to(cache_v.dtype)
