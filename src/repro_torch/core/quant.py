"""EntroLLM mixed quantization scheme (paper Alg. 1, lines 4-10).

Per tensor (or per channel / per group as a beyond-paper extension) we choose between

* symmetric **unsigned** quantization, used when ``max(W) * min(W) >= 0`` — the whole
  tensor shares one sign, so ``W / s`` with a signed scale lands in ``[0, 2^b - 1]``;
* asymmetric quantization ``round((W - z) / s)`` with ``z = min(W)`` otherwise.

Both branches emit *unsigned* symbols in ``[0, 2^b)`` — this is what makes the
model-global symbol histogram a single low-entropy Gaussian-shaped distribution, the
property the paper's Huffman stage exploits.

Host-side (numpy) and device-side (torch) implementations share the same math; the
numpy path is used by the compression pipeline, the torch twins by dequantization
inside compute steps.
"""
from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional, Tuple

import numpy as np
import torch


class Scheme(enum.Enum):
    """Quantization grid selection (paper Fig. 2)."""

    SYMMETRIC_UNSIGNED = "symmetric_unsigned"
    ASYMMETRIC = "asymmetric"


class Granularity(enum.Enum):
    PER_TENSOR = "per_tensor"    # the paper's setting
    PER_CHANNEL = "per_channel"  # beyond-paper: one (s, z) per output channel (axis 0)
    PER_GROUP = "per_group"      # beyond-paper: one (s, z) per contiguous group on axis -1


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight tensor plus everything needed to dequantize it.

    ``q`` always stores unsigned symbols as uint8 (uint4 values occupy the low nibble;
    bit-packing happens at the bitstream/storage layer, not here).
    """

    q: np.ndarray                  # uint8 symbols in [0, 2^bits)
    scale: np.ndarray              # f32, broadcastable against q
    zero: np.ndarray               # f32, broadcastable against q (0.0 for symmetric)
    bits: int
    scheme: Scheme
    granularity: Granularity
    shape: Tuple[int, ...]

    @property
    def num_symbols(self) -> int:
        return 1 << self.bits

    def __post_init__(self) -> None:
        assert self.q.dtype == np.uint8, self.q.dtype
        assert 1 <= self.bits <= 8


def _minmax(w: np.ndarray, granularity: Granularity, group: int) -> Tuple[np.ndarray, np.ndarray]:
    if granularity is Granularity.PER_TENSOR:
        return w.min(keepdims=True), w.max(keepdims=True)
    if granularity is Granularity.PER_CHANNEL:
        red = tuple(range(1, w.ndim))
        return w.min(axis=red, keepdims=True), w.max(axis=red, keepdims=True)
    if granularity is Granularity.PER_GROUP:
        if w.shape[-1] % group != 0:
            raise ValueError(
                f"PER_GROUP quantization needs group ({group}) to divide the "
                f"last dim of shape {w.shape}; resolve_granularity() picks "
                f"the per-channel fallback for ragged tails")
        wg = w.reshape(w.shape[:-1] + (w.shape[-1] // group, group))
        return wg.min(axis=-1, keepdims=True), wg.max(axis=-1, keepdims=True)
    raise ValueError(granularity)


def resolve_granularity(w: np.ndarray, granularity: Granularity,
                        group: int, *, name: Optional[str] = None,
                        stacklevel: int = 2) -> Granularity:
    """Validate a (granularity, group) request against a tensor's shape.

    PER_GROUP with a group that does not divide the last dim used to crash in
    an opaque reshape deep inside ``_minmax``; instead, warn and fall back to
    the nearest coarser granularity (per-channel for matrices, per-tensor for
    scalars/vectors) so ragged tails still quantize.  A non-positive
    ``group`` is a plain misconfiguration and raises.  PER_CHANNEL on a
    scalar or 1-D tensor would degenerate to one (scale, zero) pair per
    ELEMENT (8 metadata bytes per parameter — larger than fp32): warn and
    fall back to per-tensor.

    ``name`` (the container tensor name, threaded from
    ``store.CompressedModel.compress``) prefixes the warning so a fallback
    in a 300-tensor model is attributable; ``stacklevel`` points the
    warning at this function's direct caller by default — callers that wrap
    it (``quantize``) bump it so the warning lands on *their* caller.
    """
    tag = f"{name}: " if name else ""
    if granularity is Granularity.PER_CHANNEL and w.ndim < 2:
        warnings.warn(
            f"{tag}PER_CHANNEL on a {w.ndim}-D tensor of shape "
            f"{tuple(w.shape)} would store per-element scales; falling back "
            f"to per_tensor", stacklevel=stacklevel)
        return Granularity.PER_TENSOR
    if granularity is not Granularity.PER_GROUP:
        return granularity
    if group <= 0:
        raise ValueError(
            f"{tag}PER_GROUP quantization needs group >= 1, got {group}")
    if w.ndim == 0:
        # a scalar has no last dim to group; the generic "does not divide"
        # wording would be nonsense, so say what actually happened
        warnings.warn(
            f"{tag}PER_GROUP on a 0-D tensor has no axis to group; "
            f"falling back to per_tensor", stacklevel=stacklevel)
        return Granularity.PER_TENSOR
    if w.shape[-1] % group == 0:
        return granularity
    fallback = (Granularity.PER_CHANNEL if w.ndim >= 2
                else Granularity.PER_TENSOR)
    warnings.warn(
        f"{tag}PER_GROUP group={group} does not divide the last dim of "
        f"shape {tuple(w.shape)}; falling back to {fallback.value} for "
        f"this tensor", stacklevel=stacklevel)
    return fallback


def choose_scheme(w: np.ndarray) -> Scheme:
    """Paper Alg. 1 line 5: symmetric-unsigned iff the tensor is single-signed."""
    return (
        Scheme.SYMMETRIC_UNSIGNED
        if float(w.max()) * float(w.min()) >= 0.0
        else Scheme.ASYMMETRIC
    )


def quantize(
    w: np.ndarray,
    bits: int,
    granularity: Granularity = Granularity.PER_TENSOR,
    group: int = 128,
    scheme: Optional[Scheme] = None,
    name: Optional[str] = None,
) -> QuantizedTensor:
    """Quantize ``w`` with the EntroLLM mixed scheme.

    ``scheme=None`` (default) applies the paper's per-tensor rule; pass a scheme to
    force one branch (used by tests and by the policy layer).  ``name`` only
    labels granularity-fallback warnings (see :func:`resolve_granularity`).
    """
    w = np.asarray(w, dtype=np.float32)
    if scheme is None:
        scheme = choose_scheme(w)
    granularity = resolve_granularity(w, granularity, group, name=name,
                                      stacklevel=3)
    qmax = float((1 << bits) - 1)
    lo, hi = _minmax(w, granularity, group)

    if scheme is Scheme.SYMMETRIC_UNSIGNED:
        # Single-signed tensor: signed scale keeps symbols unsigned.  absmax with sign.
        absmax = np.where(np.abs(hi) >= np.abs(lo), hi, lo)
        scale = np.where(absmax == 0.0, 1.0, absmax / qmax).astype(np.float32)
        zero = np.zeros_like(scale)
    else:
        scale = ((hi - lo) / qmax).astype(np.float32)
        scale = np.where(scale == 0.0, 1.0, scale)
        zero = lo.astype(np.float32)

    if granularity is Granularity.PER_GROUP:
        wq = w.reshape(w.shape[:-1] + (w.shape[-1] // group, group))
        q = np.rint((wq - zero) / scale)
        q = np.clip(q, 0.0, qmax).astype(np.uint8).reshape(w.shape)
    else:
        q = np.rint((w - zero) / scale)
        q = np.clip(q, 0.0, qmax).astype(np.uint8)

    return QuantizedTensor(
        q=q, scale=scale, zero=zero, bits=bits, scheme=scheme,
        granularity=granularity, shape=tuple(w.shape),
    )


def dequantize(qt: QuantizedTensor) -> np.ndarray:
    q = qt.q.astype(np.float32)
    if qt.granularity is Granularity.PER_GROUP:
        group = qt.shape[-1] // qt.scale.shape[-2]
        qg = q.reshape(qt.shape[:-1] + (qt.shape[-1] // group, group))
        return (qg * qt.scale + qt.zero).reshape(qt.shape).astype(np.float32)
    return (q * qt.scale + qt.zero).astype(np.float32)


# --- torch twins (used at compute time; weights stay integer in device memory) --------

def dequantize_torch(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize in ``dtype``: each operand is cast first and every op
    rounds in ``dtype`` (the JAX package's ``dequantize_jnp`` contract)."""
    return q.to(dtype) * scale.to(dtype) + zero.to(dtype)


def quantize_torch(w: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tensor mixed-scheme quantization on a tensor's own device.
    Returns (q_uint8, scale, zero) as 0-d float32 scale / zero."""
    w = w.float()
    qmax = float((1 << bits) - 1)
    lo, hi = w.min(), w.max()
    single_signed = lo * hi >= 0.0
    absmax = torch.where(hi.abs() >= lo.abs(), hi, lo)
    one = torch.ones_like(lo)
    s_sym = torch.where(absmax == 0.0, one, absmax / qmax)
    s_asym = torch.where(hi == lo, one, (hi - lo) / qmax)
    scale = torch.where(single_signed, s_sym, s_asym)
    zero = torch.where(single_signed, torch.zeros_like(lo), lo)
    q = torch.clamp(torch.round((w - zero) / scale), 0.0, qmax).to(torch.uint8)
    return q, scale, zero
