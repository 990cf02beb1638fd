"""Fused entropy-decode → dequantize → matmul: the CUDA kernels
``fused_prefix_matmul`` and ``fused_tans_matmul`` of
``csrc/fused_decode_matmul.cu`` and their plain PyTorch version.

Port of the TPU kernels of ``src/repro/kernels/fused_decode_matmul.py``
(``_fused_prefix_kernel``, ``_fused_tans_kernel``, shared tail
``_deq_accumulate``, launched by ``_fused_pallas``).  Compressed-resident
serving (:mod:`repro_torch.serving.resident`) keeps a tensor's layer slice as
the *packed lane matrix* of its encoded segments inside a :class:`FusedQT`
handle, and ``fused_decode_matmul(x, fq)`` computes ``x @ deq(decode(fq))``
without writing the dense weight to device memory.

Geometry (the tile-alignment contract ``core.scheduler.fused_tile_reason``
checks): the layer slice is (K, N) symbols stored row-major as S uniform
segments of ``seg`` symbols, with ``seg % N == 0``, so lane ``j`` holds the
whole rows ``j*seg/N .. (j+1)*seg/N - 1``.

:func:`fused_decode_matmul` is the one entry point.  On CUDA tensors it
launches the kernel of the handle's family (or raises); on CPU tensors it
runs :func:`fused_decode_matmul_plain`: decode every lane with the plain
decoders, reshape to (K, N) uint8, then exactly ``layers.deq`` and ``@``
(bf16 dequant, the unfused QT slot's arithmetic).  ``build.launches``
counts kernel launches only, under ``fused_prefix`` and ``fused_tans``;
:func:`launch_stats` reads what the kernel recorded of its last launch (the
prefix kernel's sync passes, a block's SM cycles).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import build
from .huffman_decode import MAX_ROW_BYTES, launch_stats, stats_buffer

LANES = 128             # the TPU kernel's lane cap per program instance
# bytes of decoded symbols one CUDA block stages in shared memory: a lane's
# rows are cut into column tiles that fit (seg <= this needs one tile)
SYM_TILE_BYTES = 64 * 1024


def lanes_per_tile(n_lanes: int, cap: int = LANES) -> int:
    """Largest divisor of ``n_lanes`` not exceeding ``cap`` (the TPU
    kernel's lane-block height; kept for parity with the JAX package)."""
    for c in range(min(n_lanes, cap), 0, -1):
        if n_lanes % c == 0:
            return c
    return 1


class FusedQT:
    """A compressed weight handle the matmul consumes directly.

    ``mat`` — the (S, B) uint8 guard-padded lane matrix of the layer slice's
    segments; ``tabs`` — the codec's int32 decode tables (prefix: lut_sym,
    lut_len; tans: tab_sym, tab_bits, tab_base); ``scale`` / ``zero`` — the
    layer's float32 dequant affine, broadcastable against (K, N).  All
    tensors lie on one device.  ``family`` is "prefix" or "tans", ``tbits``
    the peek width or table_log, ``seg`` the symbols per lane, ``K, N`` the
    dense geometry and ``bits`` the quantizer width (provenance only).
    """

    def __init__(self, mat: torch.Tensor, tabs: Sequence[torch.Tensor],
                 scale: torch.Tensor, zero: torch.Tensor, *, family: str,
                 tbits: int, seg: int, K: int, N: int, bits: int):
        self.mat = mat
        self.tabs = tuple(tabs)
        self.scale = scale
        self.zero = zero
        self.family = family
        self.tbits = int(tbits)
        self.seg = int(seg)
        self.K = int(K)
        self.N = int(N)
        self.bits = int(bits)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.K, self.N)

    @property
    def device(self) -> torch.device:
        return self.mat.device

    def __repr__(self):
        return (f"FusedQT({self.family}{self.bits}, K={self.K}, N={self.N}, "
                f"seg={self.seg}, lanes={self.mat.shape[0]}, "
                f"device={self.mat.device})")


def build_fused_qt(table, mat, scale, zero, *, seg_symbols: int, K: int,
                   N: int, bits: int, device=None) -> FusedQT:
    """Build a :class:`FusedQT` on ``device`` (``cuda`` unless the caller
    names the CPU) from a codec table and a packed lane matrix.

    ``mat`` rows are the layer slice's segments in symbol order, each holding
    exactly ``seg_symbols`` symbols (uniform: the tile-alignment contract),
    guard-padded as by ``bitstream.pack_streams``.
    """
    from .. import device as _device
    dev = _device.resolve(device)
    mat = torch.as_tensor(np.ascontiguousarray(mat, dtype=np.uint8))
    S = mat.shape[0]
    if S * seg_symbols != K * N:
        raise ValueError(
            f"lane matrix holds {S} x {seg_symbols} symbols; dense geometry "
            f"needs {K} x {N}")
    if seg_symbols % N:
        raise ValueError(
            f"segment of {seg_symbols} symbols does not tile rows of {N}")
    a = table.decode_arrays()
    if table.kernel == "prefix":
        keys, tbits = ("lut_sym", "lut_len"), int(table.peek_bits)
    elif table.kernel == "tans":
        keys, tbits = ("tab_sym", "tab_bits", "tab_base"), int(table.table_log)
    else:
        raise ValueError(f"unknown kernel family {table.kernel!r}")
    tabs = [torch.from_numpy(np.asarray(a[k], dtype=np.int32)).to(dev)
            for k in keys]
    f32 = lambda v: torch.from_numpy(  # noqa: E731
        np.array(v, dtype=np.float32)).to(dev)
    return FusedQT(mat.to(dev), tabs, f32(scale), f32(zero),
                   family=table.kernel, tbits=tbits, seg=int(seg_symbols),
                   K=int(K), N=int(N), bits=int(bits))


# ------------------------------------------------------------- plain version

def decode_lanes_plain(fq: FusedQT) -> torch.Tensor:
    """Every lane through the plain decoders -> (K, N) uint8 symbols."""
    from .ans_decode import decode_streams_tans_plain
    from .huffman_decode import decode_streams_plain
    S = fq.mat.shape[0]
    counts = torch.full((S,), fq.seg, dtype=torch.int32, device=fq.device)
    if fq.family == "prefix":
        dec = decode_streams_plain(fq.mat, counts, *fq.tabs,
                                   max_len=fq.tbits, max_count=fq.seg)
    else:
        dec = decode_streams_tans_plain(fq.mat, counts, *fq.tabs,
                                        table_log=fq.tbits, max_count=fq.seg)
    return dec.reshape(fq.K, fq.N).to(torch.uint8)


def fused_decode_matmul_plain(x: torch.Tensor, fq: FusedQT) -> torch.Tensor:
    """Decode, then the exact ops of ``layers.deq`` (bf16 for bf16 ``x``)
    and ``x @ w``: bit-identical to the unfused QT slot on one device."""
    from ..models.layers import QT, deq
    q = decode_lanes_plain(fq)
    return x @ deq(QT(q, fq.scale, fq.zero), x.dtype)


# ------------------------------------------------------------------- kernel

def _check(x: torch.Tensor, fq: FusedQT) -> None:
    parts = (x, fq.mat, *fq.tabs, fq.scale, fq.zero)
    for t in parts:
        if t.device != x.device:
            raise ValueError(f"fused matmul inputs on {t.device} and "
                             f"{x.device}")
        if t is not x and not t.is_contiguous():
            raise ValueError("fused matmul weights must be contiguous")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused kernel takes bf16 activations, got "
                         f"{x.dtype}")
    if x.shape[-1] != fq.K:
        raise ValueError(f"x (..., {x.shape[-1]}) does not match K={fq.K}")
    S = fq.mat.shape[0]
    if fq.mat.dtype != torch.uint8 or fq.mat.dim() != 2 \
            or S * fq.seg != fq.K * fq.N or fq.seg % fq.N:
        raise ValueError(f"misaligned {fq!r}: {S} lanes of {fq.seg} symbols "
                         f"do not tile whole rows of ({fq.K}, {fq.N})")
    if fq.mat.shape[1] >= MAX_ROW_BYTES:
        raise ValueError(f"lanes of {fq.mat.shape[1]} bytes: the kernels take "
                         f"rows under {MAX_ROW_BYTES} bytes")
    for t in fq.tabs:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError("decode tables must be 1-D int32")
    need = 1 << fq.tbits
    if fq.family == "prefix":
        if not 1 <= fq.tbits <= 24 or len(fq.tabs) != 2 \
                or any(t.numel() < need for t in fq.tabs):
            raise ValueError(f"prefix tables do not cover 2^{fq.tbits} peeks")
    elif fq.family == "tans":
        if not 1 <= fq.tbits <= 16 or len(fq.tabs) != 3 \
                or any(t.numel() != need for t in fq.tabs):
            raise ValueError(f"tANS tables must hold 2^{fq.tbits} entries")
    else:
        raise ValueError(f"unknown kernel family {fq.family!r}")
    for name, t in (("scale", fq.scale), ("zero", fq.zero)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        shape = (1,) * (2 - t.dim()) + tuple(t.shape)
        if len(shape) != 2 or shape[0] not in (1, fq.K) \
                or shape[1] not in (1, fq.N):
            raise ValueError(f"{name} {tuple(t.shape)} does not broadcast "
                             f"against ({fq.K}, {fq.N})")


def _strides(t: torch.Tensor, K: int, N: int) -> Tuple[int, int]:
    """Element strides of ``t`` broadcast to (K, N) (0 along a broadcast
    axis)."""
    t = t.reshape((1,) * (2 - t.dim()) + tuple(t.shape))
    return tuple(int(v) for v in t.expand(K, N).stride())


def table_scratch(lib, fq: FusedQT, sym_bytes: int,
                  device) -> Optional[torch.Tensor]:
    """The global-memory copy of ``fq``'s table (``2**tbits`` 8-byte
    entries) when the kernel library says it does not fit a block's shared
    memory beside a symbol tile of ``sym_bytes``, else None (the kernel
    stages the table itself)."""
    if lib.fused_table_fits_shared(fq.tbits, sym_bytes):
        return None
    return torch.empty(2 << fq.tbits, dtype=torch.int32, device=device)


def fused_decode_matmul(x: torch.Tensor, fq: FusedQT) -> torch.Tensor:
    """``x @ deq(decode(fq))`` without the dense weight in device memory.

    ``x``: (..., K); returns (..., N) in ``x.dtype``.  CUDA tensors launch
    the family's kernel on the current stream (bf16 ``x`` only); CPU tensors
    run the plain version.  A kernel block stages as many columns of its
    lane as fit ``SYM_TILE_BYTES`` (all N at 65,536-symbol segments).
    """
    if x.device.type == "cpu" and fq.device.type == "cpu":
        return fused_decode_matmul_plain(x, fq)
    if x.device.type != "cuda":
        raise ValueError(f"no fused decode matmul for device {x.device} "
                         f"(weights on {fq.device})")
    _check(x, fq)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, fq.K).contiguous()
    M = x2.shape[0]
    S = fq.mat.shape[0]
    R = fq.seg // fq.N                       # rows of K each lane holds
    nt = min(SYM_TILE_BYTES // R, fq.N)      # columns one block stages
    if nt < 1:
        raise ValueError(f"a lane of {R} rows does not fit the "
                         f"{SYM_TILE_BYTES}-byte block tile")
    out = torch.empty((M, fq.N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, fq.N)
    partial = torch.empty((S, M, fq.N), dtype=torch.float32, device=x.device)
    ss, sz = _strides(fq.scale, fq.K, fq.N), _strides(fq.zero, fq.K, fq.N)
    entry = f"fused_{fq.family}_matmul"
    lib = build.load()
    scratch = table_scratch(lib, fq, R * nt, x.device)
    stats = stats_buffer(entry, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, entry)(
            x2.data_ptr(), M, fq.K, fq.N, fq.mat.data_ptr(), fq.mat.shape[1],
            S, fq.seg, *(t.data_ptr() for t in fq.tabs), fq.tbits,
            fq.scale.data_ptr(), ss[0], ss[1], fq.zero.data_ptr(), sz[0],
            sz[1], nt, partial.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), stream)
    build.check(err, entry)
    build.count_launch(f"fused_{fq.family}")
    return out.reshape(*lead, fq.N)
