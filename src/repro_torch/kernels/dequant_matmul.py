"""Dequantize → matmul with a uint8 or K-packed uint4 weight: the CUDA kernel
``dequant_matmul`` of ``csrc/dequant_matmul.cu`` and its plain PyTorch
version.

Port of the TPU kernel ``src/repro/kernels/dequant_matmul.py``
(``_mm_kernel``, launched by ``dequant_matmul`` there).  It computes

    out = bf16( x_bf16 @ bf16( f32(q) * scale + zero ) )

with the dequant in float32 (the product and the sum rounded separately),
only the matmul operands in bf16, products summed in float32 and the sum
cast to bf16 once.  This is not the serving contract: ``layers.deq``
dequantizes in bf16, and no serving path calls this kernel (the JAX package
reaches it only through ``kernels/ops.py``).

The weight is (K, N) uint8 symbols, or with ``int4`` (K / 2, N) bytes
packed ALONG K: ``wq[k // 2, n]`` holds even ``k`` in the low nibble and
odd ``k`` in the high one (``ops.pack_nibbles``) — not QT4's packing along
the last axis.  ``scale`` and ``zero`` are float32 scalars or per output
channel: shape ``()``, ``(1,)``, ``(N,)`` or ``(1, N)``.

:func:`dequant_matmul` is the one entry point.  It checks its inputs, then
runs :func:`dequant_matmul_plain` for CPU tensors and launches the kernel
for CUDA tensors (or raises).  ``build.launches["dequant_matmul"]`` counts
kernel launches only.
"""
from __future__ import annotations

import torch

from . import build

MAX_GRID_Y = 65535          # CUDA's limit on the M tiles of one launch
KERNEL_BM = 64              # rows of x per M tile above 16 rows


def unpack_k(wq: torch.Tensor) -> torch.Tensor:
    """(K / 2, N) bytes packed along K -> (K, N) uint8 symbols."""
    K2, N = wq.shape
    return torch.stack([wq & 0x0F, wq >> 4], dim=1).reshape(2 * K2, N)


def dequant_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor, zero: torch.Tensor, *,
                         int4: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain torch ops, on ``x``'s device: the
    float32 dequant ``q * scale + zero`` as two roundings, a bf16 weight,
    the product of the bf16 operands summed in float32 (products of bf16
    values are exact in float32) and cast to bf16 once."""
    wsym = unpack_k(wq) if int4 else wq
    w = (wsym.float() * scale.float().reshape(1, -1)
         + zero.float().reshape(1, -1)).to(torch.bfloat16)
    return (x.to(torch.bfloat16).float() @ w.float()).to(torch.bfloat16)


def _check(x, wq, scale, zero, int4):
    if x.dim() != 2 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be (M, K) bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if wq.dim() != 2 or wq.dtype != torch.uint8:
        raise ValueError(f"wq must be 2-D uint8, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    K, N = x.shape[1], wq.shape[1]
    if int4 and K % 2:
        raise ValueError(f"an int4 weight packs K in pairs; K = {K} is odd")
    if wq.shape[0] * (2 if int4 else 1) != K:
        raise ValueError(f"wq {tuple(wq.shape)} (int4={int4}) does not "
                         f"match x (M, {K})")
    for name, t in (("scale", scale), ("zero", zero)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) not in ((), (1,), (N,), (1, N), (1, 1)):
            raise ValueError(f"{name} {tuple(t.shape)} is neither a scalar "
                             f"nor one value per output channel (N = {N})")
    for t in (wq, scale, zero):
        if t.device != x.device:
            raise ValueError(f"dequant matmul inputs on {t.device} and "
                             f"{x.device}")
    for t in (x, wq, scale, zero):
        if not t.is_contiguous():
            raise ValueError("dequant matmul inputs must be contiguous")


def dequant_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, *, int4: bool = False) -> torch.Tensor:
    """``x`` (M, K) bf16, ``wq`` (K, N) uint8 or (K / 2, N) packed uint4,
    float32 ``scale`` / ``zero`` scalars or per output channel -> (M, N)
    bf16.

    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors run the plain version.
    """
    _check(x, wq, scale, zero, int4)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, wq, scale, zero, int4=int4)
    if x.device.type != "cuda":
        raise ValueError(f"no dequant matmul for device {x.device}")
    M, K = x.shape
    N = wq.shape[1]
    if -(-M // KERNEL_BM) > MAX_GRID_Y:
        raise ValueError(f"M = {M} exceeds the kernel's "
                         f"{MAX_GRID_Y * KERNEL_BM} rows")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out
    ssn = 1 if scale.numel() > 1 else 0
    szn = 1 if zero.numel() > 1 else 0
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dequant_matmul(
            x.data_ptr(), M, K, N, wq.data_ptr(), int(int4),
            scale.data_ptr(), ssn, zero.data_ptr(), szn, out.data_ptr(),
            stream)
    build.check(err, "dequant_matmul")
    build.count_launch("dequant_matmul")
    return out
