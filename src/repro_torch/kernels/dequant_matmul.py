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
kernel launches only, and :func:`launch_plan` gives the plan of a device's
last launch.

:func:`plan` chooses each launch on the host, from the shape and the
operands' alignment alone: the kernel's ``ring`` variant (16-byte copies
into a ring of stages in shared memory) wherever rows and addresses are
16-byte multiples, else its ``edge`` variant; the rows of a tile (16 at a
decode step; above, 16, 64 or 128 by the weight's size); and a split of K
across blocks when the output has too few tiles to fill the card, whose
float32 partials go to a workspace and are summed in split order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

from . import build

MAX_GRID_Y = 65535          # CUDA's limit on the M tiles of one launch
KERNEL_BM = 64              # the edge variant's rows of x above 16 rows

# the ring variant's tile (csrc/dequant_matmul.cu, namespace ring)
RING_BN = 128               # output columns a block
BK = 64                     # K a stage; a split is whole stages
RING_BM = (16, 64, 128)     # rows of x a block
# what the split aims at on the H100's 132 SMs: two blocks an SM, but no
# block with less than 8 KiB of weight (its time is then latency, not
# bytes); and the block that adds a tile's partials reads at most 192 KiB
# of the others' (one block alone: ~2 us)
MIN_BLOCKS = 264
MIN_SPLIT_BYTES = 8 << 10
MAX_FIXUP_BYTES = 192 << 10
# above 16 rows each M tile dequantizes the whole weight again: 16-row
# tiles while that stays under 2^25 weights (~5 us of the card's scalar
# rate at 5 instructions a weight), else 64, else 128; and 128 whenever
# the 128-row tiles alone number one an SM (lm_head's 1,188)
MAX_DEQUANT = 1 << 25
VARIANTS = {"edge": 0, "ring": 1}


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel.  ``splits`` blocks share each output
    tile's K, ``k_per_split`` each (whole ``bk`` stages; the last split
    takes what is left); ``workspace_bytes`` of float32 partials
    (splits x M x N) when ``splits`` > 1."""
    variant: str
    bm: int
    bn: int
    bk: int
    splits: int
    k_per_split: int
    tiles: int
    workspace_bytes: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_ranges(self, K: int):
        """The [k0, k1) range of K each split sums, in split order."""
        return [(q * self.k_per_split, min(K, (q + 1) * self.k_per_split))
                for q in range(self.splits)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# a pure function of its arguments: a shape is planned once
@functools.lru_cache(maxsize=256)
def plan(M: int, K: int, N: int, *, int4: bool, aligned: bool = True,
         bm: Optional[int] = None) -> Plan:
    """The launch for x (M, K) and a weight of N columns.  ``aligned``:
    x, the weight and the output start on 16-byte boundaries.  ``bm``
    forces the ring variant's rows a tile (16, 64 or 128).

    The ring variant takes N % 16 == 0 and K % 8 == 0 (rows of whole
    16-byte copies) at aligned addresses; any other shape or address goes
    to the edge variant, which takes everything, unsplit.  The ring's rows
    a tile: 16 for M <= 16; above, 128 when the 128-row tiles number at
    least MIN_BLOCKS / 2, else the fewest rows whose redundant dequant
    (ceil(M / bm) x K x N weights) stays within :data:`MAX_DEQUANT`.  The
    ring splits K when the tiles number fewer than :data:`MIN_BLOCKS`:
    into enough splits for that many blocks, unless a split would hold
    less than :data:`MIN_SPLIT_BYTES` of weight or the tile's last block
    would read more than :data:`MAX_FIXUP_BYTES` of the other splits'
    partials."""
    if not (aligned and N % 16 == 0 and K % 8 == 0):
        ebm, ebn = (16, 32) if M <= 16 else (KERNEL_BM, 64)
        return Plan("edge", ebm, ebn, BK, 1, max(K, 1),
                    _cdiv(M, ebm) * _cdiv(N, ebn), 0)
    if bm is None:
        if M <= RING_BM[0]:
            bm = RING_BM[0]
        elif _cdiv(M, 128) * _cdiv(N, RING_BN) >= MIN_BLOCKS // 2:
            bm = RING_BM[-1]
        else:
            bm = next((b for b in RING_BM
                       if _cdiv(M, b) * K * N <= MAX_DEQUANT), RING_BM[-1])
    tiles = _cdiv(M, bm) * _cdiv(N, RING_BN)
    stages = _cdiv(K, BK)
    per_stage = (BK // 2 if int4 else BK) * min(N, RING_BN)   # weight bytes
    max_splits = 1 + MAX_FIXUP_BYTES // (min(M, bm) * RING_BN * 4)
    sps = max(stages, 1)                                  # stages a split
    if tiles < MIN_BLOCKS and stages > 1:
        sps = max(stages // _cdiv(MIN_BLOCKS, tiles),
                  _cdiv(MIN_SPLIT_BYTES, per_stage),
                  _cdiv(stages, max_splits), 1)
        sps = min(sps, stages)
    splits = _cdiv(stages, sps) if stages else 1
    return Plan("ring", bm, RING_BN, BK, splits, sps * BK, tiles,
                4 * splits * M * N if splits > 1 else 0)


def plan_for(x: torch.Tensor, wq: torch.Tensor, *, int4: bool) -> Plan:
    """:func:`plan` for these operands (the output, fresh from the
    allocator, is aligned)."""
    M, K = x.shape
    aligned = x.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    return plan(M, K, wq.shape[1], int4=int4, aligned=aligned)


# the plan of each device's last launch
_launched: Dict[torch.device, Plan] = {}


def launch_plan(device) -> Optional[Plan]:
    """The plan the kernel last launched with on ``device`` (None before
    the first launch there)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device(d.type, torch.cuda.current_device())
    return _launched.get(d)


# one zeroed ticket buffer per (device, stream): the kernel's last block of
# a tile resets its ticket, and launches on one stream run in order
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf


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
    synchronisation) as :func:`plan_for` plans it; CPU tensors run the
    plain version.
    """
    _check(x, wq, scale, zero, int4)
    if x.device.type == "cpu":
        return dequant_matmul_plain(x, wq, scale, zero, int4=int4)
    if x.device.type != "cuda":
        raise ValueError(f"no dequant matmul for device {x.device}")
    if x.shape[0] == 0 or wq.shape[1] == 0:
        return torch.empty((x.shape[0], wq.shape[1]), dtype=torch.bfloat16,
                           device=x.device)
    return _launch(x, wq, scale, zero, int4, plan_for(x, wq, int4=int4))


def _launch(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
            zero: torch.Tensor, int4: bool, p: Plan) -> torch.Tensor:
    """Launch the kernel on checked, non-empty CUDA operands as ``p``
    says (tests run both variants, every tile height and other splits on
    the same inputs through here).  The kernel refuses a plan it cannot
    run, and the call raises."""
    M, K = x.shape
    N = wq.shape[1]
    if -(-M // KERNEL_BM) > MAX_GRID_Y:
        raise ValueError(f"M = {M} exceeds the kernel's "
                         f"{MAX_GRID_Y * KERNEL_BM} rows")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ssn = 1 if scale.numel() > 1 else 0
    szn = 1 if zero.numel() > 1 else 0
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        partial = tickets = None
        if p.splits > 1:
            partial = torch.empty(p.workspace_bytes // 4,
                                  dtype=torch.float32, device=x.device)
            tickets = _ticket_buffer(x.device, stream, p.tiles)
        err = lib.dequant_matmul(
            x.data_ptr(), M, K, N, wq.data_ptr(), int(int4),
            scale.data_ptr(), ssn, zero.data_ptr(), szn, out.data_ptr(),
            VARIANTS[p.variant], p.bm, p.splits, p.k_per_split,
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), stream)
    build.check(err, "dequant_matmul")
    build.count_launch("dequant_matmul")
    _launched[x.device] = p
    return out
