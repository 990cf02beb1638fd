"""Multi-stream prefix-code (canonical Huffman / raw) decode: the CUDA kernel
``prefix_decode`` of ``csrc/entropy_decode.cu`` and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/huffman_decode.py``
(``_decode_kernel`` / ``decode_streams_pallas``): every stream (one encoded
segment) advances one symbol per step by peeking ``max_len`` bits and
gathering ``(symbol, length)`` from the canonical-code lookup table.  The
``raw`` codec rides the same loop with a ``2**bits``-entry identity table.
The CUDA kernel gives each stream a block and splits it into subsequences
that resynchronise (the source's header says how); the symbols are the
same.

:func:`decode_streams` is the one entry point.  On a CUDA tensor it launches
the kernel (or raises); on a CPU tensor it runs :func:`decode_streams_plain`,
the vectorised lock-step loop over lanes with the kernel's arithmetic.
``build.launches["huffman_decode"]`` counts kernel launches only;
:func:`sync_passes` and :func:`launch_stats` read what the kernel recorded
of its last launch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core.bitstream import GUARD_BYTES
from . import build

MAX_PEEK_BITS = 24      # 32-bit window minus the 7-bit intra-byte offset
# the kernels take bit positions as 32-bit integers
MAX_ROW_BYTES = 1 << 28

# per (C entry point, device): two int64s that entry point's kernel sets at
# each launch, the largest sync-pass count of a stream (or fused lane) and
# the most SM cycles a block took
_stats: Dict[Tuple[str, torch.device], torch.Tensor] = {}

def byte_windows(mat: torch.Tensor) -> torch.Tensor:
    """(S, B) uint8 -> (S, B + 1) int64: the big-endian 32-bit window that
    starts at each byte, over the rows padded with ``GUARD_BYTES`` zeros
    (the numpy decoder's guard)."""
    d = torch.cat([mat, mat.new_zeros((mat.shape[0], GUARD_BYTES))],
                  dim=1).to(torch.int64)
    return (d[:, :-3] << 24) | (d[:, 1:-2] << 16) | (d[:, 2:-1] << 8) | d[:, 3:]


def decode_streams_plain(mat: torch.Tensor, counts: torch.Tensor,
                         lut_sym: torch.Tensor, lut_len: torch.Tensor, *,
                         max_len: int, max_count: int) -> torch.Tensor:
    """Lock-step prefix decode in plain torch ops, on ``mat``'s device.

    mat: (S, B) uint8 guard-padded streams; counts: (S,) symbols per stream.
    Returns (S, max_count) int32, zero past each stream's count.
    """
    S = mat.shape[0]
    out = torch.zeros((S, max_count), dtype=torch.int32, device=mat.device)
    if S == 0 or max_count == 0:
        return out
    win = byte_windows(mat)
    counts = counts.to(torch.int64)
    lut_sym = lut_sym.to(torch.int32)
    lut_len = lut_len.to(torch.int64)
    mask = (1 << max_len) - 1
    top = 32 - max_len
    bitpos = torch.zeros(S, dtype=torch.int64, device=mat.device)
    # every lane is active below the smallest count: no masking there
    n_all = min(int(counts.min()), max_count)
    for k in range(max_count):
        w = win.gather(1, (bitpos >> 3)[:, None])[:, 0]
        peek = (w >> (top - (bitpos & 7))) & mask
        sym = lut_sym[peek]
        ln = lut_len[peek]
        if k < n_all:
            out[:, k] = sym
            bitpos += ln
        else:
            active = k < counts
            out[:, k] = torch.where(active, sym, 0)
            bitpos = torch.where(active, bitpos + ln, bitpos)
    return out


def check_inputs(mat, counts, tables, max_count):
    if mat.dtype != torch.uint8 or mat.dim() != 2:
        raise ValueError(f"mat must be (S, B) uint8, got {mat.dtype} "
                         f"{tuple(mat.shape)}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != mat.shape[:1]:
        raise ValueError(f"counts must be ({mat.shape[0]},) int32, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    for t in (mat, counts, *tables):
        if t.device != mat.device:
            raise ValueError(f"inputs on {t.device} and {mat.device}")
        if not t.is_contiguous():
            raise ValueError("decode inputs must be contiguous")
    for t in tables:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"decode tables must be 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if max_count < 0:
        raise ValueError(f"max_count must be >= 0, got {max_count}")
    if mat.shape[1] >= MAX_ROW_BYTES:
        raise ValueError(f"rows of {mat.shape[1]} bytes: the kernels take "
                         f"rows under {MAX_ROW_BYTES} bytes")


def table_scratch(lib, log: int, device) -> "torch.Tensor | None":
    """The global-memory copy of a table of ``2**log`` 8-byte entries when
    the kernel library says it does not fit a block's shared memory, else
    None (the kernel stages the table itself)."""
    if lib.decode_table_fits_shared(log):
        return None
    return torch.empty(2 << log, dtype=torch.int32, device=device)


def stats_buffer(entry: str, device) -> torch.Tensor:
    """The two int64s the kernel of C entry point ``entry`` sets on
    ``device`` at each launch."""
    key = (entry, device)
    if key not in _stats:
        _stats[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _stats[key]


def decode_streams(mat: torch.Tensor, counts: torch.Tensor,
                   lut_sym: torch.Tensor, lut_len: torch.Tensor, *,
                   max_len: int, max_count: int) -> torch.Tensor:
    """Prefix-family decode: (S, B) uint8 streams -> (S, max_count) int32.

    A CUDA ``mat`` launches the kernel on the current stream (no
    synchronisation); a CPU ``mat`` runs the plain version.  ``counts`` is
    (S,) int32 and both tables are int32 of at least ``2**max_len``
    entries, all on ``mat``'s device.
    """
    if mat.device.type == "cpu":
        return decode_streams_plain(mat, counts, lut_sym, lut_len,
                                    max_len=max_len, max_count=max_count)
    if mat.device.type != "cuda":
        raise ValueError(f"no prefix decode for device {mat.device}")
    check_inputs(mat, counts, (lut_sym, lut_len), max_count)
    if not 1 <= max_len <= MAX_PEEK_BITS:
        raise ValueError(f"max_len must be in [1, {MAX_PEEK_BITS}], "
                         f"got {max_len}")
    if lut_sym.numel() != lut_len.numel() or lut_sym.numel() < (1 << max_len):
        raise ValueError(f"lookup tables of {lut_sym.numel()} / "
                         f"{lut_len.numel()} entries do not cover "
                         f"2^{max_len} peeks")
    S, B = mat.shape
    out = torch.empty((S, max_count), dtype=torch.int32, device=mat.device)
    if S == 0 or max_count == 0:
        return out
    lib = build.load()
    scratch = table_scratch(lib, max_len, mat.device)
    stats = stats_buffer("prefix_decode", mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = lib.prefix_decode(
            mat.data_ptr(), B, counts.data_ptr(), lut_sym.data_ptr(),
            lut_len.data_ptr(), max_len, S, max_count, out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), stream)
    build.check(err, "prefix_decode")
    build.count_launch("huffman_decode")
    return out


def launch_stats(entry: str, device) -> Tuple[int, int]:
    """(sync passes, SM cycles): the largest number of sync passes a stream
    (or fused lane) took and the most cycles a block took, in the last
    launch of the kernel of C entry point ``entry`` (``prefix_decode``,
    ``tans_decode``, ``fused_prefix_matmul`` or ``fused_tans_matmul``) on
    ``device``.  Synchronises with that launch."""
    d = torch.device(device)
    if d.index is None:
        d = torch.device(d.type, torch.cuda.current_device())
    passes, cycles = _stats[(entry, d)].tolist()
    return passes, cycles


def sync_passes(device) -> int:
    """The largest number of sync passes a stream of the last
    ``prefix_decode`` launch on ``device`` took."""
    return launch_stats("prefix_decode", device)[0]
