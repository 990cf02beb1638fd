"""Multi-stream tANS decode: the CUDA kernel ``tans_decode`` of
``csrc/entropy_decode.cu`` and its plain PyTorch version.

Port of the TPU kernel ``src/repro/kernels/ans_decode.py`` (``_tans_kernel``
/ ``decode_streams_tans_pallas``): the ``tans`` twin of
:mod:`repro_torch.kernels.huffman_decode`, where a carried per-lane ANS
state indexes the (symbol, nbits, base) tables (the CUDA kernel runs each
stream's chain in a block of its own)::

    sym   = tab_sym[state]
    nb    = tab_bits[state]
    fresh = top nb bits of the table_log-bit window at bitpos
    state = tab_base[state] + fresh;  bitpos += nb

Streams begin with the 16-bit initial-state header
(``bitstream.TANS_STATE_HEADER_BITS``).  :func:`decode_streams_tans`
launches the kernel on a CUDA tensor (or raises) and runs
:func:`decode_streams_tans_plain` on a CPU tensor;
``build.launches["ans_decode"]`` counts kernel launches only, and
``huffman_decode.launch_stats("tans_decode", device)`` reads the cycles the
last launch's longest block took.
"""
from __future__ import annotations

import torch

from ..core.bitstream import TANS_STATE_HEADER_BITS
from . import build
from .huffman_decode import (byte_windows, check_inputs, stats_buffer,
                             table_scratch)

def decode_streams_tans_plain(mat: torch.Tensor, counts: torch.Tensor,
                              tab_sym: torch.Tensor, tab_bits: torch.Tensor,
                              tab_base: torch.Tensor, *, table_log: int,
                              max_count: int) -> torch.Tensor:
    """Lock-step tANS decode in plain torch ops, on ``mat``'s device.

    mat: (S, B) uint8 guard-padded streams (headers included); counts: (S,)
    symbols per stream.  Returns (S, max_count) int32, zero past each
    stream's count.
    """
    S = mat.shape[0]
    out = torch.zeros((S, max_count), dtype=torch.int32, device=mat.device)
    if S == 0 or max_count == 0:
        return out
    win = byte_windows(mat)
    counts = counts.to(torch.int64)
    tab_sym = tab_sym.to(torch.int32)
    tab_bits = tab_bits.to(torch.int64)
    tab_base = tab_base.to(torch.int64)
    mask = (1 << table_log) - 1
    top = 32 - table_log
    st = win[:, 0] >> 16
    bitpos = torch.full((S,), TANS_STATE_HEADER_BITS, dtype=torch.int64,
                        device=mat.device)
    n_all = min(int(counts.min()), max_count)
    for k in range(max_count):
        sym = tab_sym[st]
        nb = tab_bits[st]
        w = win.gather(1, (bitpos >> 3)[:, None])[:, 0]
        peek = (w >> (top - (bitpos & 7))) & mask
        fresh = peek >> (table_log - nb)
        if k < n_all:
            out[:, k] = sym
            st = tab_base[st] + fresh
            bitpos += nb
        else:
            active = k < counts
            out[:, k] = torch.where(active, sym, 0)
            st = torch.where(active, tab_base[st] + fresh, st)
            bitpos = torch.where(active, bitpos + nb, bitpos)
    return out


def decode_streams_tans(mat: torch.Tensor, counts: torch.Tensor,
                        tab_sym: torch.Tensor, tab_bits: torch.Tensor,
                        tab_base: torch.Tensor, *, table_log: int,
                        max_count: int) -> torch.Tensor:
    """tANS-family decode: (S, B) uint8 streams -> (S, max_count) int32.

    A CUDA ``mat`` launches the kernel on the current stream (no
    synchronisation); a CPU ``mat`` runs the plain version.  ``counts`` is
    (S,) int32 and the three tables are int32 of ``2**table_log`` entries,
    all on ``mat``'s device.
    """
    if mat.device.type == "cpu":
        return decode_streams_tans_plain(mat, counts, tab_sym, tab_bits,
                                         tab_base, table_log=table_log,
                                         max_count=max_count)
    if mat.device.type != "cuda":
        raise ValueError(f"no tANS decode for device {mat.device}")
    tables = (tab_sym, tab_bits, tab_base)
    check_inputs(mat, counts, tables, max_count)
    if not 1 <= table_log <= TANS_STATE_HEADER_BITS:
        raise ValueError(f"table_log must be in [1, {TANS_STATE_HEADER_BITS}]"
                         f", got {table_log}")
    if any(t.numel() != 1 << table_log for t in tables):
        raise ValueError(f"tANS tables must hold 2^{table_log} entries, got "
                         f"{[t.numel() for t in tables]}")
    S, B = mat.shape
    out = torch.empty((S, max_count), dtype=torch.int32, device=mat.device)
    if S == 0 or max_count == 0:
        return out
    lib = build.load()
    scratch = table_scratch(lib, table_log, mat.device)
    stats = stats_buffer("tans_decode", mat.device)
    with torch.cuda.device(mat.device):
        stream = torch.cuda.current_stream(mat.device).cuda_stream
        err = lib.tans_decode(
            mat.data_ptr(), B, counts.data_ptr(), tab_sym.data_ptr(),
            tab_bits.data_ptr(), tab_base.data_ptr(), table_log, S,
            max_count, out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            stats.data_ptr(), stream)
    build.check(err, "tans_decode")
    build.count_launch("ans_decode")
    return out
