"""Bit-level encode / decode of entropy-coded symbol streams.

Layout: MSB-first bit order inside a byte stream (matches ``np.packbits``), each
segment's stream byte-aligned and padded with >= 4 guard bytes so a decoder can always
load a 32-bit window.

Decoding is **multi-stream**: N independent segments advance in lock-step, one symbol
per iteration, via a single gather into the code tables.  This is the TPU-native
re-interpretation of the paper's thread-parallel decoding (§III-C): the paper gives each
CPU thread one segment; we give each *vector lane* one segment (numpy / torch / CUDA all
share this structure).  Because segments hold a fixed number of SYMBOLS (not bits), every
lane finishes in exactly the same number of iterations — the LUT decoder is perfectly
load-balanced by construction, which subsumes the paper's shuffling heuristic (that
heuristic targets bit-serial decoders whose per-segment time varies with encoded bits).

Two lock-step loop families live here (DESIGN.md §7):

* ``decode_streams`` — the **prefix** family (canonical Huffman and the raw
  bit-packed baseline): peek ``max_len`` bits, gather (symbol, length),
  advance by the length.
* ``decode_streams_tans`` — the **tans** family (tANS / rANS): a carried
  per-lane state indexes (symbol, nbits, base) tables; ``nbits`` fresh bits
  are read per symbol and folded into the next state.  The 16-bit stream
  header holds the initial state.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

GUARD_BYTES = 4


def pow2_bucket(n: int, floor: int) -> int:
    """Round ``n`` up to a power of two >= floor.  Chunked decode callers
    bucket matrix shapes with this so shape-specialized
    decoders compile once per bucket instead of once per chunk geometry."""
    b = floor
    while b < n:
        b <<= 1
    return b


def pack_bit_chunks(vals: np.ndarray, nbits: np.ndarray) -> Tuple[np.ndarray, int]:
    """Concatenate variable-width bit chunks MSB-first into a guard-padded stream.

    ``vals[i]`` contributes its low ``nbits[i]`` bits (written MSB-first).
    Returns (packed uint8 stream with guard padding, total bits).  This is the
    one bit-packer every encoder shares: Huffman/raw code words and tANS
    renormalization chunks differ only in how (vals, nbits) are produced.
    """
    vals = np.asarray(vals, dtype=np.uint64).reshape(-1)
    nbits = np.asarray(nbits, dtype=np.int64).reshape(-1)
    if vals.size == 0 or int(nbits.sum()) == 0:
        return np.zeros(GUARD_BYTES, dtype=np.uint8), 0
    offs = np.concatenate([[0], np.cumsum(nbits)])
    total = int(offs[-1])
    # bit i belongs to chunk reps[i], at position bitpos[i] within it (MSB first)
    reps = np.repeat(np.arange(vals.size), nbits)
    bitpos = np.arange(total, dtype=np.int64) - offs[reps]
    bits = (vals[reps] >> (nbits[reps] - 1 - bitpos).astype(np.uint64)) & 1
    packed = np.packbits(bits.astype(np.uint8))
    packed = np.concatenate([packed, np.zeros(GUARD_BYTES, dtype=np.uint8)])
    return packed, total


def encode_symbols(symbols: np.ndarray, codes: np.ndarray, lengths: np.ndarray
                   ) -> Tuple[np.ndarray, int]:
    """Vectorized prefix-code (Huffman / raw) encode of a flat uint8 symbol array.

    Returns (packed uint8 stream with guard padding, total bits).
    """
    symbols = symbols.reshape(-1)
    if symbols.size == 0:
        return np.zeros(GUARD_BYTES, dtype=np.uint8), 0
    return pack_bit_chunks(codes[symbols], lengths[symbols])


def decode_serial(stream: np.ndarray, count: int, lut_sym: np.ndarray, lut_len: np.ndarray,
                  max_len: int) -> np.ndarray:
    """Bit-serial reference decoder (oracle for the vectorized paths)."""
    out = np.zeros(count, dtype=np.int32)
    bitpos = 0
    mask = (1 << max_len) - 1
    s = stream.astype(np.uint32)
    for k in range(count):
        byte = bitpos >> 3
        window = (int(s[byte]) << 24) | (int(s[byte + 1]) << 16) \
            | (int(s[byte + 2]) << 8) | int(s[byte + 3])
        peek = (window >> (32 - max_len - (bitpos & 7))) & mask
        out[k] = lut_sym[peek]
        bitpos += int(lut_len[peek])
    return out


def pack_streams(streams: Sequence[np.ndarray], *, min_width: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length byte streams into a (S, max_bytes) matrix + byte lengths.

    ``min_width`` lets chunked callers pad every chunk's matrix to a common
    (e.g. power-of-two) width so shape-specialized decoders reuse one compile.
    """
    lens = np.array([len(s) for s in streams], dtype=np.int64)
    width = max(int(lens.max(initial=GUARD_BYTES)), int(min_width))
    mat = np.zeros((len(streams), width), dtype=np.uint8)
    for i, s in enumerate(streams):
        mat[i, : len(s)] = s
    return mat, lens


def _decode_out(S: int, max_n: int, out: "np.ndarray | None") -> np.ndarray:
    """Resolve the output buffer of a lock-step decode: allocate when ``out``
    is None, else validate and zero a ``(S, max_n)`` view of the caller's
    preallocated buffer (the decode-into-buffer serving path — the
    compressed-resident per-layer decode reuses ONE scratch buffer instead of
    allocating per layer)."""
    if out is None:
        return np.zeros((S, max_n), dtype=np.int32)
    if out.dtype != np.int32 or out.shape[0] < S or out.shape[1] < max_n:
        raise ValueError(
            f"decode out buffer {out.dtype}{out.shape} too small for "
            f"({S}, {max_n}) int32")
    view = out[:S, :max_n]
    view[:] = 0
    return view


def decode_streams(mat: np.ndarray, counts: np.ndarray, lut_sym: np.ndarray,
                   lut_len: np.ndarray, max_len: int, *,
                   out: "np.ndarray | None" = None) -> np.ndarray:
    """Lock-step multi-stream LUT decode (numpy host path).

    mat: (S, B) uint8, each row an independent segment stream (guard-padded).
    counts: (S,) symbols per segment.  Returns (S, max(counts)) int32, rows
    zero-padded past their count.  ``out`` (optional) is a preallocated
    int32 buffer at least that big: symbols are written in place and the
    trimmed view is returned (no per-call allocation).
    """
    S = mat.shape[0]
    d = np.concatenate([mat, np.zeros((S, GUARD_BYTES), np.uint8)], axis=1).astype(np.uint32)
    max_n = int(counts.max(initial=0))
    out = _decode_out(S, max_n, out)
    bitpos = np.zeros(S, dtype=np.int64)
    rows = np.arange(S)
    mask = (1 << max_len) - 1
    for k in range(max_n):
        active = k < counts
        byte = bitpos >> 3
        window = (
            (d[rows, byte] << 24)
            | (d[rows, byte + 1] << 16)
            | (d[rows, byte + 2] << 8)
            | d[rows, byte + 3]
        )
        shift = (32 - max_len - (bitpos & 7)).astype(np.uint32)
        peek = (window >> shift) & mask
        sym = lut_sym[peek]
        out[active, k] = sym[active]
        bitpos = np.where(active, bitpos + lut_len[peek], bitpos)
    return out


TANS_STATE_HEADER_BITS = 16   # stream-leading initial decoder state (MSB-first)


def decode_serial_tans(stream: np.ndarray, count: int, tab_sym: np.ndarray,
                       tab_bits: np.ndarray, tab_base: np.ndarray,
                       table_log: int) -> np.ndarray:
    """Bit-serial tANS reference decoder (oracle for the vectorized paths).

    ``tab_*`` are the (2^table_log,) state-indexed decode tables built by
    :mod:`repro_torch.core.codecs.rans`; the stream's first 16 bits hold the
    initial state index.
    """
    out = np.zeros(count, dtype=np.int32)
    s = stream.astype(np.uint32)
    st = (int(s[0]) << 8) | int(s[1])          # 16-bit header
    bitpos = TANS_STATE_HEADER_BITS
    for k in range(count):
        out[k] = tab_sym[st]
        nb = int(tab_bits[st])
        byte = bitpos >> 3
        window = (int(s[byte]) << 24) | (int(s[byte + 1]) << 16) \
            | (int(s[byte + 2]) << 8) | int(s[byte + 3])
        peek = (window >> (32 - table_log - (bitpos & 7))) & ((1 << table_log) - 1)
        st = int(tab_base[st]) + (peek >> (table_log - nb))
        bitpos += nb
    return out


def decode_streams_tans(mat: np.ndarray, counts: np.ndarray, tab_sym: np.ndarray,
                        tab_bits: np.ndarray, tab_base: np.ndarray,
                        table_log: int, *,
                        out: "np.ndarray | None" = None) -> np.ndarray:
    """Lock-step multi-stream tANS decode (numpy host path).

    Same shape contract as :func:`decode_streams` — mat: (S, B) uint8
    guard-padded streams, counts: (S,) symbols per segment — but the gather
    target is the state-indexed (symbol, nbits, base) tables and each lane
    carries its ANS state: ``sym = tab_sym[state]``, read ``tab_bits[state]``
    fresh bits ``b``, ``state' = tab_base[state] + b``.  Lanes with zero
    counts (bucket padding) idle on state 0 harmlessly.  ``out`` is the
    same optional preallocated-buffer contract as :func:`decode_streams`.
    """
    S = mat.shape[0]
    d = np.concatenate([mat, np.zeros((S, GUARD_BYTES), np.uint8)], axis=1).astype(np.uint32)
    max_n = int(counts.max(initial=0))
    out = _decode_out(S, max_n, out)
    rows = np.arange(S)
    st = ((d[:, 0].astype(np.int64) << 8) | d[:, 1]).astype(np.int64)
    bitpos = np.full(S, TANS_STATE_HEADER_BITS, dtype=np.int64)
    mask = (1 << table_log) - 1
    for k in range(max_n):
        active = k < counts
        sym = tab_sym[st]
        nb = tab_bits[st]
        byte = bitpos >> 3
        window = (
            (d[rows, byte] << 24)
            | (d[rows, byte + 1] << 16)
            | (d[rows, byte + 2] << 8)
            | d[rows, byte + 3]
        )
        shift = (32 - table_log - (bitpos & 7)).astype(np.uint32)
        peek = (window >> shift) & mask
        fresh = peek >> (table_log - nb).astype(np.uint32)
        out[active, k] = sym[active]
        st = np.where(active, tab_base[st] + fresh, st)
        bitpos = np.where(active, bitpos + nb, bitpos)
    return out
