"""Canonical, length-limited Huffman coding (paper §III-B) with LUT-based decoding.

Design notes (TPU adaptation):

* The paper builds one Huffman tree from the *model-global* symbol frequency table
  (Alg. 1 line 11-12) so a single code describes every layer.  We do the same:
  :func:`global_frequencies` accumulates histograms across all quantized tensors.
* A tree-walk decoder is hostile to vector hardware, so we emit **canonical** codes and
  decode with a ``2^L_max`` lookup table: peek ``L_max`` bits, one gather yields
  (symbol, code length).  ``L_max`` defaults to 12 — small enough that the LUT
  (2 x 4096 int32 = 32 KiB) fits in one block's shared memory for the CUDA decoder, large
  enough that the length limit costs < 0.01 effective bits on any histogram we see.
* Length limiting uses the package-merge algorithm, which is *optimal* among
  length-limited prefix codes — keeping us as close to the Shannon bound as the paper's
  unlimited Huffman tree in practice.
"""
from __future__ import annotations

import heapq
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def symbol_frequencies(q: np.ndarray, num_symbols: int) -> np.ndarray:
    """Histogram of one tensor's symbols (uint8 values < num_symbols)."""
    return np.bincount(q.reshape(-1), minlength=num_symbols).astype(np.int64)


def global_frequencies(tensors: Iterable[np.ndarray], num_symbols: int) -> np.ndarray:
    """Paper Alg. 1 line 11: one frequency table across the whole model."""
    freqs = np.zeros(num_symbols, dtype=np.int64)
    for q in tensors:
        freqs += symbol_frequencies(q, num_symbols)
    return freqs


def shannon_entropy(freqs: np.ndarray) -> float:
    """Bits/symbol lower bound for any prefix code over this histogram."""
    f = freqs[freqs > 0].astype(np.float64)
    p = f / f.sum()
    return float(-(p * np.log2(p)).sum())


def huffman_code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Unlimited Huffman code lengths via the classic two-queue/heap construction."""
    sym = np.nonzero(freqs)[0]
    if len(sym) == 0:
        return np.zeros_like(freqs, dtype=np.int32)
    if len(sym) == 1:
        lengths = np.zeros(len(freqs), dtype=np.int32)
        lengths[sym[0]] = 1
        return lengths
    # heap of (freq, tiebreak, node); node = int symbol or list of symbols
    heap: List[Tuple[int, int, List[int]]] = []
    for i, s in enumerate(sym):
        heapq.heappush(heap, (int(freqs[s]), i, [int(s)]))
    tie = len(sym)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    while len(heap) > 1:
        fa, _, na = heapq.heappop(heap)
        fb, _, nb = heapq.heappop(heap)
        for s in na:
            lengths[s] += 1
        for s in nb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tie, na + nb))
        tie += 1
    return lengths


def package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Optimal length-limited code lengths (package-merge / coin-collector).

    Returns lengths (int32) with ``0 < lengths[s] <= max_len`` for every symbol with
    nonzero frequency, satisfying Kraft equality, minimizing sum(freq * length).
    """
    sym = np.nonzero(freqs)[0]
    n = len(sym)
    if n == 0:
        return np.zeros_like(freqs, dtype=np.int32)
    if n == 1:
        lengths = np.zeros(len(freqs), dtype=np.int32)
        lengths[sym[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"{n} symbols cannot fit in {max_len}-bit codes")

    # Each "coin" is (weight, set-of-symbol-indices). Level l in [1, max_len] holds coins
    # of denomination 2^-l. We must buy n-1 units of value 1 using cheapest packages.
    weights = freqs[sym].astype(np.int64)
    # items at each level: the n symbol coins
    coins = [(int(weights[i]), [i]) for i in range(n)]
    coins.sort(key=lambda c: c[0])
    packages: List[Tuple[int, List[int]]] = []
    for _level in range(max_len):
        merged = sorted(coins + packages, key=lambda c: c[0])
        # pair adjacent to form next-level packages
        packages = [
            (merged[i][0] + merged[i + 1][0], merged[i][1] + merged[i + 1][1])
            for i in range(0, len(merged) - 1, 2)
        ]
    # after max_len rounds, `packages` holds denominative value 1 coins; take n-1 cheapest
    counts = np.zeros(n, dtype=np.int64)
    for _, members in packages[: n - 1]:
        for i in members:
            counts[i] += 1
    lengths = np.zeros(len(freqs), dtype=np.int32)
    lengths[sym] = counts
    return lengths


def code_lengths(freqs: np.ndarray, max_len: int = 12) -> np.ndarray:
    """Huffman lengths, falling back to package-merge only when the limit binds."""
    lengths = huffman_code_lengths(freqs)
    if lengths.max(initial=0) <= max_len:
        return lengths
    return package_merge_lengths(freqs, max_len)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical (MSB-first) code values for the given lengths.

    Symbols sorted by (length, symbol); codes assigned sequentially.  Canonical form is
    what makes the LUT construction and the decoder kernels' bit arithmetic trivial.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    codes = np.zeros(len(lengths), dtype=np.uint32)
    order = sorted((int(l), s) for s, l in enumerate(lengths) if l > 0)
    code = 0
    prev_len = 0
    for l, s in order:
        code <<= l - prev_len
        codes[s] = code
        code += 1
        prev_len = l
    return codes


def validate_kraft(lengths: np.ndarray) -> float:
    """Kraft sum; must be <= 1 (== 1 for a complete code)."""
    l = lengths[lengths > 0]
    return float(np.sum(2.0 ** (-l.astype(np.float64))))


def effective_bits(freqs: np.ndarray, lengths: np.ndarray) -> float:
    """Average code length weighted by the histogram — the paper's 'Effective Bits'."""
    mask = freqs > 0
    total = freqs[mask].sum()
    if total == 0:
        return 0.0
    return float((freqs[mask] * lengths[mask]).sum() / total)


def build_decode_lut(lengths: np.ndarray, codes: np.ndarray, max_len: int = 12
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Build the peek-``max_len``-bits decode tables.

    ``lut_sym[peek]`` / ``lut_len[peek]`` give the decoded symbol and its true code
    length for every possible ``max_len``-bit window whose prefix is a valid code.
    """
    size = 1 << max_len
    lut_sym = np.zeros(size, dtype=np.int32)
    lut_len = np.zeros(size, dtype=np.int32)
    for s, l in enumerate(lengths):
        l = int(l)
        if l == 0:
            continue
        assert l <= max_len, (s, l, max_len)
        prefix = int(codes[s]) << (max_len - l)
        span = 1 << (max_len - l)
        lut_sym[prefix: prefix + span] = s
        lut_len[prefix: prefix + span] = l
    return lut_sym, lut_len


class HuffmanTable:
    """The model-global code: lengths + canonical codes + decode LUT (paper's H, P)."""

    def __init__(self, freqs: np.ndarray, max_len: int = 12):
        self.freqs = np.asarray(freqs, dtype=np.int64)
        self.max_len = int(max_len)
        self.lengths = code_lengths(self.freqs, max_len=self.max_len)
        self.codes = canonical_codes(self.lengths)
        self.lut_sym, self.lut_len = build_decode_lut(self.lengths, self.codes, self.max_len)

    @property
    def entropy(self) -> float:
        return shannon_entropy(self.freqs)

    @property
    def effective_bits(self) -> float:
        return effective_bits(self.freqs, self.lengths)

    def encoded_bits(self, q: np.ndarray) -> int:
        return int(self.lengths[q.reshape(-1)].sum())

    def encode(self, symbols: np.ndarray):
        """Encode flat symbols -> (guard-padded stream, payload bits) — the
        shared per-segment encode contract of :mod:`repro_torch.core.codecs`."""
        from .bitstream import encode_symbols
        return encode_symbols(symbols, self.codes, self.lengths)

    # serialization --------------------------------------------------------------
    def to_arrays(self) -> dict:
        return {"freqs": self.freqs, "max_len": np.int64(self.max_len)}

    @classmethod
    def from_arrays(cls, d: dict) -> "HuffmanTable":
        return cls(np.asarray(d["freqs"]), max_len=int(d["max_len"]))
