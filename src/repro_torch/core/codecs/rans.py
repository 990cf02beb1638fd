"""``rans`` codec: table-based asymmetric numeral system (tANS / FSE-style).

Why a second entropy coder (DESIGN.md §7): Huffman assigns an *integer*
number of bits per symbol, so its redundancy vs. the Shannon bound grows as
the histogram gets peaky — exactly the regime EntroLLM quantization produces
(and the regime Huff-LLM / Shannon-bound followup work targets).  tANS codes
at *fractional* bits per symbol: its redundancy is the KL divergence between
the true histogram and the table-normalized one, ~``O(1/L)`` for an
``L``-state table, plus a 16-bit per-segment state header.

Construction (the classic FSE recipe, built deterministically from the raw
histogram so the container only ships frequencies, like Huffman):

1. **Normalize** the histogram to sum exactly ``L = 2**table_log`` with every
   present symbol >= 1 slot, greedily minimizing KL cost per slot moved.
2. **Spread** each symbol's slots over the state table with the odd-stride
   walk ``pos += (L>>1) + (L>>3) + 3  (mod L)``.
3. **Decode tables** — for state ``x`` (index in ``[0, L)``), the slot's
   symbol, its occurrence rank gives ``x_sub ∈ [n_s, 2·n_s)``, and
   ``nbits = table_log - floor(log2(x_sub))`` renormalizes:
   ``state' = (x_sub << nbits) - L + read_bits(nbits)``.
4. **Encode table** — the inverse map, walked symbol-by-symbol in *reverse*
   order (ANS is LIFO); emitted bit chunks are flushed in forward order so
   the decoder streams MSB-first like every other codec here.

Decoding is one more lock-step loop family (``kernel = "tans"``): per lane,
gather (symbol, nbits, base) by carried state, read ``nbits`` fresh bits,
fold into the next state — structurally the Huffman peek-LUT loop with one
extra carried register, which is why all three backends (numpy / torch /
CUDA) host it next to their prefix loops.  Encoding is state-serial along
a segment (inherent to ANS), with a tensor's segments advanced in lock-step
(:meth:`RansCodeTable.encode_rows`), and runs on the host at container-build
time only.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..bitstream import GUARD_BYTES, TANS_STATE_HEADER_BITS, pack_bit_chunks
from .base import CodeTable

# lock-step encode: how many segments advance together, the fewest for
# which that beats the scalar loop, and how many steps' symbol constants
# are gathered at once
LOCKSTEP_LANES = 256
LOCKSTEP_MIN_LANES = 32
LOCKSTEP_BLOCK = 1024

# 4096 states for 8-bit symbols (the Huffman LUT's footprint class), 1024 for
# 4-bit — normalization error is already far below Huffman's integer-bit loss
DEFAULT_TABLE_LOG_CAP = 12


def default_table_log(bits: int) -> int:
    return min(DEFAULT_TABLE_LOG_CAP, bits + 6)


def normalize_freqs(freqs: np.ndarray, table_log: int) -> np.ndarray:
    """Scale a histogram to sum exactly ``2**table_log``.

    Every symbol with nonzero frequency keeps >= 1 slot (losslessness), and
    the residual slots are moved one at a time to the symbol where the move
    costs/gains the least KL — the per-slot greedy is optimal for this
    separable convex objective.
    """
    L = 1 << table_log
    f = np.asarray(freqs, dtype=np.int64)
    nz = np.nonzero(f)[0]
    if len(nz) == 0:
        raise ValueError("cannot build a tANS table from an empty histogram")
    if len(nz) > L:
        raise ValueError(f"{len(nz)} symbols cannot fit {L} tANS states")
    w = f[nz].astype(np.float64)
    n = np.maximum(1, np.rint(w * L / w.sum())).astype(np.int64)
    diff = L - int(n.sum())
    while diff != 0:
        if diff > 0:
            gain = w * np.log2((n + 1) / n)
            i = int(np.argmax(gain))
            n[i] += 1
            diff -= 1
        else:
            cost = np.where(n > 1, w * np.log2(n / np.maximum(n - 1, 1)), np.inf)
            i = int(np.argmin(cost))
            n[i] -= 1
            diff += 1
    norm = np.zeros_like(f)
    norm[nz] = n
    return norm


def build_tans_tables(norm: np.ndarray, table_log: int) -> Dict[str, np.ndarray]:
    """Spread + decode/encode tables from a normalized histogram."""
    L = 1 << table_log
    assert int(norm.sum()) == L, (int(norm.sum()), L)
    step = (L >> 1) + (L >> 3) + 3          # odd => coprime with L
    if step % 2 == 0:
        # L=2 and L=8 make the stride even (shares factor 2 with L): the
        # walk would revisit states and leave others uninitialized
        raise ValueError(f"table_log={table_log} too small for the spread "
                         f"stride; use table_log >= 4")
    spread = np.empty(L, dtype=np.int32)
    pos = 0
    for s in np.nonzero(norm)[0]:
        for _ in range(int(norm[s])):
            spread[pos] = s
            pos = (pos + step) & (L - 1)
    assert pos == 0                          # full cycle covers every state

    cumul = np.zeros(len(norm) + 1, dtype=np.int64)
    cumul[1:] = np.cumsum(norm)
    tab_bits = np.empty(L, dtype=np.int32)
    tab_base = np.empty(L, dtype=np.int32)
    enc_state = np.empty(L, dtype=np.int64)
    occ = np.zeros(len(norm), dtype=np.int64)
    for i in range(L):
        s = int(spread[i])
        x_sub = int(norm[s] + occ[s])        # in [norm_s, 2*norm_s)
        occ[s] += 1
        nb = table_log - x_sub.bit_length() + 1
        tab_bits[i] = nb
        tab_base[i] = (x_sub << nb) - L
        enc_state[cumul[s] + x_sub - norm[s]] = i
    return {"tab_sym": spread, "tab_bits": tab_bits, "tab_base": tab_base,
            "enc_state": enc_state, "cumul": cumul}


class RansCodeTable(CodeTable):
    codec_name = "rans"
    kernel = "tans"

    def __init__(self, freqs: np.ndarray, bits: int, table_log: int = None):
        self.bits = int(bits)
        self.freqs = np.asarray(freqs, dtype=np.int64)
        self.table_log = int(table_log if table_log is not None
                             else default_table_log(self.bits))
        if self.table_log > TANS_STATE_HEADER_BITS:
            # the initial decoder state ships in a fixed 16-bit stream
            # header; a larger state space would truncate silently
            raise ValueError(
                f"table_log={self.table_log} exceeds the "
                f"{TANS_STATE_HEADER_BITS}-bit stream state header")
        self.norm = normalize_freqs(self.freqs, self.table_log)
        t = build_tans_tables(self.norm, self.table_log)
        self.tab_sym = t["tab_sym"]
        self.tab_bits = t["tab_bits"]
        self.tab_base = t["tab_base"]
        self._enc_state = t["enc_state"]
        self._cumul = t["cumul"]
        # per-symbol encode constants: nbits = maxbits - (x < min_state_plus)
        safe = np.maximum(self.norm, 1)
        self._maxbits = np.array(
            [self.table_log - (int(v).bit_length() - 1) for v in safe],
            dtype=np.int64)
        self._min_state_plus = safe << self._maxbits

    # ----------------------------------------------------------------- encode
    def encode(self, symbols: np.ndarray) -> Tuple[np.ndarray, int]:
        """State-serial reverse-order tANS encode of one segment.

        Stream layout: 16-bit initial decoder state, then per-symbol
        renormalization chunks in decode order, MSB-first, guard-padded.
        """
        symbols = np.asarray(symbols, dtype=np.uint8).reshape(-1)
        if symbols.size == 0:
            return np.zeros(GUARD_BYTES, dtype=np.uint8), 0
        L = 1 << self.table_log
        # plain-int lists: the state feedback loop is scalar, and Python ints
        # beat numpy scalar ops ~5x here
        enc_state = self._enc_state.tolist()
        cumul = self._cumul.tolist()
        norm = self.norm.tolist()
        maxbits = self._maxbits.tolist()
        msp = self._min_state_plus.tolist()
        x = L
        vals = np.empty(symbols.size + 1, dtype=np.uint64)
        nbs = np.empty(symbols.size + 1, dtype=np.int64)
        j = symbols.size
        for s in symbols[::-1].tolist():
            nb = maxbits[s] - (1 if x < msp[s] else 0)
            vals[j] = x & ((1 << nb) - 1)
            nbs[j] = nb
            x_sub = x >> nb
            x = L + enc_state[cumul[s] + x_sub - norm[s]]
            j -= 1
        vals[0] = x - L                       # initial decoder state
        nbs[0] = TANS_STATE_HEADER_BITS
        stream, total = pack_bit_chunks(vals, nbs)
        return stream, total

    def encode_rows(self, rows: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        """:meth:`encode` of each row of ``rows`` (R, m) uint8, a segment
        each.  Rows advance in lock-step, ``LOCKSTEP_LANES`` at a time: one
        numpy step moves every lane's state by a symbol (the state feedback
        is serial along a segment, never across segments).  Bitwise the
        streams :meth:`encode` gives."""
        rows = np.asarray(rows, dtype=np.uint8)
        if rows.shape[0] < LOCKSTEP_MIN_LANES or rows.shape[1] == 0:
            return [self.encode(r) for r in rows]
        out: List[Tuple[np.ndarray, int]] = []
        for lo in range(0, rows.shape[0], LOCKSTEP_LANES):
            out += self._encode_lanes(rows[lo: lo + LOCKSTEP_LANES])
        return out

    def _encode_lanes(self, lanes: np.ndarray) -> List[Tuple[np.ndarray, int]]:
        """Reverse-order tANS encode of each row of ``lanes`` (B, m) uint8,
        all rows in lock-step."""
        B, m = lanes.shape
        L = 1 << self.table_log
        base = self._cumul[: self.norm.size] - self.norm
        next_state = self._enc_state.astype(np.int64) + L
        low_mask = (1 << np.arange(TANS_STATE_HEADER_BITS + 1,
                                   dtype=np.int64)) - 1
        # row t: each lane's symbol m - 1 - t (the encode walks back)
        rev = lanes[:, ::-1].T
        # a chunk is at most table_log (<= 16) bits wide
        vals = np.empty((m + 1, B), dtype=np.int32)
        nbs = np.empty((m + 1, B), dtype=np.int8)
        x = np.full(B, L, dtype=np.int64)
        for t0 in range(0, m, LOCKSTEP_BLOCK):
            # the block's symbols' constants, gathered ahead of its steps
            block = rev[t0: t0 + LOCKSTEP_BLOCK].astype(np.intp)
            maxbits = self._maxbits[block]
            msp = self._min_state_plus[block]
            sbase = base[block]
            for t in range(block.shape[0]):
                nb = maxbits[t] - (x < msp[t])
                j = m - t0 - t
                vals[j] = x & low_mask.take(nb)
                nbs[j] = nb
                x = next_state.take(sbase[t] + (x >> nb))
        vals[0] = x - L                       # initial decoder states
        nbs[0] = TANS_STATE_HEADER_BITS
        return [pack_bit_chunks(v, n) for v, n in
                zip(np.ascontiguousarray(vals.T), np.ascontiguousarray(nbs.T))]

    # ----------------------------------------------------------------- decode
    def decode_arrays(self) -> Dict[str, np.ndarray]:
        return {"tab_sym": self.tab_sym, "tab_bits": self.tab_bits,
                "tab_base": self.tab_base}

    @property
    def effective_bits(self) -> float:
        """Cross-entropy of the true histogram against the normalized table —
        the asymptotic tANS rate (headers excluded; stats report achieved)."""
        mask = self.freqs > 0
        p = self.freqs[mask].astype(np.float64)
        p /= p.sum()
        q = self.norm[mask].astype(np.float64) / (1 << self.table_log)
        return float(-(p * np.log2(q)).sum())

    # -------------------------------------------------------------- serialize
    def to_manifest(self) -> dict:
        return {"codec": self.codec_name, "bits": self.bits,
                "table_log": self.table_log}

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"freqs": self.freqs}

    @classmethod
    def from_container(cls, manifest: dict,
                       arrays: Dict[str, np.ndarray]) -> "RansCodeTable":
        return cls(arrays["freqs"], bits=int(manifest["bits"]),
                   table_log=int(manifest["table_log"]))


def build(freqs: np.ndarray, bits: int, *, table_log: int = None,
          **_kw) -> RansCodeTable:
    return RansCodeTable(freqs, bits, table_log=table_log)
