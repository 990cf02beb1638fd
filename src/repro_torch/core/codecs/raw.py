"""``raw`` codec: fixed-width bit packing, the no-entropy-coding baseline.

Every symbol is stored in exactly ``bits`` bits.  Implemented as a degenerate
*prefix* code — all code lengths equal ``bits`` and the canonical code values
are the symbols themselves — so raw containers decode through the very same
LUT kernels as Huffman on every backend, with a ``2**bits``-entry identity
LUT.  This is the "quantized only" row of the paper's Table I: achieved bits
== ``bits`` by construction, making the entropy-coded savings of ``huffman``
and ``rans`` directly measurable against it (DESIGN.md §7).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..bitstream import encode_symbols
from ..entropy import build_decode_lut
from .base import CodeTable


class RawCodeTable(CodeTable):
    codec_name = "raw"
    kernel = "prefix"

    def __init__(self, freqs: np.ndarray, bits: int):
        self.bits = int(bits)
        self.freqs = np.asarray(freqs, dtype=np.int64)
        n = 1 << self.bits
        assert self.freqs.size == n, (self.freqs.size, n)
        self.lengths = np.full(n, self.bits, dtype=np.int32)
        self.codes = np.arange(n, dtype=np.uint32)   # canonical == identity
        self.lut_sym, self.lut_len = build_decode_lut(
            self.lengths, self.codes, max_len=self.bits)

    @property
    def peek_bits(self) -> int:
        return self.bits

    def encode(self, symbols: np.ndarray):
        return encode_symbols(symbols, self.codes, self.lengths)

    def decode_arrays(self) -> Dict[str, np.ndarray]:
        return {"lut_sym": self.lut_sym, "lut_len": self.lut_len}

    @property
    def effective_bits(self) -> float:
        return float(self.bits)

    def to_manifest(self) -> dict:
        return {"codec": self.codec_name, "bits": self.bits}

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"freqs": self.freqs}

    @classmethod
    def from_container(cls, manifest: dict,
                       arrays: Dict[str, np.ndarray]) -> "RawCodeTable":
        return cls(arrays["freqs"], bits=int(manifest["bits"]))


def build(freqs: np.ndarray, bits: int, **_kw) -> RawCodeTable:
    return RawCodeTable(freqs, bits)
