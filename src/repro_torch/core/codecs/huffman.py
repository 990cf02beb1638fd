"""``huffman`` codec: the paper's canonical length-limited Huffman path.

A thin :class:`~repro_torch.core.codecs.base.CodeTable` adapter over
:class:`repro_torch.core.entropy.HuffmanTable` — the code construction
(package-merge length limiting, canonical codes, peek-LUT) is unchanged from
the paper reproduction; this module only gives it the pluggable-codec shape
(DESIGN.md §7) so it can sit beside ``rans`` and ``raw`` in a v2 container.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..entropy import HuffmanTable
from .base import CodeTable

DEFAULT_MAX_CODE_LEN = 12


class HuffmanCodeTable(CodeTable):
    codec_name = "huffman"
    kernel = "prefix"

    def __init__(self, freqs: np.ndarray, bits: int,
                 max_len: int = DEFAULT_MAX_CODE_LEN):
        self.bits = int(bits)
        self.table = HuffmanTable(np.asarray(freqs, dtype=np.int64),
                                  max_len=max_len)
        self.freqs = self.table.freqs

    # legacy peek width: the prefix kernels window this many bits per symbol
    @property
    def peek_bits(self) -> int:
        return self.table.max_len

    def encode(self, symbols: np.ndarray):
        return self.table.encode(symbols)

    def decode_arrays(self) -> Dict[str, np.ndarray]:
        return {"lut_sym": self.table.lut_sym, "lut_len": self.table.lut_len}

    @property
    def effective_bits(self) -> float:
        return self.table.effective_bits

    def to_manifest(self) -> dict:
        return {"codec": self.codec_name, "bits": self.bits,
                "max_len": self.table.max_len}

    def to_arrays(self) -> Dict[str, np.ndarray]:
        return {"freqs": self.freqs}

    @classmethod
    def from_container(cls, manifest: dict,
                       arrays: Dict[str, np.ndarray]) -> "HuffmanCodeTable":
        return cls(arrays["freqs"], bits=int(manifest["bits"]),
                   max_len=int(manifest["max_len"]))


def build(freqs: np.ndarray, bits: int, *,
          max_code_len: int = DEFAULT_MAX_CODE_LEN) -> HuffmanCodeTable:
    return HuffmanCodeTable(freqs, bits, max_len=max_code_len)
