"""CodeTable: the contract every entropy codec's table satisfies.

A *codec* (``huffman`` / ``rans`` / ``raw``; see the registry in
``repro_torch.core.codecs``) builds a :class:`CodeTable` from a symbol histogram.
The table owns both directions of the transform for one group of tensors
(one ``(codec, bits)`` group in a container — DESIGN.md §7):

* ``encode(symbols)`` — one flat uint8 symbol array to one guard-padded byte
  stream (the per-segment unit of ``core.segmentation``).
* ``decode_arrays()`` + ``kernel`` — the lookup tables and the *kernel
  family* name a :class:`repro_torch.core.decode_backends.DecoderBackend` needs to
  run the matching lock-step multi-stream decode loop.  Two families exist:
  ``"prefix"`` (peek ``peek_bits``, gather (symbol, length) — Huffman and the
  raw bit-packed baseline) and ``"tans"`` (carried per-lane state, gather
  (symbol, nbits, base) — the tANS coder).

Tables serialize as (JSON scalars, numpy arrays) pairs and must rebuild
*deterministically* from them — the container stores histograms, never code
words, exactly like the paper ships only its frequency table.
"""
from __future__ import annotations

import abc
from typing import Dict, Tuple

import numpy as np


class CodeTable(abc.ABC):
    """One codec's built code table for one symbol alphabet.

    Attributes (set by subclasses):
      codec_name: registry name of the codec that built this table.
      kernel: decode-kernel family, ``"prefix"`` or ``"tans"``.
      bits: symbol bit-width this table covers (alphabet = ``2**bits``).
      freqs: (2**bits,) int64 histogram the table was built from.
    """

    codec_name: str
    kernel: str
    bits: int
    freqs: np.ndarray

    @property
    def num_symbols(self) -> int:
        return 1 << self.bits

    # ----------------------------------------------------------------- encode
    @abc.abstractmethod
    def encode(self, symbols: np.ndarray) -> Tuple[np.ndarray, int]:
        """Encode flat uint8 symbols -> (guard-padded uint8 stream, payload bits)."""

    # ----------------------------------------------------------------- decode
    @abc.abstractmethod
    def decode_arrays(self) -> Dict[str, np.ndarray]:
        """The lookup arrays the ``kernel`` family's decode loop gathers from."""

    # ------------------------------------------------------------------ rates
    @property
    def entropy(self) -> float:
        from ..entropy import shannon_entropy
        return shannon_entropy(self.freqs)

    @property
    @abc.abstractmethod
    def effective_bits(self) -> float:
        """Expected bits/symbol under this table (the paper's 'Effective Bits');
        container stats report the *achieved* payload bits separately."""

    # -------------------------------------------------------------- serialize
    @abc.abstractmethod
    def to_manifest(self) -> dict:
        """JSON-scalar parameters (codec name included) for the container manifest."""

    @abc.abstractmethod
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Numpy arrays to store alongside the manifest entry."""
