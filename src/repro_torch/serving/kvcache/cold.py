"""Cold tier for evicted shared KV blocks: entropy-coded host bytes
(PyTorch port of ``repro/serving/kvcache/cold.py``; numpy and stdlib only).

When the block pool runs out and the LRU victim is a *shared* prefix block
(refcount 0 — published but currently unreferenced), dropping it means the
next request with that prefix pays a full re-prefill.  With a codec
configured (``KVCompressionSpec.codec``) the block is instead entropy-coded
to host memory and revived on the next prefix hit for the price of one
serial decode — the same trade Huff-LLM makes for weights, applied to KV.

The symbol alphabet is the quantized pool's uint8 leaves (k/v codes; 256
symbols regardless of ``bits`` — 4-bit pools nibble-pack two codes per
byte, which the histogram simply sees as a 256-symbol source).  Each leaf
gets its own table built from its own histogram (mixed leaves cannot share
one histogram — the container-v2 rule).  The scale/zero leaves are tiny and
stored raw: the block manager hands the bf16 ones over as their 16-bit
patterns (int16 arrays; numpy has no bfloat16), so a raw leaf takes the
same bytes as in the JAX package.  Decoding routes on the table's *kernel
family* exactly like the weight path: ``prefix`` →
``bitstream.decode_serial``, ``tans`` → ``bitstream.decode_serial_tans``,
both on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional, Tuple

import numpy as np

from repro_torch.core import bitstream, entropy
from repro_torch.core.codecs import CodeTable, get_codec

NUM_SYMBOLS = 256   # uint8 pool leaves; nibble-packed at bits=4


@dataclasses.dataclass
class _ColdLeaf:
    """One entropy-coded uint8 leaf of a cold block."""
    stream: np.ndarray          # guard-padded byte stream
    count: int                  # symbols encoded
    shape: Tuple[int, ...]
    table: CodeTable

    @property
    def nbytes(self) -> int:
        # stream + the histogram needed to rebuild the table (int32 freqs),
        # the same accounting a serialized container would pay
        return int(self.stream.nbytes) + NUM_SYMBOLS * 4

    def decode(self) -> np.ndarray:
        arrs = self.table.decode_arrays()
        if self.table.kernel == "prefix":
            sym = bitstream.decode_serial(self.stream, self.count,
                                          arrs["lut_sym"], arrs["lut_len"],
                                          max_len=self.table.peek_bits)
        else:
            sym = bitstream.decode_serial_tans(self.stream, self.count,
                                               arrs["tab_sym"],
                                               arrs["tab_bits"],
                                               arrs["tab_base"],
                                               self.table.table_log)
        return sym.astype(np.uint8).reshape(self.shape)


def encode_block_leaves(codec, leaves: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, object], int, int]:
    """Entropy-code one block's leaves with ``codec``: uint8 code leaves get
    per-leaf tables, everything else is kept raw.  Returns ``(entry,
    encoded_symbols, payload_bits)``.  The cold tier's storage format, and
    the wire format of the JAX package's fleet handoff."""
    entry: Dict[str, object] = {}
    nsym = 0
    nbits = 0
    for name, arr in leaves.items():
        if arr.dtype == np.uint8:
            flat = arr.reshape(-1)
            freqs = entropy.symbol_frequencies(flat, NUM_SYMBOLS)
            table = codec.build(freqs, 8)
            stream, bits = table.encode(flat)
            entry[name] = _ColdLeaf(stream, flat.size, arr.shape, table)
            nsym += flat.size
            nbits += bits
        else:
            entry[name] = arr.copy()     # scale/zero: raw
    return entry, nsym, nbits


def decode_block_leaves(entry: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Invert :func:`encode_block_leaves` back to numpy pool leaves."""
    return {name: leaf.decode() if isinstance(leaf, _ColdLeaf) else leaf
            for name, leaf in entry.items()}


def entry_nbytes(entry: Dict[str, object]) -> int:
    """Host bytes one encoded entry occupies (streams + tables + raw)."""
    return sum(int(leaf.nbytes) for leaf in entry.values())


class ColdBlockStore:
    """Host-side store of evicted shared blocks, keyed by prefix-chain key.

    ``put`` entropy-codes the uint8 code leaves (per-leaf tables) and keeps
    the scale/zero leaves raw; ``pop`` decodes everything back to the numpy
    leaves the block manager writes into a fresh pool block.
    """

    def __init__(self, codec_name: str):
        self.codec = get_codec(codec_name)   # loud on unknown names
        self._entries: Dict[Hashable, Dict[str, object]] = {}
        self.encoded_symbols = 0
        self.payload_bits = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        return sum(entry_nbytes(entry) for entry in self._entries.values())

    def put(self, key: Hashable, leaves: Dict[str, np.ndarray]) -> None:
        """Store one block's per-layer leaves, e.g. k: (L, BS, KV, hs)."""
        entry, nsym, nbits = encode_block_leaves(self.codec, leaves)
        self.encoded_symbols += nsym
        self.payload_bits += nbits
        self._entries[key] = entry

    def pop(self, key: Hashable) -> Dict[str, np.ndarray]:
        return decode_block_leaves(self._entries.pop(key))

    def drop(self, key: Hashable) -> None:
        self._entries.pop(key, None)

    @property
    def effective_bits(self) -> Optional[float]:
        """Mean coded bits per pool byte, across everything ever encoded."""
        if not self.encoded_symbols:
            return None
        return self.payload_bits / self.encoded_symbols
