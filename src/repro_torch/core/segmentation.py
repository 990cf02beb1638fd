"""Parameter-space segmentation for parallel decoding (paper §III-C).

The paper preserves the weight tensors' packing structure so every encoded chunk's
start/end is known in advance, making chunks independently decodable.  We keep that
exactly, with one pod-scale refinement: segment boundaries are chosen to *nest inside
shard boundaries*, so a device that owns rows ``[a, b)`` of a TP/FSDP-sharded tensor can
decode its shard from a contiguous run of segments without touching any other device's
bytes — the paper's "independent segments across threads" lifted to SPMD across chips.

Every segment holds exactly ``segment_symbols`` symbols (except tensor-final tails),
so the lock-step LUT decoder is load-balanced by construction; the byte-size imbalance
the paper counteracts with shuffling only affects *storage* locality, for which
:func:`balanced_assignment` provides the paper's longest-first shuffle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_SEGMENT_SYMBOLS = 64 * 1024


@dataclasses.dataclass
class SegmentedTensor:
    """One tensor's encoded segments (byte offsets into the container buffer)."""

    name: str
    shape: Tuple[int, ...]
    n_symbols: int
    seg_offsets: np.ndarray   # (n_seg,) int64 byte offset of each segment stream
    seg_nbytes: np.ndarray    # (n_seg,) int64 byte length (incl. guard)
    seg_counts: np.ndarray    # (n_seg,) int64 symbols per segment
    seg_bits: np.ndarray      # (n_seg,) int64 encoded payload bits


def segment_and_encode(
    name: str,
    q: np.ndarray,
    table,
    segment_symbols: int = DEFAULT_SEGMENT_SYMBOLS,
) -> Tuple[SegmentedTensor, List[np.ndarray]]:
    """Encode one quantized tensor into independent byte-aligned segment streams.

    ``table`` is anything with the shared ``encode(flat_symbols) ->
    (guard-padded stream, payload bits)`` contract — a
    :class:`repro_torch.core.codecs.base.CodeTable` or a bare
    :class:`repro_torch.core.entropy.HuffmanTable`.  A table with an
    ``encode_rows(rows)`` (the tANS one) encodes the full segments in one
    call.
    """
    flat = q.reshape(-1)
    n = flat.size
    n_rows = n // segment_symbols
    rows = flat[: n_rows * segment_symbols].reshape(n_rows, segment_symbols)
    encode_rows = getattr(table, "encode_rows", None)
    coded = list(encode_rows(rows)) if encode_rows is not None \
        else [table.encode(r) for r in rows]
    counts = [segment_symbols] * n_rows
    if n % segment_symbols or n == 0:
        coded.append(table.encode(flat[n_rows * segment_symbols:]))
        counts.append(n - n_rows * segment_symbols)
    streams: List[np.ndarray] = [stream for stream, _ in coded]
    bits = [nbits for _, nbits in coded]
    meta = SegmentedTensor(
        name=name,
        shape=tuple(q.shape),
        n_symbols=n,
        seg_offsets=np.zeros(len(streams), dtype=np.int64),  # filled by the container
        seg_nbytes=np.array([len(s) for s in streams], dtype=np.int64),
        seg_counts=np.array(counts, dtype=np.int64),
        seg_bits=np.array(bits, dtype=np.int64),
    )
    return meta, streams


def balanced_assignment(seg_bits: np.ndarray, n_workers: int) -> List[np.ndarray]:
    """Paper §III-C shuffling: longest-processing-time-first greedy assignment of
    segments to workers so each worker's total encoded bits are near-equal."""
    order = np.argsort(-seg_bits)
    loads = np.zeros(n_workers, dtype=np.int64)
    buckets: List[List[int]] = [[] for _ in range(n_workers)]
    for s in order:
        w = int(np.argmin(loads))
        buckets[w].append(int(s))
        loads[w] += int(seg_bits[s])
    return [np.array(sorted(b), dtype=np.int64) for b in buckets]


def shard_segment_slices(seg_counts: np.ndarray, shard_bounds: Sequence[Tuple[int, int]]
                         ) -> List[np.ndarray]:
    """Map flat-symbol shard ranges [a, b) to the segment indices that cover them.

    Used by the sharded loader: with ``segment_symbols`` dividing the per-shard symbol
    count (the framework picks segment sizes that do), each shard maps to a whole number
    of segments and decodes with zero overlap.
    """
    starts = np.concatenate([[0], np.cumsum(seg_counts)])[:-1]
    ends = starts + seg_counts
    out = []
    for a, b in shard_bounds:
        out.append(np.nonzero((starts < b) & (ends > a))[0].astype(np.int64))
    return out
