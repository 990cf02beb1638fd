"""Streaming weight-decode scheduler (paper Alg. 1 EDGE DEVICE OPERATIONS,
restructured as a pipeline instead of a monolithic pass).

``CompressedModel.decode_all`` historically materialized *every* segment of
*every* tensor in one lock-step batch: peak host memory ~ total model size,
and the serving engine could not touch a single weight until the last symbol
of the last tensor had decoded.  :class:`DecodeScheduler` replaces that with:

1. **Plan** — walk the container's segments in order and group them into
   :class:`DecodeChunk`\\ s holding at most ``chunk_symbols`` symbols.  Chunk
   boundaries also respect a *group key* (per-layer by default: the tensor
   name's ``/``-prefix), so one chunk never straddles two layer groups unless
   a single tensor is itself larger than the budget (it then spans several
   chunks and is reassembled on completion).
2. **Decode** — each chunk is packed and decoded through a pluggable
   :class:`repro_torch.core.decode_backends.DecoderBackend` (``numpy`` /
   ``torch`` / ``cuda`` by name, or ``auto``, which follows the device).
3. **Stream** — :meth:`iter_decode` yields ``(name, symbols)`` as soon as a
   tensor's last segment lands, with **double-buffered prefetch**: a worker
   thread decodes chunk *k+1* while the consumer (dequantize, device transfer,
   engine load) processes chunk *k*.

Peak host memory is bounded by ~2 in-flight chunks (packed bytes + int32
symbols) plus one partially assembled tensor — independent of model size.
The monolithic behaviour is recovered exactly by ``chunk_symbols=None``
(one chunk holding everything), which is what ``decode_all`` uses.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import (TYPE_CHECKING, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .bitstream import GUARD_BYTES, pack_streams, pow2_bucket
from .decode_backends import DecoderBackend, get_backend
from .segmentation import DEFAULT_SEGMENT_SYMBOLS

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (store -> scheduler)
    from .store import CompressedModel

# 8 segments x 64k symbols ~ 0.5 MB of encoded uint8 payload and 2 MB of
# decoded int32 per chunk at the default segment size — small enough for
# edge-class hosts, large enough to keep every decode lane busy.
DEFAULT_CHUNK_SYMBOLS = 8 * DEFAULT_SEGMENT_SYMBOLS


def layer_group_key(name: str) -> str:
    """Default chunk-affinity key: the tensor name's leading path component
    (``"layers/wq" -> "layers"``, ``"embed" -> "embed"``).  With the repo's
    layer-stacked parameter layout this keeps each logical weight group's
    segments contiguous in the plan."""
    return name.split("/", 1)[0]


@dataclasses.dataclass
class _Seg:
    """One encoded segment's coordinates inside the container."""

    tensor: str
    index: int        # segment index within the tensor
    is_last: bool     # final segment of its tensor
    offset: int       # byte offset into the payload
    nbytes: int
    count: int        # symbols in this segment


@dataclasses.dataclass
class DecodeChunk:
    """A fixed-budget unit of decode work (a run of consecutive segments)."""

    segs: List[_Seg]

    @property
    def symbols(self) -> int:
        return sum(s.count for s in self.segs)

    @property
    def tensors(self) -> List[str]:
        out: List[str] = []
        for s in self.segs:
            if not out or out[-1] != s.tensor:
                out.append(s.tensor)
        return out


class DecodeScheduler:
    """Plans and runs chunked, prefetched decoding of one compressed model.

    Args:
      model: the :class:`~repro_torch.core.store.CompressedModel` container.
      backend: registry name (``"numpy"`` / ``"torch"`` / ``"cuda"``),
        ``"auto"``/None to follow ``device``, or a :class:`DecoderBackend`
        instance.
      chunk_symbols: symbol budget per chunk; ``None`` -> single monolithic
        chunk (the historical ``decode_all`` behaviour).
      group_key: ``name -> str`` chunk-affinity key (default per-layer); pass
        ``lambda n: ""`` to disable group boundaries and chunk purely by
        budget.
      first: optional name prefixes to schedule ahead of container order
        (e.g. ``("embed",)`` so the serving engine's embedding is resident
        before the bulk of the blocks decode).
      prefetch: decode chunk *k+1* on a worker thread while chunk *k* is
        consumed (double buffering).  Disable for single-threaded debugging.
        The ``cuda`` backend launches from that worker thread on its
        current stream (the default stream) and copies the symbols back to
        the host before the chunk is handed to ``_assemble``, so the
        consumer never reads an unfinished decode.
      device: where ``backend="auto"`` decodes (``cuda`` unless the caller
        names the CPU).
    """

    def __init__(self, model: "CompressedModel", *,
                 backend=None,
                 chunk_symbols: Optional[int] = DEFAULT_CHUNK_SYMBOLS,
                 group_key: Optional[Callable[[str], str]] = None,
                 first: Sequence[str] = (),
                 prefetch: bool = True,
                 device=None):
        self.model = model
        self.backend: DecoderBackend = (
            backend if isinstance(backend, DecoderBackend)
            else get_backend(backend, device=device))
        self.chunk_symbols = chunk_symbols
        self.group_key = group_key or layer_group_key
        self.first = tuple(first)
        self.prefetch = prefetch

    # ------------------------------------------------------------------ plan
    def _ordered_names(self) -> List[str]:
        """Container order, with ``first=`` prefixes pulled ahead and names
        grouped by code table.  Table-major order matters for mixed v2
        containers: chunks cannot straddle tables, so an order that
        alternates tables tensor-by-tensor would fragment into tiny
        lane-starved kernel calls (measured ~6x slower — see decode_all);
        grouping yields one contiguous run (and, unbudgeted, one lock-step
        call) per table."""
        names = list(self.model.tensors)
        rank = {n: i for i, n in enumerate(names)}
        early = lambda n: not any(n.startswith(p) for p in self.first)
        table_rank = {t: i for i, t in enumerate(sorted(self.model.tables))}
        return sorted(names, key=lambda n: (
            early(n), table_rank[self.model.table_id_for(n)], rank[n]))

    def plan(self) -> List[DecodeChunk]:
        """Group the container's segments into budgeted chunks.

        A chunk decodes through ONE code table (one lock-step kernel call),
        so chunk boundaries fall on code-table changes as well as on the
        symbol budget and the group key — a mixed 4/8-bit or mixed-codec
        container (format v2) never packs two tables' segments together.
        """
        budget = self.chunk_symbols
        chunks: List[DecodeChunk] = []
        cur: List[_Seg] = []
        cur_symbols = 0
        cur_group: Optional[str] = None
        cur_table: Optional[str] = None
        for name in self._ordered_names():
            group = self.group_key(name)
            table_id = self.model.table_id_for(name)
            for seg in tensor_segments(self.model, name):
                boundary = cur and (
                    table_id != cur_table
                    or (budget is not None and (
                        cur_symbols + seg.count > budget
                        or group != cur_group)))
                if boundary:
                    chunks.append(DecodeChunk(cur))
                    cur, cur_symbols = [], 0
                cur.append(seg)
                cur_symbols += seg.count
                cur_group = group
                cur_table = table_id
        if cur:
            chunks.append(DecodeChunk(cur))
        return chunks

    # ---------------------------------------------------------------- decode
    def _decode_chunk(self, chunk: DecodeChunk) -> List[np.ndarray]:
        """Decode one chunk; returns per-segment symbol arrays (trimmed)."""
        # plan() guarantees one code table per chunk; its kernel family
        # (prefix / tans) picks the backend's matching lock-step loop
        table_id = self.model.table_id_for(chunk.segs[0].tensor)
        table = self.model.table_for(chunk.segs[0].tensor)
        with obs_trace.span("decode.chunk", cat="decode",
                            table=table_id, backend=self.backend.name,
                            segments=len(chunk.segs), symbols=chunk.symbols):
            mat, counts = pack_segments(self.model.payload, chunk.segs)
            dec = self.backend.decode_table(table, mat, counts)
        obs_metrics.counter("decode.symbols").inc(chunk.symbols,
                                                  table=table_id)
        obs_metrics.counter("decode.calls").inc(backend=self.backend.name)
        return [dec[i, : s.count] for i, s in enumerate(chunk.segs)]

    def iter_decode(self) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield ``(name, uint8 symbols in tensor shape)`` incrementally.

        Tensors are emitted the moment their final segment decodes; with
        prefetch enabled the next chunk decodes concurrently on a worker
        thread while the caller consumes the current one.
        """
        chunks = self.plan()
        if not chunks:
            return
        if not self.prefetch or len(chunks) == 1:
            gen = (self._decode_chunk(c) for c in chunks)
            yield from self._assemble(chunks, gen)
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            def prefetched():
                fut = ex.submit(self._decode_chunk, chunks[0])
                for i in range(len(chunks)):
                    got = fut.result()
                    if i + 1 < len(chunks):
                        fut = ex.submit(self._decode_chunk, chunks[i + 1])
                    yield got
            yield from self._assemble(chunks, prefetched())

    def _assemble(self, chunks: List[DecodeChunk],
                  decoded) -> Iterator[Tuple[str, np.ndarray]]:
        pieces: Dict[str, List[np.ndarray]] = {}
        for chunk, segs in zip(chunks, decoded):
            for seg, arr in zip(chunk.segs, segs):
                pieces.setdefault(seg.tensor, []).append(arr)
                if not seg.is_last:
                    continue
                meta = self.model.tensors[seg.tensor]
                parts = pieces.pop(seg.tensor)
                flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
                yield seg.tensor, flat.astype(np.uint8).reshape(meta.shape)
        assert not pieces, f"incomplete tensors at end of plan: {list(pieces)}"


def tensor_segments(model: "CompressedModel", name: str) -> List[_Seg]:
    """The container's segment coordinates for one tensor, in symbol order
    (the one place segment-table columns become :class:`_Seg` records)."""
    meta = model.tensors[name]
    n_seg = len(meta.seg_offsets)
    return [
        _Seg(tensor=name, index=j, is_last=(j == n_seg - 1),
             offset=int(o), nbytes=int(nb), count=int(c))
        for j, (o, nb, c) in enumerate(zip(meta.seg_offsets, meta.seg_nbytes,
                                           meta.seg_counts))
    ]


def pack_segments(payload: np.ndarray,
                  segs: Sequence[_Seg]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a segment run's payload slices into one decode-call matrix.

    The one pack rule every lock-step decode call shares: rows are the
    segments' byte streams, counts their symbol counts, and the width
    buckets to a power of two, exactly as the JAX package packs it (its
    shape-specialized backends reuse one compile per bucket).
    """
    streams = [payload[s.offset: s.offset + s.nbytes] for s in segs]
    counts = np.array([s.count for s in segs], dtype=np.int64)
    width = max(GUARD_BYTES, max(s.nbytes for s in segs))
    mat, _ = pack_streams(streams, min_width=pow2_bucket(width, 64))
    return mat, counts
