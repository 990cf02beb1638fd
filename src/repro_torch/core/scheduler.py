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


# ---------------------------------------------------------------------------
# Execution-order plans (compressed-resident serving, paper §IV "parallel
# decoding strategy"): plan the decode in LAYER EXECUTION order so a serving
# step materializes exactly layer l's weights just before layer l's matmuls,
# while a worker thread decodes layer l+1.


@dataclasses.dataclass
class ExecutionSpan:
    """One stacked tensor's layer-l slice, as container segments.

    Segments hold fixed symbol counts and know nothing about layer
    boundaries, so a layer's symbol range ``[l*P, (l+1)*P)`` may start and
    end mid-segment: ``segs`` are the overlapping segments in order, ``trim``
    is the slice start within their concatenated decode, ``count`` the
    symbols belonging to the layer (``P = n_symbols / n_layers``).  Boundary
    segments are decoded by both adjacent layers and trimmed — the price of
    planning over an unmodified container.
    """

    tensor: str
    segs: List[_Seg]
    trim: int
    count: int


@dataclasses.dataclass
class ExecutionStep:
    """All spans one layer decodes through ONE code table (one lock-step
    kernel call, same no-straddling rule as :meth:`DecodeScheduler.plan`)."""

    layer: int
    table_id: str
    spans: List[ExecutionSpan]

    @property
    def segs(self) -> List[_Seg]:
        return [s for sp in self.spans for s in sp.segs]


def plan_execution(model: "CompressedModel", n_layers: int,
                   names: Sequence[str]) -> List[List[ExecutionStep]]:
    """Plan per-layer decode of layer-stacked tensors in execution order.

    ``names`` are container tensors whose leading axis is the layer axis
    (``shape[0] == n_layers``); returns one list of :class:`ExecutionStep`
    per layer (usually a single step; mixed-codec containers get one step
    per code table).  The plan holds only coordinates into the resident
    payload — the bitstream itself is never copied or reordered.
    """
    spans: List[List[ExecutionSpan]] = [[] for _ in range(n_layers)]
    for name in names:
        meta = model.tensors[name]
        if len(meta.shape) == 0 or meta.shape[0] != n_layers:
            raise ValueError(
                f"{name}: shape {meta.shape} is not stacked over "
                f"{n_layers} layers")
        per_layer, rem = divmod(meta.n_symbols, n_layers)
        assert rem == 0, (name, meta.n_symbols, n_layers)
        segs = tensor_segments(model, name)
        starts = np.concatenate([[0], np.cumsum(meta.seg_counts)])
        for l in range(n_layers):
            a, b = l * per_layer, (l + 1) * per_layer
            idx = np.nonzero((starts[:-1] < b) & (starts[1:] > a))[0]
            spans[l].append(ExecutionSpan(
                tensor=name, segs=[segs[i] for i in idx],
                trim=a - int(starts[idx[0]]), count=per_layer))
    plan: List[List[ExecutionStep]] = []
    for l, layer_spans in enumerate(spans):
        by_table: Dict[str, List[ExecutionSpan]] = {}
        for sp in layer_spans:
            by_table.setdefault(model.table_id_for(sp.tensor), []).append(sp)
        plan.append([ExecutionStep(layer=l, table_id=t, spans=s)
                     for t, s in sorted(by_table.items())])
    return plan


@dataclasses.dataclass
class FusedTileSpan:
    """One stacked tensor's layer-l slice as *whole* segments whose lane
    boundaries coincide with matmul K-tiles (the fused-kernel contract:
    no trims, uniform counts — contrast :class:`ExecutionSpan`, which
    tolerates boundary segments by decoding them twice)."""

    tensor: str
    layer: int
    segs: List[_Seg]
    seg_symbols: int


def fused_tile_reason(model: "CompressedModel", n_layers: int,
                      name: str) -> Optional[str]:
    """Why ``name`` cannot feed the fused decode→dequant→matmul kernel —
    ``None`` when its segments tile-align with per-layer (K, N) blocks.

    The geometric contract (see kernels/fused_decode_matmul.py): a stacked
    (L, K, N) tensor whose segments all hold the same ``seg`` symbols, with
    ``seg`` a multiple of the row width N and the per-layer symbol count a
    multiple of ``seg`` — so each layer is a whole number of lanes and each
    decoded lane reshapes row-major into whole (seg/N, N) K-tile rows.
    """
    meta = model.tensors[name]
    if len(meta.shape) != 3:
        return f"shape {meta.shape} is not a stacked (L, K, N) matrix"
    if meta.shape[0] != n_layers:
        return f"leading dim {meta.shape[0]} != n_layers {n_layers}"
    counts = np.asarray(meta.seg_counts)
    seg = int(counts[0])
    if not (counts == seg).all():
        return "ragged tail segment (non-uniform symbol counts)"
    _, K, N = meta.shape
    if seg % N:
        return f"segment of {seg} symbols does not tile rows of width {N}"
    if (K * N) % seg:
        return f"layer slice of {K * N} symbols is not a whole number " \
               f"of {seg}-symbol segments"
    return None


def plan_fused_spans(model: "CompressedModel", n_layers: int,
                     names: Sequence[str]) -> Dict[str, List[FusedTileSpan]]:
    """Per-layer whole-segment spans for fused-eligible tensors.

    Raises on any name failing :func:`fused_tile_reason` — callers classify
    first and fall back to :func:`plan_execution` for the rest.  Returns
    ``{name: [span for layer 0, span for layer 1, ...]}``.
    """
    out: Dict[str, List[FusedTileSpan]] = {}
    for name in names:
        reason = fused_tile_reason(model, n_layers, name)
        if reason:
            raise ValueError(f"{name}: {reason}")
        meta = model.tensors[name]
        seg = int(meta.seg_counts[0])
        segs = tensor_segments(model, name)
        lanes_per_layer = (meta.n_symbols // n_layers) // seg
        out[name] = [
            FusedTileSpan(tensor=name, layer=l,
                          segs=segs[l * lanes_per_layer:
                                    (l + 1) * lanes_per_layer],
                          seg_symbols=seg)
            for l in range(n_layers)
        ]
    return out


def iter_seg_runs(segs: Sequence[_Seg],
                  chunk_symbols: Optional[int]) -> Iterator[List[_Seg]]:
    """Split a segment sequence into consecutive runs of at most
    ``chunk_symbols`` symbols (at least one segment per run; ``None`` ->
    one run).  The per-layer decode uses this exactly like
    :meth:`DecodeScheduler.plan` uses its budget: it bounds the int32
    decode scratch to O(chunk) instead of O(layer)."""
    if chunk_symbols is None:
        yield list(segs)
        return
    run: List[_Seg] = []
    n = 0
    for s in segs:
        if run and n + s.count > chunk_symbols:
            yield run
            run, n = [], 0
        run.append(s)
        n += s.count
    if run:
        yield run


def decode_execution_step(model: "CompressedModel", step: ExecutionStep,
                          backend: DecoderBackend, *,
                          out: Optional[np.ndarray] = None,
                          chunk_symbols: Optional[int] = None
                          ) -> Dict[str, np.ndarray]:
    """Decode one layer-step; returns ``{tensor: flat uint8 layer slice}``.

    Lock-step multi-stream calls through the step's code table, one per
    budgeted segment run (``chunk_symbols=None`` -> a single call); ``out``
    is the optional preallocated (streams, max_count) int32 scratch shared
    across layers (:meth:`DecoderBackend.decode_table`'s decode-into-buffer
    contract).  Decoded symbols are narrowed to uint8 per segment as they
    land, so the live int32 footprint never exceeds one run.
    """
    table = model.tables[step.table_id]
    pieces: Dict[str, List[np.ndarray]] = {}
    n_symbols = sum(s.count for s in step.segs)
    with obs_trace.span("decode.exec_step", cat="decode", layer=step.layer,
                        table=step.table_id, backend=backend.name,
                        segments=len(step.segs), symbols=n_symbols):
        for run in iter_seg_runs(step.segs, chunk_symbols):
            mat, counts = pack_segments(model.payload, run)
            dec = backend.decode_table(table, mat, counts, out=out)
            for j, s in enumerate(run):
                pieces.setdefault(s.tensor, []).append(
                    dec[j, : s.count].astype(np.uint8))
    obs_metrics.counter("decode.symbols").inc(n_symbols, table=step.table_id)
    obs_metrics.counter("decode.calls").inc(backend=backend.name)
    result: Dict[str, np.ndarray] = {}
    for sp in step.spans:
        parts = pieces[sp.tensor]
        flat = np.concatenate(parts) if len(parts) > 1 else parts[0]
        if sp.trim == 0 and sp.count == flat.size:
            result[sp.tensor] = flat
        else:
            # copy so the layer slot never pins a boundary segment's
            # over-decode (the slice would otherwise keep the whole
            # segment's buffer alive for the slot's lifetime)
            result[sp.tensor] = flat[sp.trim: sp.trim + sp.count].copy()
    return result
