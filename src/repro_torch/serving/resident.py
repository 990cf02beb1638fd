"""Compressed-resident serving weights (PyTorch port of
``repro/serving/resident.py``): the container stays entropy-coded in memory
and each layer's QT triples are materialized just before that layer's
matmuls, then dropped.

This is the paper's headline serving scenario (§IV: weights stay
entropy-coded so each layer moves fewer bytes than its dense footprint).
Instead of decoding the whole container at engine start
(:func:`repro_torch.serving.engine.load_params_from_compressed`), only three
things stay resident:

* the **compressed payload** (per-table bitstreams + decode tables +
  per-tensor scale/zero metadata from container v2);
* the **globals** — non-layer tensors (embedding, final norm, lm head),
  decoded once with the whole-model loader's packing rules, on ``device``;
* a small **dense-stacked carve-out** — layer tensors the per-layer QT path
  cannot host (fp32 norms, per-group or rule-quantized params), decoded
  once and sliced per layer (views, no copies).

Everything else is decoded per layer through an execution-order plan
(:func:`repro_torch.core.scheduler.plan_execution`), double-buffered: a
worker thread decodes layer *l+1* into a shared preallocated host buffer
while layer *l* computes.  With ``fused=True`` the tile-aligned tensors are
not decoded per layer at all: each layer's slice becomes a
:class:`~repro_torch.kernels.fused_decode_matmul.FusedQT` handle, built once
and kept on ``device``, and the matmul decodes it.

Threads and streams: the worker thread launches the ``cuda`` backend's
decode kernels on its current stream, which is the default stream the
compute also uses; the backend's copy of the symbols to the host waits for
the kernel, and the slot's copies back to the card are synchronous, so
every tensor ``get`` hands over is complete before the compute that uses
it is queued.  The price is the overlap: the worker's wait also waits for
the compute queued before it.  ``resident.prefetch_hit`` /
``resident.prefetch_wait`` and the ``resident.consume_wait`` span show it.

Bit-identity: the decoded symbols, the per-layer scale/zero slices and the
QT/QT4 packing (:func:`repro_torch.models.layers.pack_qt`) are byte-identical
to slicing the whole-model loader's stacked triples, and the per-layer step
functions mirror the loop bodies op for op, so greedy decode matches the
dense-resident engine bit for bit on one device.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.bitstream import GUARD_BYTES, pack_streams, pow2_bucket
from repro_torch.core.decode_backends import DecoderBackend, get_backend
from repro_torch.core.scheduler import (DEFAULT_CHUNK_SYMBOLS, ExecutionStep,
                                        decode_execution_step,
                                        fused_tile_reason, iter_seg_runs,
                                        plan_execution, plan_fused_spans)
from repro_torch.core.spec import quantizable_shape
from repro_torch.core.store import CompressedModel
from repro_torch.models.layers import layer_slice, pack_qt, to_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

LAYER_PREFIX = "layers/"


def _nbytes(tree: Any) -> int:
    """Bytes of a tensor or of every part of a QT / QT4 triple."""
    parts = tuple(tree) if isinstance(tree, tuple) else (tree,)
    return sum(p.numel() * p.element_size() for p in parts)


class CompressedResidentWeights:
    """Device-resident entropy-coded weights + per-layer decode slots.

    Stands in for the ``params`` dict of the engine when its steps are built
    with ``ServeSteps(cfg, sc, resident="compressed")``: the per-layer
    step loops call :meth:`get` / :meth:`prefetch` instead of slicing a stacked
    tree.

    Args:
      model: the compressed container (format v1 or v2).
      cfg: architecture config; ``cfg.n_layers`` names the stacked axis.
      backend: decoder-registry name or instance (None/"auto" follows
        ``device``), as for the whole-model loader.
      pack_int4: pack 4-bit layers into QT4 nibble pairs (default, matching
        the whole-model loader).
      chunk_symbols: per-decode-call symbol budget within a layer: bounds the
        int32 scratch at O(chunk) instead of O(layer).  ``None`` -> one call
        per (layer, table).
      prefetch: decode layer l+1 on a worker thread while layer l computes
        (double buffering).  Disable for single-threaded debugging.
      fused: hand tile-aligned tensors to the fused decode→dequant→matmul
        kernel as :class:`~repro_torch.kernels.fused_decode_matmul.FusedQT`
        handles (built once, resident on ``device``) instead of decoding them
        into per-layer slots.  Tensors the fused contract cannot host stay on
        the per-layer decode path; ``fused_fallback`` maps each to its
        reason.  The handle's device picks the kernel (CUDA) or its plain
        version (CPU); there is no other choice to make.
      device: where the weights and slots live (``cuda`` unless the caller
        names the CPU).
    """

    def __init__(self, model: CompressedModel, cfg: ArchConfig, *,
                 backend=None, pack_int4: bool = True,
                 chunk_symbols: Optional[int] = DEFAULT_CHUNK_SYMBOLS,
                 prefetch: bool = True, fused: bool = False, device=None):
        t_load = time.perf_counter()
        self.device = _device.resolve(device)
        self.model = model
        self.cfg = cfg
        self.n_layers = int(cfg.n_layers)
        self.backend: DecoderBackend = (
            backend if isinstance(backend, DecoderBackend)
            else get_backend(backend, device=self.device))
        self.pack_int4 = pack_int4

        self.globals: Dict[str, Any] = {}
        self.stacked: Dict[str, Any] = {}      # dense-resident carve-outs
        self._hosted: List[str] = []           # per-layer compressed tensors
        for name, w in model.unquantized.items():
            val = torch.from_numpy(np.asarray(w)).to(self.device)
            (self.stacked if self._is_layer_stacked(name, w.shape)
             else self.globals)[name] = val
        for name, meta in model.tensors.items():
            if self._is_layer_stacked(name, meta.shape) \
                    and self._qt_hostable(name):
                self._hosted.append(name)
            else:
                val = self._load_one(name)
                (self.stacked if self._is_layer_stacked(name, meta.shape)
                 else self.globals)[name] = val

        self.fused = bool(fused)
        self._fused: List[str] = []
        self.fused_fallback: Dict[str, str] = {}
        self._fused_slots: List[Dict[str, Any]] = [
            {} for _ in range(self.n_layers)]
        if fused:
            self._build_fused_slots()

        self.chunk_symbols = chunk_symbols
        self.plan: List[List[ExecutionStep]] = plan_execution(
            model, self.n_layers, self._hosted)
        rows = cols = 1
        for steps in self.plan:
            for step in steps:
                for run in iter_seg_runs(step.segs, chunk_symbols):
                    rows = max(rows, len(run))
                    cols = max(cols, max(s.count for s in run))
        # ONE host scratch buffer shared by every per-layer decode call (the
        # decode-into-buffer contract); double buffering is safe because the
        # single worker thread serializes decodes and the slots it returns
        # are copies, never views of the scratch
        self._buf = np.zeros((rows, cols), dtype=np.int32)
        self._exec: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix="resident-decode")
            if prefetch else None)
        self._pending: Dict[int, Future] = {}
        # guards _pending: prefetch() may be called from another thread
        # while get() consumes from the engine loop
        self._lock = threading.Lock()
        if self.fused:
            obs_metrics.counter("resident.fused_tensors").inc(
                len(self._fused))
            for reason in self.fused_fallback.values():
                obs_metrics.counter("resident.fused_fallback").inc(
                    reason=reason)
        _device.synchronize(self.device)
        obs_metrics.gauge("load.decode_load_s").set(
            time.perf_counter() - t_load)

    # ------------------------------------------------------------ classification
    def _is_layer_stacked(self, name: str, shape) -> bool:
        return (name.startswith(LAYER_PREFIX) and len(shape) >= 1
                and shape[0] == self.n_layers
                and int(np.prod(shape)) % self.n_layers == 0)

    def _qt_hostable(self, name: str) -> bool:
        """Can this stacked tensor live compressed with per-layer QT slots?
        Needs a matrix the serving matmul dequantizes at use (the whole-model
        loader's rule) and a scale/zero that slices or broadcasts per layer
        (per-channel leading-axis pairs, or per-tensor scalars)."""
        m = self.model.qmeta[name]
        if not quantizable_shape(name, self.model.tensors[name].shape):
            return False
        if m["granularity"] == "per_group":
            return False
        s = np.asarray(m["scale"])
        return s.ndim == len(self.model.tensors[name].shape) \
            and s.shape[0] in (1, self.n_layers)

    def _fused_reason(self, name: str) -> Optional[str]:
        """Why a hosted tensor cannot take the fused path (None = eligible):
        the scheduler's tile-alignment contract plus a per-layer scale/zero
        the kernel can broadcast against its (K, N) tiles."""
        reason = fused_tile_reason(self.model, self.n_layers, name)
        if reason:
            return reason
        m = self.model.qmeta[name]
        s = np.asarray(m["scale"])
        N = self.model.tensors[name].shape[-1]
        if s.ndim != 3 or s.shape[1] != 1 or s.shape[2] not in (1, N):
            return f"scale shape {s.shape} is not a per-layer scalar/row"
        return None

    def _build_fused_slots(self) -> None:
        """Partition ``_hosted`` into fused handles + unfused fallback, and
        build every layer's :class:`FusedQT` ONCE (payload slices + decode
        tables on ``device``; nothing is re-decoded per step — decode
        happens inside the matmul)."""
        from repro_torch.kernels.fused_decode_matmul import build_fused_qt
        keep: List[str] = []
        for name in self._hosted:
            reason = self._fused_reason(name)
            if reason:
                keep.append(name)
                self.fused_fallback[name] = reason
            else:
                self._fused.append(name)
        self._hosted = keep
        spans = plan_fused_spans(self.model, self.n_layers, self._fused)
        for name, layer_spans in spans.items():
            table = self.model.table_for(name)
            m = self.model.qmeta[name]
            scale, zero = np.asarray(m["scale"]), np.asarray(m["zero"])
            _, K, N = self.model.tensors[name].shape
            # one pow2 width across ALL layers: the per-layer lane matrices
            # share one shape, as in the JAX package
            width = pow2_bucket(
                max(GUARD_BYTES,
                    max(s.nbytes for sp in layer_spans for s in sp.segs)), 64)
            short = name[len(LAYER_PREFIX):]
            for sp in layer_spans:
                streams = [self.model.payload[s.offset: s.offset + s.nbytes]
                           for s in sp.segs]
                mat, _ = pack_streams(streams, min_width=width)
                i = min(sp.layer, scale.shape[0] - 1)
                self._fused_slots[sp.layer][short] = build_fused_qt(
                    table, mat, scale[i], zero[i],
                    seg_symbols=sp.seg_symbols, K=K, N=N, bits=m["bits"],
                    device=self.device)

    def _load_one(self, name: str) -> Any:
        """Decode one tensor with the whole-model loader's packing rules
        (globals and dense-stacked carve-outs equal
        ``load_params_from_compressed``'s output for the same name)."""
        q = self.model.decode_tensor(name, backend=self.backend)
        m = self.model.qmeta[name]
        if not quantizable_shape(name, self.model.tensors[name].shape) \
                or m["granularity"] == "per_group":
            return torch.from_numpy(
                self.model._dequantize_one(name, q)).to(self.device)
        return to_device(pack_qt(q, m["scale"], m["zero"], bits=m["bits"],
                                 pack_int4=self.pack_int4), self.device)

    # ----------------------------------------------------------------- decoding
    def _decode_layer(self, l: int) -> Dict[str, Any]:
        """Materialize layer ``l``'s weight-slot dict: decode its execution
        steps into the scratch buffer, slice scale/zero, pack QT/QT4, copy to
        ``device``, and add the carve-out views and fused handles."""
        with obs_trace.span("resident.decode", cat="resident", layer=l):
            slot = self._decode_layer_inner(l)
        obs_metrics.counter("resident.slot_tensors").inc(len(slot))
        return slot

    def _decode_layer_inner(self, l: int) -> Dict[str, Any]:
        slot: Dict[str, Any] = {}
        for step in self.plan[l]:
            for name, flat in decode_execution_step(
                    self.model, step, self.backend, out=self._buf,
                    chunk_symbols=self.chunk_symbols).items():
                m = self.model.qmeta[name]
                shape = self.model.tensors[name].shape[1:]
                scale, zero = np.asarray(m["scale"]), np.asarray(m["zero"])
                i = min(l, scale.shape[0] - 1)   # (L,1,..) slices; (1,1,..)
                qt = pack_qt(flat.reshape(shape), scale[i], zero[i],
                             bits=m["bits"], pack_int4=self.pack_int4)
                slot[name[len(LAYER_PREFIX):]] = to_device(qt, self.device)
        for name, w in self.stacked.items():
            slot[name[len(LAYER_PREFIX):]] = layer_slice(w, l)
        # fused handles are prebuilt and resident: no per-get work
        slot.update(self._fused_slots[l])
        return slot

    def prefetch(self, l: int) -> None:
        """Start decoding layer ``l`` on the worker thread (no-op when
        already in flight or prefetch is disabled)."""
        if self._exec is None:
            return
        with self._lock:
            if l in self._pending:
                return
            self._pending[l] = self._exec.submit(self._decode_layer, l)
        obs_trace.instant("resident.prefetch_issue", cat="resident", layer=l)
        obs_metrics.counter("resident.prefetch_issued").inc()

    def get(self, l: int) -> Dict[str, Any]:
        """Layer ``l``'s weight-slot dict (waits on its prefetch if one is
        in flight; decodes otherwise).  The caller drops the dict after the
        layer's matmuls — nothing retains it here.

        The ``resident.consume_wait`` span is the overlap-stall probe: its
        duration is the time the serving loop blocked on weight decode (≈0
        on a prefetch hit); ``resident.consume_wait_s`` sums it."""
        with self._lock:
            fut = self._pending.pop(l, None)
        t0 = time.perf_counter()
        try:
            if fut is not None:
                hit = fut.done()
                if hit:
                    obs_metrics.counter("resident.prefetch_hit").inc()
                else:
                    obs_metrics.counter("resident.prefetch_wait").inc()
                with obs_trace.span("resident.consume_wait", cat="resident",
                                    layer=l, hit=hit):
                    return fut.result()
            # no prefetch in flight: the whole decode is a stall
            obs_metrics.counter("resident.prefetch_wait").inc()
            with obs_trace.span("resident.consume_wait", cat="resident",
                                layer=l, hit=False):
                if self._exec is not None:
                    # through the worker, so the shared scratch buffer is
                    # only ever touched by one thread
                    return self._exec.submit(self._decode_layer, l).result()
                return self._decode_layer(l)
        finally:
            obs_metrics.counter("resident.consume_wait_s").inc(
                time.perf_counter() - t0)

    def wait_prefetches(self) -> int:
        """Wait until every prefetch in flight has decoded (each stays
        queued for its :meth:`get`); returns how many there were."""
        with self._lock:
            futs = list(self._pending.values())
        for fut in futs:
            fut.result()
        return len(futs)

    def close(self) -> None:
        """Stop the worker thread (waits for a decode in flight)."""
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
        with self._lock:
            self._pending.clear()

    # ---------------------------------------------------------------- accounting
    def resident_bytes(self) -> Dict[str, int]:
        """Deterministic weight-memory breakdown (the serving analogue of
        the paper's Table 2 storage column), equal to the JAX package's for
        the same container.  Device tensors count ``numel * element_size``."""
        payload = sum(int(self.model.tensors[n].seg_nbytes.sum())
                      for n in self._hosted)
        # fused tensors keep their payload as device lane matrices (guard +
        # pow2-width padding included): count the actual resident bytes
        payload += sum(_nbytes(fq.mat) for slots in self._fused_slots
                       for fq in slots.values())
        compressed = self._hosted + self._fused
        tables = sum(
            sum(np.asarray(a).nbytes
                for a in self.model.tables[t].decode_arrays().values())
            for t in {self.model.table_id_for(n) for n in compressed})
        qmeta = sum(np.asarray(self.model.qmeta[n]["scale"]).nbytes
                    + np.asarray(self.model.qmeta[n]["zero"]).nbytes
                    for n in compressed)
        globals_b = sum(_nbytes(v) for v in self.globals.values())
        stacked_b = sum(_nbytes(v) for v in self.stacked.values())
        slot = 0
        for n in self._hosted:
            m = self.model.qmeta[n]
            per_layer = self.model.tensors[n].n_symbols // self.n_layers
            last = self.model.tensors[n].shape[-1]
            packed = m["bits"] == 4 and self.pack_int4 and last % 2 == 0
            scale = np.asarray(m["scale"])
            slot += (per_layer // 2 if packed else per_layer) \
                + 2 * (scale.nbytes // scale.shape[0])
        return {
            "payload": payload, "tables": tables, "qmeta": qmeta,
            "globals": globals_b, "stacked": stacked_b,
            "layer_slot": slot, "scratch": self._buf.nbytes,
        }

    def peak_resident_bytes(self) -> int:
        """Peak weight-path bytes: everything permanently resident plus the
        double-buffered pair of per-layer slots and the decode scratch."""
        b = self.resident_bytes()
        return (b["payload"] + b["tables"] + b["qmeta"] + b["globals"]
                + b["stacked"] + b["scratch"] + 2 * b["layer_slot"])

    def dense_resident_bytes(self) -> int:
        """What the dense-resident QT mode holds for the same container
        (globals/carve-outs identical; hosted tensors fully decoded)."""
        b = self.resident_bytes()
        full = 0
        for n in self._hosted + self._fused:
            m = self.model.qmeta[n]
            t = self.model.tensors[n]
            packed = m["bits"] == 4 and self.pack_int4 \
                and t.shape[-1] % 2 == 0
            full += (t.n_symbols // 2 if packed else t.n_symbols) \
                + np.asarray(m["scale"]).nbytes \
                + np.asarray(m["zero"]).nbytes
        return b["globals"] + b["stacked"] + full

    def dense_bf16_bytes(self) -> int:
        """The uncompressed bf16 baseline (2 bytes/param, paper Table 2)."""
        n = sum(t.n_symbols for t in self.model.tensors.values()) \
            + sum(int(np.prod(w.shape))
                  for w in self.model.unquantized.values())
        return 2 * n
