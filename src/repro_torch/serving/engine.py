"""Lockstep serving engine with the EntroLLM weight path (PyTorch port of
``repro/serving/engine.py``: dense and compressed residency, lockstep).

Pipeline (paper Alg. 1 EDGE DEVICE OPERATIONS):

  1. **Load**: :func:`load_params_from_compressed` decodes the entropy-coded
     container once per engine start.  The default load *streams*: the
     :class:`~repro_torch.core.scheduler.DecodeScheduler` feeds
     fixed-budget chunks (embedding first) through a decoder backend with
     double-buffered prefetch — on a card, the CUDA decode kernels — so host
     memory stays bounded and the first weights are resident long before
     the last chunk decodes (``time_to_first_weight_s``).
  2. **Residency**: decoded weights stay *quantized* (uint8 symbols + scale +
     zero as :class:`~repro_torch.models.layers.QT` triples, nibble-packed
     :class:`~repro_torch.models.layers.QT4` at 4 bits) in device memory and
     are dequantized in bf16 at each use.
     With ``resident="compressed"`` the container stays entropy-coded
     instead (:class:`~repro_torch.serving.resident.CompressedResidentWeights`)
     and each layer's weights are decoded just before its matmuls, or inside
     them through the fused kernels.
  3. **Serve**: ``prefill`` then repeated ``decode_step``; sampling is
     greedy or temperature-categorical through a ``torch.Generator``.

Entry points run on the card unless the caller passes ``device="cpu"``, and
raise when asked for a card that is not there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import quantizable_shape as _quantizable_shape
from repro_torch.core.store import _DEFAULT_CHUNK, CompressedModel
from repro_torch.models import api
from repro_torch.models.layers import QT, QT4, QTG, pack_qt, to_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# historical ad-hoc metric-dict keys -> canonical registry gauge names (the
# read-through surface Engine.generate keeps, same as the JAX package's)
_LEGACY_GENERATE_KEYS = {
    "prefill_s": "serve.prefill_s",
    "decode_s": "serve.decode_s",
    "ttft_s": "serve.ttft_s",
    "decode_tok_per_s": "serve.decode_tok_per_s",
    "e2e_tok_per_s": "serve.e2e_tok_per_s",
    "tok_per_s": "serve.decode_tok_per_s",
}


def _fence(dev: torch.device) -> None:
    """Synchronize when the active tracer asked for fenced spans
    (``--trace-sync``): CUDA launches are asynchronous, so without a fence a
    span around a step measures the enqueue, not the compute."""
    if obs_trace.sync_enabled():
        _device.synchronize(dev)


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0           # 0 => greedy
    q_block: int = 0                   # prefill attention's query blocks


# ------------------------------------------------------------ multi-device

# the families whose weights rest sharded by exact TP on a mesh and whose
# attention splits its heads over the model axis; the others keep both whole
EXACT_TP_FAMILIES = ("dense", "moe")


def serve_mesh_rules(cfg: ArchConfig, mesh) -> Any:
    """The default rule profile for the multi-device serving path: serve
    rules (weights TP over model + FSDP over data, cache batch / slot over
    data) with the KV-head divisibility adjustment."""
    from repro_torch.distributed import sharding as shd
    return shd.arch_rules(cfg, mesh, shd.serve_rules(mesh))


def make_param_placer(cfg: ArchConfig, mesh) -> Callable:
    """``(name, value) -> placed value`` for the streaming load on ``mesh``
    (this rank's view of it): each decoded tensor keeps this rank's block
    (:class:`~repro_torch.distributed.ctx.Sharded`) on ``mesh.device`` the
    moment it leaves the decoder, so the full tensor is freed chunk by
    chunk and host memory stays bounded as on one device.  QT / QT4
    triples get consistent q / scale / zero specs
    (:func:`repro_torch.distributed.sharding.leaf_shardings`); names the
    schema does not know replicate.

    The layout is per-tensor output-channel TP over model
    (:func:`repro_torch.distributed.sharding.serve_tp_table`) for the
    families whose weight reads gather at use (dense, moe) — the
    bit-identical profile; other families keep weights replicated (batch
    and cache still shard over data).  No weight shards over data: a data
    group that does not hold a slot skips its prefill, so a gather over
    data would lose its peers.
    """
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.ctx import shard
    axes = api.param_specs(cfg)
    exact_tp = cfg.family in EXACT_TP_FAMILIES
    replicate_all = shd.Rules({})
    dev = mesh.device

    def place(name: str, val: Any) -> Any:
        if name not in axes:
            return to_device(val, dev)
        r = (shd.serve_tp_table(cfg, mesh, axes[name]) if exact_tp
             else replicate_all)
        spec = shd.leaf_shardings(axes[name], val, r, mesh)
        if isinstance(val, (QT, QT4, QTG)):
            return type(val)(*(shard(p, s, mesh).to(dev)
                               for p, s in zip(val, spec)))
        return shard(val, spec, mesh).to(dev)

    return place


def local_bytes(tree: Any) -> int:
    """Bytes this rank holds for a placed tree of weights or cache leaves:
    a sharded leaf counts its block, a replicated one its whole."""
    from repro_torch.distributed.ctx import Sharded
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, Sharded):
        return tree.nbytes
    return tree.numel() * tree.element_size()


def per_device_bytes(tree: Any, mesh) -> Dict[Tuple[int, ...], int]:
    """Resident bytes per rank for a placed tree, keyed by rank coordinate
    (``(data, model)``): every rank gives its own and the world gathers
    them, so every rank of ``mesh`` must call it."""
    from repro_torch.distributed import collectives
    got = collectives.gather_object((mesh.key(), local_bytes(tree)))
    return dict(got)


def _batch_entry(specs: Dict[str, Any], cfg: ArchConfig, layout: str):
    """The mesh axes (a spec entry) the cache's batch / slot dim resolved
    to, the same for every leaf."""
    logical = "slot" if layout == "slot" else "batch"
    got = set()
    for k, axes in api.cache_specs(cfg, layout=layout).items():
        d = list(axes).index(logical)
        got.add(specs[k].padded(len(axes))[d])
    assert len(got) == 1, f"cache leaves disagree on the {logical} dim: {got}"
    return got.pop()


def row_block(mesh, entry, n: int) -> slice:
    """The rows of an ``n``-row batch this rank serves when the batch dim
    resolved to the spec entry ``entry`` (all rows when it is None)."""
    from repro_torch.distributed.ctx import block_index
    size, idx = block_index(mesh, entry)
    step = n // size
    return slice(idx * step, (idx + 1) * step)


def load_params_from_compressed(model: CompressedModel, *,
                                quantized: bool = True,
                                backend: Optional[str] = None,
                                chunk_symbols: Optional[int] = _DEFAULT_CHUNK,
                                stream: bool = True,
                                device=None,
                                placer: Optional[Callable] = None,
                                metrics: Optional[dict] = None
                                ) -> Dict[str, Any]:
    """Decode the container into serving weights on ``device``, streaming by
    default.

    quantized=True  -> {name: QT(q, scale, zero)} + fp32 leftovers (EntroLLM
                       path); 4-bit tensors pack nibble pairs into QT4 (0.5
                       bytes/param resident)
    quantized=False -> dense fp32 weights (baseline path)

    ``stream=True`` consumes :meth:`CompressedModel.iter_decode` chunk by
    chunk (``chunk_symbols``; ``None`` = one monolithic chunk), embedding
    first; ``stream=False`` decodes everything in one batch.  ``backend`` is
    a decoder-registry name (``numpy`` / ``torch`` / ``cuda``; None = follow
    ``device``).  ``device`` is ``cuda`` unless the caller names the CPU.

    ``placer`` overrides how a decoded tensor becomes a resident one:
    ``(name, value) -> placed value``, the value a tensor or QT / QT4
    triple on the host or the decoding device.  :func:`make_param_placer`
    builds the multi-device one (each rank keeps its block); the default
    moves the value to ``device``.

    When a ``metrics`` dict is passed it is filled with
    ``time_to_first_weight_s`` (start -> first decoded tensor resident),
    ``decode_load_s`` (total), and the resolved ``decode_backend`` name.
    """
    from repro_torch.core.decode_backends import get_backend
    dev = _device.resolve(device)
    t0 = time.perf_counter()
    ttfw: Optional[float] = None
    resolved = get_backend(backend, device=dev)

    if stream:
        kw = dict(backend=resolved, first=("embed",),
                  chunk_symbols=chunk_symbols)
        pairs = (model.iter_dequantize(**kw) if not quantized
                 else model.iter_quantized_weights(**kw))
    elif quantized:
        pairs = iter(model.quantized_weights(backend=resolved).items())
    else:
        pairs = iter(model.dequantize_all(backend=resolved).items())

    def place(name, v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        if placer is not None:
            return placer(name, v)
        return to_device(v, dev)

    out: Dict[str, Any] = {}
    with obs_trace.span("load.stream", cat="load", backend=resolved.name,
                        stream=stream, quantized=quantized):
        if quantized:
            for k, v in model.unquantized.items():
                out[k] = place(k, v)
        for name, val in pairs:
            if quantized and name in model.qmeta:
                q, scale, zero = val
                bits = model.qmeta[name]["bits"]
                if (not _quantizable_shape(name, model.tensors[name].shape)
                        or model.qmeta[name]["granularity"] == "per_group"):
                    # norm scales / biases quantized by an explicit rule, and
                    # per-group scales (which do not broadcast against the
                    # weight), dequantize at load like the JAX package
                    out[name] = place(name, model._dequantize_one(name, q))
                else:
                    out[name] = place(name, pack_qt(q, scale, zero,
                                                    bits=bits))
            else:
                out[name] = place(name, val)
            if ttfw is None:
                _device.synchronize(dev)
                ttfw = time.perf_counter() - t0
        _device.synchronize(dev)
    load_s = time.perf_counter() - t0
    obs_metrics.gauge("load.decode_load_s").set(load_s)
    obs_metrics.gauge("load.time_to_first_weight_s").set(
        ttfw if ttfw is not None else 0.0)
    obs_metrics.counter("load.decodes").inc(backend=resolved.name)
    if metrics is not None:
        metrics["time_to_first_weight_s"] = ttfw if ttfw is not None else 0.0
        metrics["decode_load_s"] = load_s
        metrics["decode_backend"] = resolved.name
    return out


def lockstep_batch(prompt: Any, device) -> Any:
    """A lockstep prompt on ``device``: (B, S) int64 tokens from a tensor
    or array, or encdec's batch dict with int64 ``tokens`` and bf16
    ``src_embeds`` (the stub frontend's frames)."""
    if isinstance(prompt, dict):
        return {"tokens": torch.as_tensor(prompt["tokens"], dtype=torch.int64,
                                          device=device),
                "src_embeds": torch.as_tensor(prompt["src_embeds"],
                                              device=device).to(
                                                  torch.bfloat16)}
    return torch.as_tensor(prompt, dtype=torch.int64, device=device)


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, S, V) logits -> (B,) int32 tokens from the last position: argmax
    when ``temperature <= 0`` (first index on ties, as ``jnp.argmax``),
    else a categorical draw from ``softmax(logits / temperature)``."""
    last = logits[:, -1]
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


class ServeSteps:
    """The per-architecture step functions every serving front end drives:
    :class:`Engine` (lockstep) and
    :class:`repro_torch.serving.batching.ContinuousEngine` (slot batch).
    ``decode_fn`` takes ``pos`` as an int (lockstep) or a ``(B,)`` tensor
    (per-slot positions); ``prefill_chunk_fn`` writes one prompt chunk at
    ``(B,)`` offsets.  With dense residency ``paged_decode_fn`` /
    ``paged_prefill_chunk_fn`` run the same steps over a paged block pool
    through a ``(B, max_blocks)`` block table; they are None for
    compressed residency (the paged KV cache rides dense residency only).

    ``resident="dense"`` (default) runs the whole-tree steps over a params
    dict.  ``resident="compressed"`` builds per-layer step loops instead:
    ``params`` must then be a
    :class:`repro_torch.serving.resident.CompressedResidentWeights`, and each
    step loops the layers in execution order, taking layer ``l``'s slot just
    before its block while the worker thread decodes layer ``l+1``.  The
    loops keep the step signatures, so :class:`Engine` drives either mode
    unchanged, and greedy decode is bit-identical between the two (the
    per-layer blocks mirror the loop bodies op for op).

    Multi-device: pass ``mesh`` (this rank's
    :class:`~repro_torch.launch.mesh.Mesh`), and each step runs under
    exact-TP :class:`~repro_torch.distributed.ctx.ShardingHints`: the
    weights, placed sharded at rest by :func:`make_param_placer`, are
    all-gathered at each use, so every op runs at the reference's shapes,
    except attention: for the
    :data:`EXACT_TP_FAMILIES` the KV heads split over the model axis as the
    cache spec resolves them, each rank attends over its block of heads
    and the outputs are gathered before ``wo`` (attention does not mix
    heads, so the gathered output is one device's bit for bit).  Engines
    ask :meth:`cache_shardings` which rows of the batch (or slot pool) this
    rank serves, and build caches with :attr:`local_heads_kw`.  The hints are
    installed for the step only, so co-resident single-device work never
    sees them.  Compressed residency is single-device (``mesh`` must stay
    None).

    ``hints`` replaces the exact-TP profile by sharded compute (the
    production cells' :class:`~repro_torch.distributed.ctx.ShardingHints`,
    ``exact_tp`` off; ``ep``, the MoE family's
    :class:`~repro_torch.models.moe.EPContext`, is installed beside them):
    each rank computes only its block, within a tolerance of one device.
    The cache is then placed by the reference's serving rules
    (``sharding.kv_serve_rules``): the KV heads over the model axis where
    whole heads divide it, the sequence over it otherwise, an SSM state's
    channels and heads over it; with ``long_context`` (the single-request
    long-context decode) its rows whole and its sequence over the data
    axes.  Every family; the paged twins are not offered (the pool rests
    whole).
    """

    def __init__(self, cfg: ArchConfig, sc: ServeConfig, *,
                 mesh=None, resident: str = "dense", hints=None, ep=None,
                 long_context: bool = False):
        if resident not in ("dense", "compressed"):
            raise ValueError(f"resident must be 'dense' or 'compressed', "
                             f"got {resident!r}")
        if resident == "compressed":
            if mesh is not None:
                raise NotImplementedError(
                    "compressed-resident serving is single-device (see "
                    "docs/SERVING.md §\"Which mode when\"); drop mesh= or "
                    "use resident='dense'")
            if not api.supports_resident_serving(cfg):
                raise NotImplementedError(
                    f"family {cfg.family!r} does not implement the per-layer "
                    f"weight-slot contract (embed_step / resident_block); "
                    f"supported today: dense, moe")
        self.cfg = cfg
        self.sc = sc
        self.mod = api.build(cfg)
        self.resident = resident
        self.mesh = mesh
        self.rules = None
        self.hints, self.ep = hints, ep
        self.cache_seq: tuple = ()
        self._cache_row_axes: tuple = ()
        self.head_axes: tuple = ()
        self.local_heads_kw: dict = {}
        self._cache_shardings_memo: dict = {}
        # paged twins (the block-pool cache layout, a block table as an
        # extra operand): dense residency only, as in the JAX package
        self.paged_decode_fn = self.paged_prefill_chunk_fn = None
        if resident == "compressed":
            self.prefill_fn = self._resident_prefill
            self.decode_fn = self._resident_step
            self.prefill_chunk_fn = self._resident_step
        elif api.supports_paged_kv(cfg):
            self.paged_decode_fn = self._paged_decode
            self.paged_prefill_chunk_fn = self._paged_prefill_chunk
        self._row_axes: tuple = ()
        if hints is not None:
            if mesh is None or hints.exact_tp:
                raise ValueError(
                    f"sharded-compute hints need a mesh and exact_tp off "
                    f"(exact_tp {hints.exact_tp})")
            self.paged_decode_fn = self.paged_prefill_chunk_fn = None
        if mesh is not None:
            from repro_torch.distributed import sharding as shd
            rules = serve_mesh_rules(cfg, mesh)
            if hints is not None:
                rules, _ = shd.kv_serve_rules(cfg, mesh,
                                              long_context=long_context)
                rules = shd.arch_rules(cfg, mesh, rules)
                self.cache_seq = shd.entry_axes(shd.resolve_spec(
                    ("kv_seq",), (sc.max_len,), rules, mesh).padded(1)[0])
            elif cfg.family in EXACT_TP_FAMILIES:
                # the mesh axes the KV heads split over, as the cache's
                # "kv" dim resolves (none unless whole heads divide them)
                self.head_axes = shd.entry_axes(shd.resolve_spec(
                    ("kv",), (cfg.n_kv_heads,), rules, mesh).padded(1)[0])
            else:       # this family's attention keeps every head
                rules = shd.Rules(dict(rules.table, kv=None))
            self.rules = rules
            if self.head_axes:
                self.local_heads_kw = {"kv_heads": cfg.n_kv_heads //
                                       shd.mesh_prod(mesh, self.head_axes)}
            scoped = self._scoped(mesh)
            self.prefill_fn = scoped(self.prefill_fn)
            self.decode_fn = scoped(self.decode_fn)
            self.prefill_chunk_fn = scoped(self.prefill_chunk_fn)
            if self.paged_decode_fn is not None:
                self.paged_decode_fn = scoped(self.paged_decode_fn)
                self.paged_prefill_chunk_fn = scoped(
                    self.paged_prefill_chunk_fn)

    @contextlib.contextmanager
    def rows_over(self, axes: tuple, cache_axes: Optional[tuple] = None):
        """Steps called inside take batch rows split over the mesh ``axes``
        (this rank's block; ``()`` for rows every rank of the data axes
        holds alike): the hints say so to the layers whose semantics span
        the whole batch (the MoE dispatch's shared capacity), which gather
        the rows they need.  ``cache_axes`` (sharded compute) names the
        axes the cache's rows split over when they differ: rows whole
        (``axes`` empty) over a cache split by rows, the weight-stationary
        decode."""
        cache_axes = tuple(axes) if cache_axes is None else tuple(cache_axes)
        if cache_axes != tuple(axes) and axes:
            raise ValueError(f"rows split over {axes} with a cache split "
                             f"over {cache_axes}")
        prev = self._row_axes, self._cache_row_axes
        self._row_axes = tuple(axes)
        self._cache_row_axes = () if cache_axes == tuple(axes) else cache_axes
        try:
            yield
        finally:
            self._row_axes, self._cache_row_axes = prev

    def _scoped(self, mesh) -> Callable:
        """Wrap a step so it runs under the exact-TP hints (weights gathered
        at use, attention over this rank's heads, no activation
        constraint) or under the sharded-compute hints given (with this
        step's rows and the cache's placement, and the EP context),
        restoring whatever was installed before."""
        from repro_torch.distributed.ctx import (ShardingHints, get_hints,
                                                 set_hints)
        from repro_torch.models import moe

        def step_hints():
            if self.hints is not None:
                return dataclasses.replace(
                    self.hints, batch_axes=self._row_axes,
                    cache_seq_axes=self.cache_seq,
                    cache_batch_axes=self._cache_row_axes)
            return ShardingHints(
                mesh=mesh, batch_axes=self._row_axes, model_axis=None,
                kv_seq_axes=(), seq_sp=False, exact_tp=True,
                head_axes=self.head_axes)

        def scoped(fn):
            def run(*args):
                prev, prev_ep = get_hints(), moe.get_ep_context()
                set_hints(step_hints())
                if self.hints is not None:
                    moe.set_ep_context(self.ep)
                try:
                    return fn(*args)
                finally:
                    set_hints(prev)
                    moe.set_ep_context(prev_ep)
            return run
        return scoped

    def cache_shardings(self, batch: int, *, layout: str = "batch",
                        **cache_kw) -> Optional[dict]:
        """The specs of this config's cache as each rank holds it on the
        serve mesh (None on one device), memoized by shape and options: the
        batch / slot rows over data and, for the :data:`EXACT_TP_FAMILIES`,
        the KV heads over model where whole heads divide it (the serve
        rules' resolution; other families' heads stay whole under exact
        TP).  Under sharded-compute hints the reference's serving rules
        place it: the KV heads over model where whole heads divide it, the
        sequence over model (or the data axes, long context) where they do
        not, and an SSM state's inner channels and heads over model.  Under
        exact TP every other dim is whole on every rank: the steps compute
        it at the reference's width."""
        if self.mesh is None:
            return None
        key = (batch, layout, tuple(sorted(cache_kw.items())))
        if key not in self._cache_shardings_memo:
            from repro_torch.distributed import sharding as shd
            specs = shd.cache_shardings(
                self.cfg, self.mesh, self.rules, batch, self.sc.max_len,
                layout=layout, **cache_kw)
            logical = api.cache_specs(self.cfg, layout=layout, **cache_kw)
            split = ("batch", "slot", "kv") + (
                ("kv_seq", "mlp", "heads") if self.hints is not None
                else ())
            self._cache_shardings_memo[key] = {
                k: shd.P(*[e if a in split else None for a, e in
                           zip(logical[k], s.padded(len(logical[k])))])
                .trimmed() for k, s in specs.items()}
        return self._cache_shardings_memo[key]

    def batch_rows(self, batch: int, *, layout: str = "batch") -> slice:
        """The rows of a ``batch``-row cache this rank holds and steps: the
        block of the batch / slot dim at this rank's coordinate over the
        axes it resolved to (every row on one device)."""
        if self.mesh is None:
            return slice(0, batch)
        entry = _batch_entry(self.cache_shardings(batch, layout=layout),
                             self.cfg, layout)
        return row_block(self.mesh, entry, batch)

    def batch_axes(self, batch: int, *, layout: str = "batch") -> tuple:
        """The mesh axes the batch / slot dim of a ``batch``-row cache
        shards over (empty on one device or when it replicates)."""
        if self.mesh is None:
            return ()
        from repro_torch.distributed.sharding import entry_axes
        return entry_axes(_batch_entry(
            self.cache_shardings(batch, layout=layout), self.cfg, layout))

    def prefill_fn(self, params, prompt: torch.Tensor):
        return self.mod.prefill(self.cfg, params, prompt,
                                max_len=self.sc.max_len,
                                q_block=self.sc.q_block)

    def decode_fn(self, params, token: torch.Tensor, cache, pos):
        return self.mod.decode_step(self.cfg, params, token, cache, pos)

    def prefill_chunk_fn(self, params, tokens: torch.Tensor, cache,
                         pos: torch.Tensor):
        return self.mod.prefill_chunk(self.cfg, params, tokens, cache, pos)

    def _paged_decode(self, params, token: torch.Tensor, pool,
                      bt: torch.Tensor, pos: torch.Tensor):
        return self.mod.paged_decode_step(self.cfg, params, token, pool, bt,
                                          pos)

    def _paged_prefill_chunk(self, params, tokens: torch.Tensor, pool,
                             bt: torch.Tensor, pos: torch.Tensor):
        return self.mod.paged_prefill_chunk(self.cfg, params, tokens, pool,
                                            bt, pos)

    # ------------------------------------------------- compressed residency
    def _resident_prefill(self, weights, prompt: torch.Tensor):
        """Per-layer twin of ``prefill``: full causal attention per layer, each
        layer's (k, v) written into the zero-padded cache row as it is
        produced."""
        B, S = prompt.shape
        dev = prompt.device
        x = self.mod.embed_step(self.cfg, weights.globals, prompt)
        positions = torch.arange(S, device=dev)
        cache = self.mod.init_cache(self.cfg, B, self.sc.max_len,
                                    device=dev)
        weights.prefetch(0)
        for l in range(weights.n_layers):
            with obs_trace.span("serve.layer", layer=l, phase="prefill"):
                lp = weights.get(l)
                weights.prefetch((l + 1) % weights.n_layers)
                x, (k, v) = self.mod.resident_prefill_block(
                    self.cfg, lp, x, positions=positions,
                    q_block=self.sc.q_block)
                cache["k"][l, :, :S] = k
                cache["v"][l, :, :S] = v
                _fence(dev)
        return self.mod.head_step(self.cfg, weights.globals, x,
                                  last_only=True), cache

    def _resident_step(self, weights, tokens: torch.Tensor, cache, pos):
        """Per-layer twin of ``decode_step`` AND ``prefill_chunk`` (the
        block reads S from the token shape; ``pos`` passes through, an int
        or a (B,) tensor): ``get(l)`` returns layer l's slot (usually
        already decoded by the worker), ``prefetch(l+1)`` starts the next
        layer's decode, and the wrap-around prefetch primes layer 0 for the
        next step."""
        x = self.mod.embed_step(self.cfg, weights.globals, tokens)
        weights.prefetch(0)
        for l in range(weights.n_layers):
            with obs_trace.span("serve.layer", layer=l, phase="step"):
                lp = weights.get(l)
                weights.prefetch((l + 1) % weights.n_layers)
                x, cache = self.mod.resident_block(self.cfg, lp, x, cache, l,
                                                   pos)
                _fence(tokens.device)
        return self.mod.head_step(self.cfg, weights.globals, x), cache


class Engine:
    """Lockstep serving: one fixed-shape batch per ``generate`` call, on
    ``device`` (``cuda`` unless the caller names the CPU).

    ``resident="compressed"`` serves straight from the entropy-coded
    container: pass a :class:`repro_torch.serving.resident.
    CompressedResidentWeights` as ``params``."""

    def __init__(self, cfg: ArchConfig, params: Any, sc: ServeConfig, *,
                 device=None, resident: str = "dense", mesh=None):
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.device = _device.resolve(device if mesh is None
                                      else mesh.device)
        self.steps = ServeSteps(cfg, sc, mesh=mesh, resident=resident)
        self.cache_bytes = 0

    @torch.inference_mode()
    def generate(self, prompt, steps: int, *, seed: int = 0,
                 echo_metrics: bool = False):
        """prompt: (B, S) int tokens (tensor or array), or for encdec the
        batch dict ``{"tokens": (B, S), "src_embeds": (B, S_src, D)}``.
        Returns (B, steps) int32 tokens on the engine's device (and the
        metrics view when ``echo_metrics``).

        On a mesh every rank passes the whole batch, serves the rows of it
        the resolved cache spec gives its data coordinate, and returns the
        whole ``(B, steps)`` array, gathered over the data axes."""
        prompt = lockstep_batch(prompt, self.device)
        B, S = (prompt["tokens"] if isinstance(prompt, dict)
                else prompt).shape
        rows, axes = self.steps.batch_rows(B), self.steps.batch_axes(B)
        if rows != slice(0, B):
            prompt = ({k: v[rows] for k, v in prompt.items()}
                      if isinstance(prompt, dict) else prompt[rows])
        with self.steps.rows_over(axes):
            return self._generate(prompt, B, S, axes, steps, seed,
                                  echo_metrics)

    def _generate(self, prompt, B: int, S: int, axes: tuple, steps: int,
                  seed: int, echo_metrics: bool):
        dev = self.device
        sync: Callable[[], None] = lambda: _device.synchronize(dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        with obs_trace.span("serve.prefill"):
            logits, cache = self.steps.prefill_fn(self.params, prompt)
            sync()
        t_prefill = time.perf_counter() - t0
        toks = []
        tok = sample(logits, self.sc.temperature, gen)[:, None]
        sync()
        t_first_token = time.perf_counter() - t0
        toks.append(tok)
        t1 = time.perf_counter()
        step_hist = obs_metrics.histogram("serve.decode_step_s")
        for i in range(steps - 1):
            ts = time.perf_counter()
            with obs_trace.span("serve.decode_step", step=i):
                logits, cache = self.steps.decode_fn(
                    self.params, tok.to(torch.int64), cache, S + i)
                tok = sample(logits, self.sc.temperature, gen)[:, None]
                toks.append(tok)
                _fence(dev)
            step_hist.observe(time.perf_counter() - ts)
        out = torch.cat(toks, dim=1)
        if axes:                    # the other data groups' rows
            from repro_torch.distributed import collectives
            out = collectives.all_gather(self.steps.mesh, out, 0, axes)
        self.cache_bytes = local_bytes(cache)
        sync()
        t_decode = time.perf_counter() - t1
        decode_tps = B * max(steps - 1, 1) / max(t_decode, 1e-9)
        e2e_tps = B * steps / max(time.perf_counter() - t0, 1e-9)
        obs_metrics.gauge("serve.prefill_s").set(t_prefill)
        obs_metrics.gauge("serve.decode_s").set(t_decode)
        obs_metrics.gauge("serve.ttft_s").set(t_first_token)
        obs_metrics.gauge("serve.decode_tok_per_s").set(decode_tps)
        obs_metrics.gauge("serve.e2e_tok_per_s").set(e2e_tps)
        obs_metrics.counter("serve.tokens").inc(B * steps)
        if echo_metrics:
            return out, obs_metrics.LegacyMetricsView(
                obs_metrics.default_registry(), _LEGACY_GENERATE_KEYS)
        return out
