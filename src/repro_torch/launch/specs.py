"""Cell builders: (architecture x input shape x mesh) -> this rank's step
(PyTorch port of ``repro/launch/specs.py``).

``build_cell`` returns what ``dryrun.py`` runs for one roofline cell: the
step function (the train step, the serving prefill or one decode step, by
the shape's kind) and its arguments as this rank holds them — ``meta``
tensors in rank 0's shard shapes on the production mesh, so nothing is
allocated.  :meth:`Cell.materialize` makes the same arguments real on a
device (random values from a seed), which is how the card runs a cell that
the dry-run priced; :meth:`Cell.place` cuts whole weights one device holds
into this rank's blocks instead.

Placement is the port's, through ``distributed/sharding.py`` (whose specs
equal the reference's on the production meshes):

* weights rest as the reference's rules resolve them — serving cells by
  the serve rules with the KV-head adjustment, train cells by the ZeRO
  (optimizer-state) rules, where the fp32 moments rest too;
* every serving cell computes sharded, as the reference's do under the
  hints of :func:`_install_contexts`: each rank computes its block (heads
  over model — attention's and an SSM's —, FSDP blocks gathered at use,
  row-parallel partial sums reduced, the prefill carries split along S
  over model but the hybrid's), and the cache rests by the reference's
  ``_serve_rules`` — rows over data, the KV heads over model where whole
  heads divide it, the sequence over model otherwise (attended block by
  block with an exact combine), an SSM state's channels and heads over
  model; ``serve_mode="stationary"`` is the reference's weight-stationary
  decode (rows whole, D over the data axes, no weight gathered).
  :meth:`Cell.place` re-blocks an SSM's ``in_zx`` so that each rank's
  block of its ``[z | x]`` columns is its heads' (``mamba2.zx_blocks``);
* every train cell computes sharded too, under the reference's
  train-cell hints (rows over data, ``seq_sp`` for every family but the
  hybrid, the MoE and hybrid families' EP context), every collective
  carrying its backward, an SSM's ``in_zx`` (the hybrid's Mamba
  positions' too) re-blocked as the serving cells' is
  (``train_loop.zx_split``); ``meta["compute"]`` says so (a family left
  out of ``SHARDED_TRAIN_FAMILIES`` would keep exact TP — weights
  all-gathered at use, each rank repeating its rows' full-width compute
  along model).  ``q8_gather=`` and ``grad_compress=`` are the
  reference's options.

Weight formats for serving cells: ``bf16``, ``int8`` (QT triples, uint8
symbols dequantized at use) and ``int4`` (QT4, nibbles packed along the
last axis).  Training always uses the schema dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES
from repro_torch.core.spec import quantizable_shape
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.ctx import (ShardingHints, Sharded, block_index,
                                         local_block, shard)
from repro_torch.models import api, mamba2
from repro_torch.models.layers import QT, QT4
from repro_torch.models.moe import EPContext
from repro_torch.serving import engine
from repro_torch.training import optimizer as opt, train_loop

# Activation budget for choosing grad-accum microbatching (bytes per chip of
# saved layer carries; remat recomputes everything else).
ACT_BUDGET = 2 << 30
# Optimizer-moment format switches to EntroLLM-uint8 above this param count.
Q8_OPT_THRESHOLD = 100e9
# query-block length of the long-sequence cells' attention
Q_BLOCK = 1024
LONG_SEQ = 8192


@dataclasses.dataclass
class Cell:
    cfg: ArchConfig
    shape: ShapeConfig
    mesh: Any
    fn: Callable
    args: Tuple[Any, ...]
    meta: Dict[str, Any]
    param_specs: Optional[Dict[str, Any]] = None
    row_axes: Tuple[str, ...] = ()
    cache_specs: Optional[Dict[str, Any]] = None

    def run(self):
        return self.fn(*self.args)

    def place(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Whole weights (a tensor, or a QT / QT4 triple, a name) cut into
        the blocks this rank holds by the cell's specs: the weight
        argument of a serving cell, real."""
        out = {}
        for name, w in params.items():
            sp = self.param_specs[name]
            if name.endswith("/in_zx"):
                w = _zx_blocks(w, sp, self.mesh)
            if isinstance(w, (QT, QT4)):
                out[name] = type(w)(*(_place(p, ps, self.mesh)
                                      for p, ps in zip(w, sp)))
            else:
                out[name] = _place(w, sp, self.mesh)
        return out

    def local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (B, ...) batch input, as the cell's
        step takes them (all of them when its rows are whole)."""
        if not self.row_axes:
            return t
        e = self.row_axes if len(self.row_axes) > 1 else self.row_axes[0]
        return local_block(t, (e,), self.mesh)

    def materialize(self, device, seed: int = 0) -> Tuple[Any, ...]:
        """The arguments made real on ``device``: random symbols and
        weights of the published init scale (norms one), tokens below the
        vocabulary, zero caches; ints pass through."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return tuple(_real(a, "", self.cfg, device, gen) for a in self.args)


def _zx_blocks(w: Any, spec, mesh) -> Any:
    """An SSM's whole ``in_zx`` (a tensor or a QT / QT4 triple) re-blocked
    for its spec (:func:`repro_torch.models.mamba2.zx_blocks`): the
    contiguous block of its columns each rank keeps holds the rank's
    heads' z and x columns."""
    q_spec = spec[0] if isinstance(w, (QT, QT4)) else spec
    n = block_index(mesh, q_spec.padded(3)[-1])[0]
    if isinstance(w, (QT, QT4)):
        return type(w)(mamba2.zx_blocks(w.q, n), w.scale, w.zero)
    return mamba2.zx_blocks(w, n)


_CACHE_LEAVES = ("k", "v", "xk", "xv", "conv_x", "conv_bc", "ssm")


def _zeros(x: Any) -> Any:
    if isinstance(x, dict):
        return {k: _zeros(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_zeros(v) for v in x))
    return torch.zeros(x.shape, dtype=x.dtype, device=x.device)


def _real(x: Any, name: str, cfg: ArchConfig, device, gen) -> Any:
    if isinstance(x, opt.OptState):
        return _zeros(opt.OptState(*(_to(v, device) for v in x)))
    if isinstance(x, dict):
        return {k: _real(v, k, cfg, device, gen) for k, v in x.items()}
    if isinstance(x, (QT, QT4)):
        # symbols uniform over the grid, mapped onto [-0.02, 0.02]
        q = _real(x.q, name, cfg, device, gen)
        qmax = 255 if isinstance(x, QT) else 15
        scale = torch.full(x.scale.shape, 0.04 / qmax, dtype=x.scale.dtype,
                           device=device)
        zero = torch.full(x.zero.shape, -0.02, dtype=x.zero.dtype,
                          device=device)
        return type(x)(q, scale, zero)
    if isinstance(x, Sharded):
        return Sharded(_real(x.local, name, cfg, device, gen), x.spec)
    if not isinstance(x, torch.Tensor):
        return x
    if x.dtype in (torch.int32, torch.int64, torch.uint8):
        high = 256 if x.dtype == torch.uint8 else cfg.vocab
        return torch.randint(0, high, x.shape, generator=gen,
                             device=device, dtype=torch.int32).to(x.dtype)
    if name in _CACHE_LEAVES:
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    if "norm" in name or name.endswith("D_skip"):
        return torch.ones(x.shape, dtype=x.dtype, device=device)
    w = torch.randn(x.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return (0.02 * w).to(x.dtype)


def _to(x: Any, device) -> Any:
    """A tree of ``meta`` leaves as empty tensors on ``device``."""
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(_to(v, device) for v in x))
    return torch.empty(x.shape, dtype=x.dtype, device=device)


# ------------------------------------------------------------------ utilities

def _batch_ways(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _place(t: torch.Tensor, spec, mesh):
    """``t`` (``meta``) as this rank holds it under ``spec``."""
    return shard(t, tuple(spec) + (None,) * (t.dim() - len(spec)), mesh)


def param_structs(cfg: ArchConfig, mesh, rules: shd.Rules,
                  weights: str = "bf16") -> Tuple[Dict, Dict]:
    """(this rank's parameters as ``meta`` values, their specs): a tensor,
    a :class:`~repro_torch.distributed.ctx.Sharded` block, or a QT / QT4
    triple of them.  Quantized triples shard their symbols like the weight
    and replicate the per-layer scale and zero, as the reference does."""
    sch = api.build(cfg).schema(cfg)
    structs: Dict[str, Any] = {}
    specs: Dict[str, Any] = {}
    for name, spec in sch.items():
        ps = shd.resolve_spec(spec.axes, spec.shape, rules, mesh)
        if weights == "bf16" or not quantizable_shape(name, spec.shape):
            structs[name] = _place(_meta(spec.shape, spec.dtype), ps, mesh)
            specs[name] = ps
            continue
        # per-layer (axis-0 channel) scales: broadcastable against q
        sshape = (spec.shape[0],) + (1,) * (len(spec.shape) - 1)
        s = _meta(sshape, torch.float32)
        if weights == "int8":
            structs[name] = QT(_place(_meta(spec.shape, torch.uint8), ps,
                                      mesh), s, s.clone())
            specs[name] = QT(ps, shd.P(), shd.P())
        elif weights == "int4":
            pshape = spec.shape[:-1] + (spec.shape[-1] // 2,)
            pps = shd.resolve_spec(spec.axes, pshape, rules, mesh)
            structs[name] = QT4(_place(_meta(pshape, torch.uint8), pps,
                                       mesh), s, s.clone())
            specs[name] = QT4(pps, shd.P(), shd.P())
        else:
            raise ValueError(weights)
    return structs, specs


def _install_contexts(cfg: ArchConfig, mesh, *, batch_sharded: bool,
                      kv_seq_axes: Tuple[str, ...] = (),
                      feature_axes: Tuple[str, ...] = (),
                      train: bool = False
                      ) -> Tuple[ShardingHints, Optional[EPContext]]:
    """The reference's sharded-compute hints and, for the MoE family, its
    EP context, for a serving cell (its ``ServeSteps`` installs them
    around each step it runs) or, with ``train``, a train cell (the train
    step installs them; ``grad_axes`` the data axes, over which the rank
    losses are summed).  The reference installs them process-wide.
    Sequence-parallel carries for every family but the hybrid, as in the
    reference."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    ep = EPContext(mesh=mesh, model_axis="model", data_axes=data_axes,
                   batch_sharded=batch_sharded) if cfg.moe else None
    hints = ShardingHints(
        mesh=mesh, batch_axes=data_axes if batch_sharded else (),
        model_axis="model", kv_seq_axes=tuple(kv_seq_axes),
        feature_axes=tuple(feature_axes), seq_sp=cfg.family != "hybrid",
        grad_axes=data_axes if train else ())
    return hints, ep


# the families whose train cells compute sharded (the others keep exact TP)
SHARDED_TRAIN_FAMILIES = train_loop.SHARDED_TRAIN_FAMILIES


def train_contexts(cfg: ArchConfig, mesh
                   ) -> Tuple[Optional[ShardingHints], Optional[EPContext]]:
    """The hints and EP context a train cell's step computes under: the
    reference's (:func:`_install_contexts`, rows over data) for
    ``SHARDED_TRAIN_FAMILIES``, none (exact TP) for the others."""
    if cfg.family not in SHARDED_TRAIN_FAMILIES:
        return None, None
    return _install_contexts(cfg, mesh, batch_sharded=True, train=True)


def _batch_struct(cfg: ArchConfig, B: int, S: int, *, train: bool) -> Dict:
    toks = _meta((B, S + 1 if train else S), torch.int32)
    if cfg.family == "encdec":
        return {"tokens": toks,
                "src_embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
    return {"tokens": toks}


def _local_rows(batch: Dict[str, torch.Tensor], mesh, rules: shd.Rules
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each batch leaf (``batch_sharding``'s spec)."""
    return {k: local_block(v, shd.batch_sharding(mesh, rules, v.shape)
                           .padded(v.dim()), mesh).clone()
            for k, v in batch.items()}


def pick_microbatches(cfg: ArchConfig, shape: ShapeConfig, mesh) -> int:
    """Smallest grad-accum split whose saved layer carries fit ACT_BUDGET."""
    ways = _batch_ways(mesh)
    B_loc = max(1, shape.global_batch // ways)
    D = cfg.d_model
    L = cfg.n_layers
    carry = L * shape.seq_len * D * 2            # bytes per local batch row
    target = max(1, int(ACT_BUDGET // max(carry, 1)))
    mb = 1
    while B_loc // mb > target and mb < B_loc:
        mb *= 2
    # every microbatch must cover the batch mesh axes
    return min(mb, max(shape.global_batch // ways, 1))


def _names(meta: Dict[str, Any], mesh) -> Dict[str, Any]:
    return dict(meta, mesh="x".join(str(mesh.shape[a])
                                    for a in mesh.axis_names))


# ---------------------------------------------------------------- cell builds

def build_train_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                     microbatches: Optional[int] = None,
                     grad_compress: bool = False,
                     q8_gather: int = 0) -> Cell:
    """The train step of this rank: params and fp32 (or, from
    ``Q8_OPT_THRESHOLD`` parameters, uint8) moments in their ZeRO blocks,
    the batch's rows over data, remat on, attention in query blocks past
    ``LONG_SEQ``; sharded compute for ``SHARDED_TRAIN_FAMILIES``, exact TP
    for the others.  ``q8_gather`` (8 or 4) gathers EntroLLM-quantized
    weights, ``grad_compress`` compresses the summed gradient, as the
    reference's options do."""
    q8 = cfg.param_count() >= Q8_OPT_THRESHOLD
    mb = microbatches or pick_microbatches(cfg, shape, mesh)
    tc = train_loop.TrainConfig(
        opt=opt.AdamWConfig(quantized_state=q8),
        grad_accum_dtype="bf16" if q8 else "f32",
        q8_gather=q8_gather, grad_compress=grad_compress,
        microbatches=mb, remat=True,
        q_block=Q_BLOCK if shape.seq_len > LONG_SEQ else 0)
    specs = train_loop.train_shardings(cfg, mesh)
    sch = api.build(cfg).schema(cfg)
    params = {n: _place(_meta(s.shape, s.dtype), specs[n], mesh)
              for n, s in sch.items()}
    local = {n: p.local if isinstance(p, Sharded) else p
             for n, p in params.items()}
    ostate = opt.init_state(tc.opt, local,
                            shapes={n: s.shape for n, s in sch.items()})
    rules = shd.arch_rules(cfg, mesh, shd.train_rules(mesh))
    batch = _local_rows(_batch_struct(cfg, shape.global_batch,
                                      shape.seq_len, train=True), mesh, rules)
    hints, ep = train_contexts(cfg, mesh)
    sharded = hints is not None
    fn = train_loop.make_train_step(cfg, tc, mesh, hints=hints, ep=ep)
    return Cell(cfg=cfg, shape=shape, mesh=mesh, fn=fn,
                args=(params, ostate, batch),
                meta=_names({"kind": "train", "microbatches": mb,
                             "q8_opt": q8, "weights": "bf16",
                             "q_block": tc.q_block,
                             "param_rules": "opt_state",
                             "compute": "sharded" if sharded else "exact TP",
                             "q8_gather": q8_gather,
                             "grad_compress": grad_compress}, mesh))


def _cache_struct(cfg: ArchConfig, steps, B: int, S: int):
    """This rank's ``meta`` cache of a ``B``-row batch, placed as the
    serving engine places it (rows over data, KV heads over model where the
    family splits them)."""
    full = api.build(cfg).init_cache(cfg, B, S, device="meta")
    specs = steps.cache_shardings(B)
    return {k: local_block(v, specs[k].padded(v.dim()), steps.mesh).clone()
            for k, v in full.items()}, specs


def _port_kv(specs: Dict[str, Any]) -> Dict[str, str]:
    """The port's cache placement: ``kv_port``, the axes the ``k`` leaf's
    T rests on (the form of ``kv_seq_reference``), and ``kv_port_spec``,
    one word a dim."""
    if "k" not in specs:
        return {"kv_port": "-", "kv_port_spec": "-"}
    e = specs["k"].padded(5)

    def word(x):
        return "-" if x is None else "+".join(shd.entry_axes(x))
    return {"kv_port": word(e[2]),
            "kv_port_spec": ",".join(word(x) for x in e)}


def _steps(cfg: ArchConfig, sc, mesh, long_context: bool = False,
           **ctx_kw):
    """The cell's ``ServeSteps``: sharded compute under the reference's
    hints, the cache placed by its serving rules."""
    hints, ep = _install_contexts(cfg, mesh, **ctx_kw)
    return engine.ServeSteps(cfg, sc, mesh=mesh, hints=hints, ep=ep,
                             long_context=long_context)


def build_prefill_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                       weights: str = "int8",
                       max_len: Optional[int] = None) -> Cell:
    """The prefill of a ``B x S`` prompt into a cache of ``max_len`` rows
    (``S`` by default, as in the reference), this rank's rows of it."""
    rules, kv_seq = shd.kv_serve_rules(cfg, mesh, long_context=False)
    rules = shd.arch_rules(cfg, mesh, rules)
    B, S = shape.global_batch, shape.seq_len
    sc = engine.ServeConfig(max_len=max_len or S,
                            q_block=Q_BLOCK if S > LONG_SEQ else 0)
    params, pspecs = param_structs(cfg, mesh, rules, weights)
    steps = _steps(cfg, sc, mesh, batch_sharded=True)
    if cfg.family == "encdec":
        prompt = _local_rows(_batch_struct(cfg, B, S, train=False), mesh,
                             rules)
    else:
        prompt = _local_rows({"tokens": _meta((B, S), torch.int32)}, mesh,
                             rules)["tokens"]
    axes = steps.batch_axes(B)

    def prefill_step(p, prompt):
        with steps.rows_over(axes):
            return steps.prefill_fn(p, prompt)

    specs = steps.cache_shardings(B)
    return Cell(cfg=cfg, shape=shape, mesh=mesh, fn=prefill_step,
                args=(params, prompt), param_specs=pspecs, row_axes=axes,
                cache_specs=specs,
                meta=_names({"kind": "prefill", "weights": weights,
                             "q_block": sc.q_block,
                             "sharded_compute": steps.hints is not None,
                             "kv_seq_reference": "+".join(kv_seq) or "-",
                             **_port_kv(specs)}, mesh))


def build_decode_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                      weights: str = "int8", serve_mode: str = "fsdp",
                      kv_bits: int = 16) -> Cell:
    """One decode step at the last position of a full ``S``-row cache.

    ``serve_mode``:

    * ``fsdp``: weights at rest by the serve rules, rows over data, each
      rank computing its block (FSDP blocks gathered at use);
    * ``stationary``: the reference's weight-stationary decode — weights
      never move: the rows replicate over the data axes, the carry's D
      rides them (``feature_axes``), each projection is a partial dot
      summed over them, the experts' hidden dim rests over them, and only
      the cache stays split by rows (and sequence)."""
    if serve_mode not in ("fsdp", "stationary"):
        raise ValueError(f"serve_mode must be 'fsdp' or 'stationary', got "
                         f"{serve_mode!r}")
    stationary = serve_mode == "stationary"
    if kv_bits != 16:
        raise NotImplementedError("the dry-run's decode cells take the bf16 "
                                  "cache (kv_bits=16)")
    long_context = shape.name == "long_500k"
    rules, kv_seq = shd.kv_serve_rules(cfg, mesh,
                                       long_context=long_context)
    rules = shd.arch_rules(cfg, mesh, rules)
    B, S = shape.global_batch, shape.seq_len
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    batch_sharded = (not stationary) and B % _batch_ways(mesh) == 0
    if stationary:
        # the expert FFN's hidden dim rides the data axes (x replicates
        # there); dense weights keep embed -> data for the partial dot
        rules = shd.Rules({**rules.table, "expert_embed": None,
                           "expert_mlp": data_axes})
    io_rules = rules if not stationary else shd.Rules(
        {**rules.table, "batch": ()})
    sc = engine.ServeConfig(max_len=S)
    params, pspecs = param_structs(cfg, mesh, rules, weights)
    steps = _steps(cfg, sc, mesh, long_context, batch_sharded=batch_sharded,
                   kv_seq_axes=kv_seq,
                   feature_axes=data_axes if stationary else ())
    cache, cspecs = _cache_struct(cfg, steps, B, S)
    token = _local_rows({"t": _meta((B, 1), torch.int32)}, mesh,
                        io_rules)["t"]
    cache_axes = steps.batch_axes(B)
    axes = () if stationary else cache_axes

    def serve_step(p, token, cache, pos):
        with steps.rows_over(axes, cache_axes):
            return steps.decode_fn(p, token, cache, pos)

    return Cell(cfg=cfg, shape=shape, mesh=mesh, fn=serve_step,
                args=(params, token, cache, S - 1), param_specs=pspecs,
                row_axes=axes, cache_specs=cspecs,
                meta=_names({"kind": "decode", "weights": weights,
                             "kv_bits": kv_bits, "serve_mode": serve_mode,
                             "long_context": long_context,
                             "sharded_compute": steps.hints is not None,
                             "kv_seq_reference": "+".join(kv_seq) or "-",
                             **_port_kv(cspecs)}, mesh))


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               weights: str = "int8", **kw) -> Cell:
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, weights=weights, **kw)
    return build_decode_cell(cfg, shape, mesh, weights=weights, **kw)


def all_cells(archs: Dict[str, ArchConfig]) -> list:
    """The 40 assigned cells as (arch_name, shape_name, applicable)."""
    out = []
    for a, cfg in archs.items():
        for s, sc in SHAPES.items():
            out.append((a, s, sc.applicable(cfg)))
    return out
