"""Training step and loop (PyTorch port of ``repro/training/train_loop.py``):
gradient accumulation over microbatches, the optional compressed weight
gather and gradient compression, metrics.

The JAX package jits the step and scans over microbatches inside it; the
port runs the same arithmetic eagerly: each microbatch is sliced from the
leading batch axis, its gradients come from ``torch.autograd.grad`` and are
summed in ``grad_accum_dtype``, then scaled by ``1 / microbatches`` in
float32.  Its ``unroll`` (a scan knob) has no eager counterpart.

On a mesh (``make_train_step(..., mesh=)``) each rank holds its blocks of
the parameters and moments, placed as :func:`shard_train_state` places them
(the ZeRO rules: ``optimizer.state_shardings`` over
``sharding.opt_state_rules``, params where their moments are), and this
rank's rows of the batch (:func:`shard_batch`).  The rank losses are
summed over the data axes: the step scales each by 1 / |data| before the
backward and reports their sum over data.  Two modes:

* **exact TP** (the default): each weight is all-gathered whole at use,
  and its gradient comes back to this rank's block summed over the data
  axes (``distributed.ctx._GatherAtUse``).  Each rank's loss is its rows'
  mean, and every rank along the model axis repeats its rows' compute at
  the reference's shapes (|model| times the work);
* **sharded compute** (``hints=``, the reference's train-cell hints of
  ``launch/specs.py``; ``ep=`` the MoE family's EP context): each rank
  computes its block — FSDP blocks gathered at use and reduce-scattered
  back, column- and row-parallel products, a rank's heads and experts,
  sequence-parallel carries — every collective carrying its backward
  (``distributed/collectives.py``).  The loss is the mean over the global
  batch on every rank.

A family that trains sharded rests an SSM's ``in_zx`` re-blocked, each
model rank's columns its heads' ``[z_r | x_r]`` (:func:`zx_split`): the
params, moments, gradients and ``q8_gather`` symbols hold that order, and
:func:`gather_params` and the gradient compression read one device's.

Either way a gradient is summed over exactly the axes its uses were split
over: a gathered block's by the gather's backward; a parameter whole over
``model`` that split compute used, as it enters that compute
(``layers.split_use``); and a leaf whole over a data axis, after the
backward, over that axis.

``q8_gather`` and ``grad_compress`` work on a mesh too: each rank
quantizes its blocks with per-channel ranges all-reduced (min / max, exact)
over the axes that split them, so the symbols are one device's bit for
bit, and gathers the symbols; the summed gradient's blocks are compressed
as the single-device function compresses the whole tensor
(``grad_compress.compress_decompress_blocks``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import quantizable_shape
from repro_torch.distributed.ctx import Sharded
from repro_torch.models import api
from repro_torch.models.layers import QTG
from repro_torch.models.mamba2 import zx_blocks, zx_unblocks
from . import optimizer as opt

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.AdamWConfig = opt.AdamWConfig()
    microbatches: int = 1          # grad-accum splits of the global batch
    grad_accum_dtype: str = "f32"  # "bf16" = the memory-tight mode
    remat: bool = True             # recompute each layer in the backward
    q_block: int = 0               # attention query-block chunking
    grad_compress: bool = False    # int8 gradient wire format (simulated)
    q8_gather: int = 0             # 0 = off | 8 | 4: EntroLLM-quantized
    #                                weights in the forward, straight-
    #                                through gradients to the master


# the families whose loss and gradients compute sharded under the train
# cell's hints (``launch/specs.py``): every family of the registry, as the
# reference's train cell installs its hints for every one.  Exact TP
# (``hints=None``) remains for the ones whose train layout it can read
# (not an SSM's re-blocked ``in_zx``: the ssm and the hybrid)
SHARDED_TRAIN_FAMILIES = ("dense", "moe", "encdec", "ssm", "hybrid")


def loss_for(cfg: ArchConfig) -> Callable:
    return api.build(cfg).loss_fn


@torch.no_grad()
def ste_quantize_params(params: Dict[str, Any], bits: int,
                        mesh=None) -> Dict[str, Any]:
    """Per-channel (axis 0) mixed symmetric / asymmetric quantization of
    every large matrix to uint8 symbols (nibble-packed at 4 bits), as a
    :class:`QTG` the models read through ``deq``: the forward computes from
    the symbols alone, and the straight-through backward sends the whole
    gradient to the master ``w`` (quantization-aware training).  Which
    tensors are quantized is ``core.spec.quantizable_shape``'s rule.

    On a ``mesh`` a :class:`Sharded` leaf is quantized on its block: the
    channel ranges are all-reduced (min / max, exact) over the axes that
    split the reduced dims, so the symbols, scales and zeros are the
    blocks of one device's, bit for bit; a per-channel scale and zero
    rest split as the channels do.  Nibbles pack within a block: its last
    dim must be even."""
    from repro_torch.distributed.ctx import block_index
    qmax = float((1 << bits) - 1)
    out: Dict[str, Any] = {}
    for name, w in params.items():
        spec = w.spec if isinstance(w, Sharded) else None
        local = _local(w)
        shape = tuple(local.shape) if spec is None else tuple(
            n * block_index(mesh, e)[0] for n, e in zip(local.shape, spec))
        if not quantizable_shape(name, shape):
            out[name] = w
            continue
        wf = local.to(f32)
        red = tuple(range(1, wf.dim()))
        lo = torch.amin(wf, dim=red, keepdim=True)
        hi = torch.amax(wf, dim=red, keepdim=True)
        if spec is not None:
            from repro_torch.distributed import collectives
            from repro_torch.distributed.sharding import entry_axes
            axes = tuple(a for e in spec[1:] if e is not None
                         for a in entry_axes(e))
            lo = collectives.all_reduce(mesh, lo, axes, "min")
            hi = collectives.all_reduce(mesh, hi, axes, "max")
            if bits == 4 and local.shape[-1] % 2:
                raise ValueError(
                    f"q8_gather=4 packs nibble pairs within a block: "
                    f"{name}'s block is {local.shape[-1]} wide")
        single = lo * hi >= 0.0
        absmax = torch.where(torch.abs(hi) >= torch.abs(lo), hi, lo)
        scale = torch.where(single,
                            torch.where(absmax == 0.0, 1.0, absmax / qmax),
                            torch.where(hi == lo, 1.0, (hi - lo) / qmax))
        zero = torch.where(single, 0.0, lo)
        q = torch.clamp(torch.round((wf - zero) / scale), 0.0, qmax
                        ).to(torch.uint8)
        if bits == 4:
            q = q[..., 0::2] | (q[..., 1::2] << 4)
        scale, zero = scale.to(f32), zero.to(f32)
        if spec is not None:
            sspec = (spec[0],) + (None,) * (len(spec) - 1)
            q = Sharded(q, spec)
            if spec[0] is not None:
                scale, zero = Sharded(scale, sspec), Sharded(zero, sspec)
        out[name] = QTG(q, scale, zero, w)
    return out


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _local(p: Any) -> torch.Tensor:
    return p.local if isinstance(p, Sharded) else p


def _grad_leaf(p: Any) -> Any:
    """A leaf the backward reaches: a detached copy that requires grad (a
    :class:`Sharded` one's block)."""
    if isinstance(p, Sharded):
        return Sharded(p.local.detach().requires_grad_(True), p.spec)
    return p.detach().requires_grad_(True)


def make_grad_fn(cfg: ArchConfig, tc: TrainConfig,
                 loss_fn: Optional[Callable] = None,
                 loss_scale: float = 1.0, mesh=None) -> Callable:
    """Returns ``grads(params, batch) -> (loss, {name: gradient})``: the
    loss and gradients of one step before the update, microbatched as
    ``tc`` says (``loss_fn`` defaults to the family's).  The gradients are
    those of ``loss_scale`` times the loss; a :class:`Sharded` leaf's is
    its block's (``mesh`` the rank's view)."""
    loss_fn = loss_fn or loss_for(cfg)

    def grads_of(params, mb):
        leaves = {n: _grad_leaf(p) for n, p in params.items()}
        p = ste_quantize_params(leaves, tc.q8_gather, mesh) \
            if tc.q8_gather else leaves
        loss = loss_fn(cfg, p, mb, remat=tc.remat, q_block=tc.q_block)
        names = list(leaves)
        gs = torch.autograd.grad(
            loss if loss_scale == 1.0 else loss * loss_scale,
            [_local(leaves[n]) for n in names], allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        return loss.detach(), {
            n: g if g is not None else torch.zeros_like(_local(leaves[n]))
            for n, g in zip(names, gs)}

    def microbatch_grads(params, batch):
        if tc.microbatches <= 1:
            return grads_of(params, batch)
        acc_dt = torch.bfloat16 if tc.grad_accum_dtype == "bf16" else f32
        dev = next(iter(params.values())).device
        grad_acc = {n: torch.zeros(_local(p).shape, dtype=acc_dt,
                                   device=dev)
                    for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=f32, device=dev)
        for i in range(tc.microbatches):
            mb = {k: v[i * (v.shape[0] // tc.microbatches):
                       (i + 1) * (v.shape[0] // tc.microbatches)]
                  for k, v in batch.items()}
            loss, grads = grads_of(params, mb)
            with torch.no_grad():
                for n, g in grads.items():
                    grad_acc[n].add_(g.to(acc_dt))
                loss_acc = loss_acc + loss
            del grads
        inv = 1.0 / tc.microbatches
        with torch.no_grad():
            # in place on the accumulator (or its float32 copy): the same
            # product, without a second float32 gradient tree
            return loss_acc * inv, {n: g.to(f32).mul_(inv)
                                    for n, g in grad_acc.items()}

    return microbatch_grads


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch rows split over (``pod`` and ``data``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def make_train_step(cfg: ArchConfig, tc: TrainConfig, mesh=None, *,
                    hints=None, ep=None) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds tensors on the parameters' device, and
    ``metrics`` 0-d device tensors (``loss``, ``grad_norm``, ``lr``).  On
    a ``mesh`` (this rank's view) the trees hold this rank's blocks and
    ``batch`` its rows: exact TP, or sharded compute under ``hints`` (and
    the EP context ``ep``; see the module docstring)."""
    if mesh is not None:
        return _mesh_train_step(cfg, tc, mesh, hints, ep)
    assert hints is None and ep is None, "hints and ep need a mesh"
    microbatch_grads = make_grad_fn(cfg, tc)

    def step(params, opt_state, batch):
        loss, grads = microbatch_grads(params, batch)
        if tc.grad_compress:
            from repro_torch.distributed.grad_compress import \
                compress_decompress
            grads = compress_decompress(grads)
        params, opt_state, metrics = opt.apply_updates(tc.opt, params, grads,
                                                       opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def _mesh_train_step(cfg: ArchConfig, tc: TrainConfig, mesh, hints=None,
                     ep=None) -> Callable:
    grads_fn = make_mesh_grad_fn(cfg, tc, mesh, hints, ep)

    def step(params, opt_state, batch):
        loss, grads = grads_fn(params, batch)
        specs = {n: p.spec if isinstance(p, Sharded) else None
                 for n, p in params.items()}
        if tc.grad_compress:
            grads = compress_blocks(cfg, grads, params, mesh)
        new, opt_state, metrics = opt.apply_updates(
            tc.opt, {n: _local(p) for n, p in params.items()}, grads,
            opt_state, mesh=mesh, specs=specs)
        params = {n: Sharded(new[n], specs[n]) if specs[n] else new[n]
                  for n in new}
        return params, opt_state, dict(metrics, loss=loss)

    return step


def compress_blocks(cfg: ArchConfig, grads: Dict[str, torch.Tensor],
                    params: Dict[str, Any], mesh) -> Dict[str, torch.Tensor]:
    """``grad_compress.compress_decompress_blocks`` of a tree of gradient
    blocks placed as ``params``: each the block of one device's
    compression.  A leaf re-blocked by :func:`zx_split` compresses as the
    ``(..., 2, Din)`` view of one device's tensor, whose plain cut by
    ``(..., None, e)`` is the rank's ``[z_r | x_r]`` block in the same
    flat order."""
    from repro_torch.distributed.grad_compress import \
        compress_decompress_blocks
    views, shapes, specs = {}, {}, {}
    for n, p in params.items():
        g, shape = grads[n], _whole_shape(p, mesh)
        spec = p.spec if isinstance(p, Sharded) else None
        k = zx_split(cfg, n, spec, mesh)
        if k > 1:
            g = g.unflatten(-1, (2, g.shape[-1] // 2))
            shape = shape[:-1] + (2, shape[-1] // 2)
            spec = tuple(spec[:-1]) + (None, spec[-1])
        views[n], shapes[n], specs[n] = g, shape, spec
    out = compress_decompress_blocks(views, shapes, specs, mesh)
    return {n: g.reshape(grads[n].shape) for n, g in out.items()}


def make_mesh_grad_fn(cfg: ArchConfig, tc: TrainConfig, mesh, hints=None,
                      ep=None) -> Callable:
    """``grads(params, batch) -> (loss, {name: gradient})`` of the train step
    on ``mesh`` before its update (exact TP, or sharded compute under
    ``hints`` and ``ep``): the global batch's loss and this rank's block of
    each gradient of it, summed where the step sums it (see the module
    docstring)."""
    import dataclasses
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import (ShardingHints, get_hints,
                                             set_hints)
    from repro_torch.distributed.sharding import entry_axes
    from repro_torch.models.moe import get_ep_context, set_ep_context
    axes = data_axes(mesh)
    n_data = 1
    for a in axes:
        n_data *= mesh.shape[a]
    microbatch_grads = make_grad_fn(cfg, tc, loss_scale=1.0 / n_data,
                                    mesh=mesh)
    if hints is None:
        assert ep is None, "an EP context computes sharded: pass its hints"
        if any(zx_split(cfg, n, s, mesh) > 1
               for n, s in train_shardings(cfg, mesh).items()):
            raise NotImplementedError(
                f"exact-TP training of the {cfg.family} family on a mesh: "
                f"its train layout rests in_zx re-blocked for sharded "
                f"compute (zx_split); pass the train cell's hints")
        hints = ShardingHints(mesh=mesh, batch_axes=(), model_axis=None,
                              seq_sp=False, exact_tp=True, grad_axes=axes)
    else:
        if hints.exact_tp or hints.feature_axes or hints.kv_seq_axes \
                or tuple(hints.batch_axes) != axes:
            raise NotImplementedError(
                f"the sharded train step computes with the batch over "
                f"{axes} and no feature or cache-sequence split: {hints}")
        if cfg.family not in SHARDED_TRAIN_FAMILIES:
            raise NotImplementedError(
                f"sharded-compute training of the {cfg.family} family: "
                f"only {SHARDED_TRAIN_FAMILIES} compute sharded, the others "
                f"train under exact TP (hints=None)")
        if cfg.moe is not None and ep is None:
            raise NotImplementedError("sharded-compute training of the MoE "
                                      "family needs its EP context")
        hints = dataclasses.replace(hints, grad_axes=axes)
    exact = hints.exact_tp

    def summed_over(p) -> Tuple[str, ...]:
        """The data axes a leaf's gradient still sums over after the
        backward: every one under exact TP for a whole leaf (a gathered
        block's came summed); under sharded compute those its spec does
        not split (its FSDP gather summed the others)."""
        if not isinstance(p, Sharded):
            return axes
        if exact:
            return ()
        split = {a for e in p.spec if e is not None for a in entry_axes(e)}
        return tuple(a for a in axes if a not in split)

    def grads_fn(params, batch):
        prev, prev_ep = get_hints(), get_ep_context()
        set_hints(hints)
        set_ep_context(ep)
        try:
            loss, grads = microbatch_grads(params, batch)
        finally:
            set_hints(prev)
            set_ep_context(prev_ep)
        with torch.no_grad():
            for n, p in params.items():
                grads[n] = collectives.all_reduce_sum(mesh, grads[n],
                                                      summed_over(p))
            loss = collectives.all_reduce_sum(mesh, loss, axes) / n_data
        return loss, grads

    return grads_fn


def _whole_shape(p: Any, mesh) -> Tuple[int, ...]:
    """The whole tensor's shape of a leaf (a :class:`Sharded` block's)."""
    if not isinstance(p, Sharded):
        return tuple(p.shape)
    from repro_torch.distributed.ctx import block_index
    return tuple(n * block_index(mesh, e)[0]
                 for n, e in zip(p.local.shape, p.spec))


def train_shardings(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """The spec of each parameter on a training mesh: the ZeRO rules
    (``opt_state_rules`` with the KV-head adjustment), where the fp32
    moments rest too, so a rank updates its blocks in place."""
    from repro_torch.distributed import sharding as shd
    return shd.param_shardings(
        cfg, mesh, shd.arch_rules(cfg, mesh, shd.opt_state_rules(mesh)))


def zx_split(cfg: ArchConfig, name: str, spec, mesh) -> int:
    """How many ``[z_r | x_r]`` blocks (``mamba2.zx_blocks``) the last dim
    of the train leaf ``name`` rests in, under ``spec``: an SSM's
    ``in_zx`` in a family of ``SHARDED_TRAIN_FAMILIES`` is re-blocked for
    the blocks its spec cuts that dim into, so that a model rank's columns
    are its heads' z and x (as ``launch.specs.Cell.place`` places the
    serving cells'); 1 for every other leaf.  Placing a train tree, and
    reading one device's tensors back from it, go through here."""
    if cfg.family not in SHARDED_TRAIN_FAMILIES or spec is None \
            or not name.endswith("/in_zx"):
        return 1
    from repro_torch.distributed.ctx import block_index
    entries = tuple(spec) + (None,) * (3 - len(tuple(spec)))  # (L, D, 2 Din)
    return block_index(mesh, entries[-1])[0]


def shard_train_state(cfg: ArchConfig, tc: TrainConfig,
                      params: Dict[str, torch.Tensor], mesh):
    """(this rank's params, its optimizer state) from the whole ``params``:
    each leaf cut by :func:`train_shardings` (a :class:`Sharded` block, or
    the tensor itself where nothing splits it; an SSM's ``in_zx``
    re-blocked first, :func:`zx_split`), zero moments shaped like the
    blocks."""
    from repro_torch.distributed.ctx import shard
    specs = train_shardings(cfg, mesh)
    placed = {n: shard(zx_blocks(p, zx_split(cfg, n, specs[n], mesh)),
                       specs[n], mesh) for n, p in params.items()}
    state = opt.init_state(tc.opt, {n: _local(p) for n, p in placed.items()},
                           shapes={n: tuple(p.shape)
                                   for n, p in params.items()})
    return placed, state


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (rows split over the data axes,
    the first major)."""
    from repro_torch.distributed.ctx import local_block
    axes = data_axes(mesh)
    entry = axes if len(axes) > 1 else axes[0]
    return {k: local_block(v, (entry,), mesh) for k, v in batch.items()}


def gather_params(params: Dict[str, Any], mesh,
                  cfg: Optional[ArchConfig] = None
                  ) -> Dict[str, torch.Tensor]:
    """The whole tensors of a placed tree (an all-gather along each split
    dim of each :class:`Sharded` leaf); every rank must call it.  With the
    ``cfg`` of a train tree (params, moments, gradients, a leaf's
    ``q8_gather`` symbols, each under its parameter's name), in one
    device's order: a leaf :func:`zx_split` re-blocked is put back
    (``mamba2.zx_unblocks``)."""
    from repro_torch.distributed import collectives
    out = {}
    for n, p in params.items():
        if isinstance(p, Sharded):
            t = p.local
            for d, e in enumerate(p.spec):
                if e is not None:
                    t = collectives.all_gather(mesh, t, d, e)
            if cfg is not None:
                t = zx_unblocks(t, zx_split(cfg, n, p.spec, mesh))
            p = t
        out[n] = p
    return out


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d metric tensors as host floats, read in one transfer."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).to(f32).reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def train(cfg: ArchConfig, tc: TrainConfig, params, opt_state,
          data_iter: Iterator, num_steps: int, *,
          hooks: Tuple[Callable, ...] = ()) -> Tuple[Any, Any, Dict]:
    """Host-side loop: moves each batch to the parameters' device, runs a
    step, reads its metrics once, then runs the hooks
    (``hook(i, params, opt_state, metrics)``; a return that is not ``None``
    is a new ``(params, opt_state)``).  Returns (params, opt_state, {
    "history": per-step host metrics, "wall_s", "steps_per_s"})."""
    step_fn = make_train_step(cfg, tc)
    dev = next(iter(params.values())).device
    history = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        batch = to_device(next(data_iter), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        del batch
        metrics = host_metrics(metrics)
        for h in hooks:
            out = h(i, params, opt_state, metrics)
            if out is not None:                       # hook replaced the state
                params, opt_state = out
        history.append(metrics)
    wall = time.perf_counter() - t0
    return params, opt_state, {"history": history, "wall_s": wall,
                               "steps_per_s": num_steps / max(wall, 1e-9)}
