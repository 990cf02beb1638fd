"""AdamW from scratch (PyTorch port of ``repro/training/optimizer.py``), with
two state formats:

* float32 moments, the standard layout;
* **EntroLLM-quantized moments**: ``m`` and ``sqrt(v)`` stored as uint8
  symbols under the paper's mixed symmetric / asymmetric scheme, one scale
  and zero a row of the last axis (:class:`Q8Moment`), for every tensor of
  at least 2^16 elements whose last axis is at least 64 long; smaller ones
  keep float32 moments.

Parameters, gradients and moments are flat ``{name: tensor}`` dicts (the
model format).  The update runs under ``torch.no_grad()`` and returns new
tensors, as the JAX package returns new arrays; it mutates none of its
inputs.  The float32 arithmetic is the JAX package's, op for op and in the
same order, with each Python scalar rounded to float32 where it meets a
float32 tensor, as JAX's weak typing rounds it.

On a mesh (``apply_updates(..., mesh=, specs=)``) every rank updates its
own block of each leaf: the gradient norm sums each leaf's squares over
the axes its spec splits it along, and a quantized moment's row range
(min and max along the last axis) is reduced over the axes that split the
last axis, so the symbols are the ones the whole row gives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

f32 = torch.float32


# ------------------------------------------------------------------ schedules

@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warmup to ``base_lr``, then a cosine decay to
    ``min_ratio * base_lr`` at ``total_steps``."""
    base_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_ratio: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        s = step.to(f32)
        warm = s / max(self.warmup_steps, 1)
        prog = (s - self.warmup_steps) / max(
            self.total_steps - self.warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = self.min_ratio + (1 - self.min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return self.base_lr * torch.where(s < self.warmup_steps, warm, cos)


# ---------------------------------------------------------- moment quantization

_Q8_MIN_SIZE = 1 << 16    # small tensors (norms, biases) keep f32 moments


def _use_q8(shape) -> bool:
    n = 1
    for d in shape:
        n *= int(d)
    return n >= _Q8_MIN_SIZE and int(shape[-1]) >= 64


def _q8(x: torch.Tensor, row_reduce=None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (last axis) mixed symmetric / asymmetric uint8 quantization:
    a row of one sign is scaled by its largest magnitude over 255 with zero
    0, a row of both signs spans [min, max].  ``torch.round`` rounds half to
    even, as ``jnp.round`` does.  ``row_reduce(t, op)`` completes a row's
    min / max across the ranks that hold the rest of it (a mesh)."""
    x = x.to(f32)
    lo = torch.amin(x, dim=-1, keepdim=True)
    hi = torch.amax(x, dim=-1, keepdim=True)
    if row_reduce is not None:
        lo, hi = row_reduce(lo, "min"), row_reduce(hi, "max")
    single = lo * hi >= 0.0
    absmax = torch.where(torch.abs(hi) >= torch.abs(lo), hi, lo)
    s_sym = torch.where(absmax == 0.0, 1.0, absmax / 255.0)
    s_asym = torch.where(hi == lo, 1.0, (hi - lo) / 255.0)
    scale = torch.where(single, s_sym, s_asym)
    zero = torch.where(single, 0.0, lo)
    q = torch.clamp(torch.round((x - zero) / scale), 0.0, 255.0
                    ).to(torch.uint8)
    return q, scale.to(f32), zero.to(f32)


def _dq8(q: torch.Tensor, scale: torch.Tensor,
         zero: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale + zero


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's.  The CPU library's
    vectorized ``torch.sqrt`` is not (7,209 of 10^6 inputs in [0, 1e-8) come
    out one ulp off); through float64 it is.  A CUDA ``sqrtf`` is
    correctly rounded already."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(f32)
    return torch.sqrt(x)


class Q8Moment(NamedTuple):
    q: torch.Tensor       # uint8, the parameter's shape
    scale: torch.Tensor   # f32 (..., 1)
    zero: torch.Tensor    # f32 (..., 1)


# --------------------------------------------------------------------- AdamW

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: Schedule = Schedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized_state: bool = False     # EntroLLM-quantized m / v (uint8)

    @staticmethod
    def decay_mask(name: str) -> bool:
        """Names that never get weight decay: norms, biases and the SSM's
        sensitive parameters."""
        lname = name.lower()
        return not any(k in lname
                       for k in ("norm", "bias", "a_log", "dt_", "scale"))


class OptState(NamedTuple):
    step: torch.Tensor    # 0-d int32, on the parameters' device
    m: Dict[str, Any]
    v: Dict[str, Any]


def init_state(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
               shapes: Dict[str, Tuple[int, ...]] = None) -> OptState:
    """Zero moments shaped like ``params``; ``shapes`` (the whole tensors'
    shapes, when ``params`` holds a rank's blocks) decide which are
    quantized, as the whole tensors would."""
    shapes = shapes or {n: tuple(p.shape) for n, p in params.items()}

    def zero_moment(n, p):
        if cfg.quantized_state and _use_q8(shapes[n]):
            sshape = tuple(p.shape[:-1]) + (1,)
            return Q8Moment(
                torch.zeros(p.shape, dtype=torch.uint8, device=p.device),
                torch.ones(sshape, dtype=f32, device=p.device),
                torch.zeros(sshape, dtype=f32, device=p.device))
        return torch.zeros(p.shape, dtype=f32, device=p.device)

    m = {n: zero_moment(n, p) for n, p in params.items()}
    v = {n: zero_moment(n, p) for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), m, v)


def global_norm(tree: Dict[str, torch.Tensor], mesh=None,
                split: Dict[str, Tuple[str, ...]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, the leaves summed one
    after another in sorted name order (the JAX package's leaf order).  On
    a mesh ``tree`` holds this rank's blocks and ``split`` names the axes
    each leaf is split along: the leaves split alike are summed, each such
    sum reduced over its axes (a float sum: a tolerance, not bits)."""
    if mesh is None:
        total = 0
        for name in sorted(tree):
            x = tree[name].to(f32)
            total = total + torch.sum(x * x)
        return _sqrt(total)
    from repro_torch.distributed import collectives
    groups: Dict[Tuple[str, ...], Any] = {}
    for name in sorted(tree):
        x = tree[name].to(f32)
        axes = split.get(name, ())
        groups[axes] = groups.get(axes, 0) + torch.sum(x * x)
    total = 0
    for axes, part in groups.items():
        total = total + collectives.all_reduce_sum(mesh, part, axes)
    return _sqrt(total)


def moment_bytes(state: OptState) -> int:
    """Bytes the moments hold (``m`` and ``v``, with the Q8 scales and
    zeros)."""
    n = 0
    for tree in (state.m, state.v):
        for w in tree.values():
            for t in (w if isinstance(w, Q8Moment) else (w,)):
                n += t.numel() * t.element_size()
    return n


# a leaf's update runs in slices of its leading axis of at most this many
# elements (whole rows of the last axis, so the Q8 rows are unchanged): the
# float32 temporaries of a 2^28-element leaf stay at 2^26 elements each
_SLICE_ELEMENTS = 1 << 26


def _slices(shape) -> List[slice]:
    if len(shape) < 2:
        return [slice(None)]
    row = 1
    for d in shape[1:]:
        row *= int(d)
    step = max(1, _SLICE_ELEMENTS // row)
    return [slice(i, min(i + step, int(shape[0])))
            for i in range(0, int(shape[0]), step)]


def _adamw_leaf(cfg: AdamWConfig, name: str, p, g, m, v, scale, lr, b1c,
                b2c, q8: bool, row_reduce=None):
    """One leaf's (or one slice's) update: (new p, new m, new v)."""
    g32 = g.to(f32) * scale
    if q8:
        # v is kept in sqrt space: uint8 on sqrt(v) keeps the relative
        # resolution Adam's m / sqrt(v) needs
        m32 = _dq8(m.q, m.scale, m.zero)
        v32 = _dq8(v.q, v.scale, v.zero)
        v32 = v32 * v32
    else:
        m32, v32 = m, v
    m32 = (cfg.b1 * m32).add_((1 - cfg.b1) * g32)
    v32 = (cfg.b2 * v32).add_((1 - cfg.b2) * g32 * g32)
    del g32
    upd = (m32 / b1c).div_(_sqrt(v32 / b2c).add_(cfg.eps))
    pf = p.to(f32)
    if cfg.weight_decay and cfg.decay_mask(name):
        upd = upd.add_(cfg.weight_decay * pf)
    new_p = (pf - lr * upd).to(p.dtype)
    del upd, pf
    if q8:
        return new_p, Q8Moment(*_q8(m32, row_reduce)), \
            Q8Moment(*_q8(_sqrt(v32), row_reduce))
    return new_p, m32, v32


def _rows(w, s: slice):
    return Q8Moment(*(t[s] for t in w)) if isinstance(w, Q8Moment) else w[s]


def _split_axes(spec) -> Tuple[str, ...]:
    from repro_torch.distributed.sharding import entry_axes
    return tuple(a for e in (spec or ()) for a in entry_axes(e))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState, *,
                  mesh=None, specs: Dict[str, Any] = None
                  ) -> Tuple[Dict[str, torch.Tensor], OptState,
                             Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics) with
    ``metrics`` = {"grad_norm", "lr"} as 0-d device tensors.

    On a ``mesh`` the trees hold this rank's blocks, cut by ``specs`` (a
    spec a leaf, ``None`` for a whole one), and each rank updates its
    blocks."""
    step = state.step + 1
    lr = cfg.schedule(step)
    specs = specs or {}
    gnorm = global_norm(grads, mesh,
                        {n: _split_axes(s) for n, s in specs.items()})
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1.0 - torch.pow(cfg.b1, step.to(f32))
    b2c = 1.0 - torch.pow(cfg.b2, step.to(f32))

    new_params, new_m, new_v = {}, {}, {}
    for name in params:
        p, g = params[name], grads[name]
        q8 = isinstance(state.m[name], Q8Moment)
        row_reduce = None
        if mesh is not None and specs.get(name) \
                and len(specs[name]) == p.dim() and specs[name][-1]:
            from repro_torch.distributed import collectives
            last = specs[name][-1]
            row_reduce = (lambda t, op, last=last:  # noqa: E731
                          collectives.all_reduce(mesh, t, last, op))
        slices = _slices(p.shape)
        parts = None
        for sl in slices:
            res = _adamw_leaf(cfg, name, p[sl], g[sl],
                              _rows(state.m[name], sl),
                              _rows(state.v[name], sl), scale, lr, b1c, b2c,
                              q8, row_reduce)
            if len(slices) == 1:
                parts = res
                break
            flat = [res[0]] + [t for w in res[1:] for t in
                               (w if isinstance(w, Q8Moment) else (w,))]
            if parts is None:
                parts = [torch.empty((p.shape[0],) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device=t.device)
                         for t in flat]
            for o, t in zip(parts, flat):
                o[sl].copy_(t)
            del res, flat
        if len(slices) > 1:
            parts = ((parts[0], Q8Moment(*parts[1:4]), Q8Moment(*parts[4:]))
                     if q8 else tuple(parts))
        new_params[name], new_m[name], new_v[name] = parts

    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(step, new_m, new_v), metrics


def state_shardings(cfg: AdamWConfig, param_shapes: Dict[str, Any],
                    opt_shardings: Dict[str, Any]) -> OptState:
    """Specs shaped like :func:`init_state`'s tree.

    fp32 moments take the ZeRO specs (``opt_shardings``, a spec a
    parameter); quantized moments keep the parameter's shape (and so its
    spec), with the per-channel scale / zero dropping whatever the spec put
    on the last axis."""
    from repro_torch.distributed.sharding import P

    def moment_spec(name, spec):
        if not (cfg.quantized_state and _use_q8(param_shapes[name])):
            return spec
        entries = list(P(*spec).padded(len(param_shapes[name])))
        entries[-1] = None                      # scale / zero last dim is 1
        while entries and entries[-1] is None:
            entries.pop()
        sspec = P(*entries)
        return Q8Moment(spec, sspec, sspec)

    m = {n: moment_spec(n, opt_shardings[n]) for n in opt_shardings}
    return OptState(P(), m, dict(m))
