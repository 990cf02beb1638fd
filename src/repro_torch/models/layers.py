"""Shared model-building blocks (PyTorch port of ``repro/models/layers.py``).

Parameters live in a flat ``{name: tensor}`` dict; a parallel schema maps each
name to ``(shape, logical_axes, init, dtype)``, the same layout as the JAX
package, so a parameter dict converts between the two by name.

Weight tensors may be plain tensors OR :class:`QT` / :class:`QT4` triples
(quantized symbols + scale + zero): ``matmul`` / ``take_rows`` dequantize at
use, in bf16, exactly as the JAX package does before it hands the product to
its compiler.  The products themselves are plain ``torch.matmul`` calls (the
JAX package leaves them to XLA, not to a kernel of its own).  A
:class:`~repro_torch.kernels.fused_decode_matmul.FusedQT` weight (the
compressed-resident mode's payload handle) goes to the fused
decode→dequant→matmul kernel instead.

Numerics follow the JAX package op for op: dequantize in bf16, attention
scores from bf16 operands accumulated in float32, RMS norm statistics in
float32.

Under sharded-compute hints (``distributed.ctx``, the production cells)
the same functions compute this rank's block: :func:`matmul` is column-
parallel for a weight whose output channels rest on the model axis and
row-parallel (a partial sum, reduced in float32) for one whose input
channels do; :func:`gqa_attention` attends over this rank's heads, or over
its block of the cache's T with an exact combine; :func:`rms_norm` and
:func:`take_rows` run on the rank's block of the layer carry, whose layout
(:func:`carry_spec`) the model code passes with it.  With no hints, and
under exact TP, every one of them computes what it computed before, op
for op.

Training computes the same way (the dense and MoE train cells), and each
site's collective names its backward (``distributed/collectives.py``: the
rank losses are summed over the data axes, the loss is replicated over
``model``).  Two regions of a block differ in what a rank's gradient
holds.  The layer carry (whole, or its S block over ``model``) holds
whole gradients.  :func:`whole_activation` hands the carry into the
block's split compute — column-parallel products, a rank's heads, its
experts — whose tensors, though some hold the same value on every rank,
get from each rank only its share of their gradient; the all-gather that
enters (or :func:`~repro_torch.distributed.collectives.enter_split`)
sums the shares in its backward, and the row-parallel sum that leaves
(reduce-scatter or all-reduce) hands whole gradients back.  So a
parameter whole over ``model`` is summed over it (:func:`split_use`)
where it is used inside that compute, or on a carry split along S, and
not where it is used on a whole carry (a norm's scale).  The router's
gathered logits are used alike by every rank: its gates enter the
experts through ``enter_split`` (``moe._routed``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..distributed import collectives
from ..distributed.collectives import enter_split
from ..distributed.ctx import (Sharded, block_index, constrain_activation,
                               constrain_heads, constrain_replicated,
                               constrain_scores, get_hints, sharded_compute)
from ..kernels.fused_decode_matmul import FusedQT, fused_decode_matmul

# --------------------------------------------------------------------------- schema

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Axes                      # logical axis names, len == len(shape)
    init: Any = 0.02     # float std | "zeros" | "ones" | "a_log" | "dt_bias"
    dtype: torch.dtype = torch.bfloat16   # norms / ssm-sensitive params use f32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = Dict[str, Spec]


def init_param(gen: torch.Generator, spec: Spec,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("a_log", "dt_bias"):
        # mamba2: A = -exp(A_log) in [-16, -1]; dt_bias the softplus
        # inverse of a step in [1e-3, 1e-1]
        lo, hi = (1.0, 16.0) if spec.init == "a_log" else (1e-3, 1e-1)
        u = torch.empty(spec.shape, dtype=torch.float32, device=device)
        u.uniform_(lo, hi, generator=gen)
        w = torch.log(u if spec.init == "a_log" else torch.expm1(u))
        return w.to(spec.dtype)
    std = float(spec.init)
    w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (std * w).to(spec.dtype)


def init_params(schema: Schema, seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Random parameters from one seeded generator on ``device``, drawn in
    sorted name order (torch and JAX give different numbers from one seed;
    tests that compare the packages hand both the same numpy weights)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {n: init_param(gen, schema[n], device) for n in sorted(schema)}


# ----------------------------------------------------------------- quantized weights

class QT(NamedTuple):
    """Quantized weight triple; integer bytes stay in device memory."""
    q: torch.Tensor        # uint8 symbols
    scale: torch.Tensor    # f32 broadcastable
    zero: torch.Tensor     # f32 broadcastable


class QT4(NamedTuple):
    """int4 weights packed two-per-byte along the LAST axis: q[..., j] holds
    symbol 2j in the low nibble and symbol 2j+1 in the high nibble."""
    q: torch.Tensor        # uint8, last dim = N/2
    scale: torch.Tensor
    zero: torch.Tensor


class QTG(NamedTuple):
    """Quantized weight with a gradient path to its bf16 master (training's
    compressed weight gather, ``TrainConfig.q8_gather``): the forward
    computes from the uint8 symbols only, and the backward is a
    straight-through estimator into the master.  On a mesh each part may
    be a :class:`~repro_torch.distributed.ctx.Sharded` block."""
    q: torch.Tensor        # uint8 symbols (packed nibbles when bits == 4)
    scale: torch.Tensor
    zero: torch.Tensor
    master: torch.Tensor   # bf16 master weight (the gradient's target)


class FsdpMaster(NamedTuple):
    """A :class:`QTG` master as :func:`gather_weight` hands it on under
    sharded compute: its symbols were gathered over the FSDP axes, the
    master was not.  ``dims`` names each gathered dim (counted from the
    end) and its axes: the straight-through gradient is reduce-scattered
    along them onto ``block``."""
    block: Any             # the master's block (a Sharded over model)
    dims: Tuple[Tuple[int, Tuple[str, ...]], ...]
    mesh: Any


def _unpack4(q: torch.Tensor) -> torch.Tensor:
    lo = q & 0x0F
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*q.shape[:-1],
                                                 q.shape[-1] * 2)


def pack_qt(q: np.ndarray, scale: np.ndarray, zero: np.ndarray, *,
            bits: int, pack_int4: bool = True) -> "QT | QT4":
    """Host ``(q, scale, zero)`` symbols -> the serving-resident triple (CPU
    tensors; the loader moves them to the device).

    4-bit symbols with an even last dim pack nibble pairs into :class:`QT4`
    (0.5 bytes/param resident) unless ``pack_int4`` is off, everything else
    stays a :class:`QT` of uint8 symbols — the JAX package's rule, byte for
    byte.  Both weight loaders (whole-model and per-layer resident) share it.
    """
    q = np.asarray(q)
    if bits == 4 and pack_int4 and q.shape[-1] % 2 == 0:
        packed = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
        return QT4(torch.from_numpy(packed), torch.from_numpy(np.asarray(scale)),
                   torch.from_numpy(np.asarray(zero)))
    return QT(torch.from_numpy(np.ascontiguousarray(q)),
              torch.from_numpy(np.asarray(scale)),
              torch.from_numpy(np.asarray(zero)))


class _SteDeq(torch.autograd.Function):
    """``bf16(sym) * bf16(scale) + bf16(zero)`` forward, with ``sym``
    unpacked from nibbles when ``q``'s last dim is half the master's; the
    backward hands the whole gradient, in bf16, to the master (the JAX
    package's ``_ste_deq`` custom VJP) and none to the symbols.  With
    ``dims`` (an :class:`FsdpMaster`'s) the symbols are the master's block
    gathered along those dims, and the gradient is reduce-scattered back
    along them."""

    @staticmethod
    def forward(ctx, master, q, scale, zero, dims=(), mesh=None):
        ctx.dims, ctx.mesh = dims, mesh
        last = master.shape[-1]
        for d, axes in dims:
            if d == -1:
                last *= block_index(mesh, axes)[0]
        sym = _unpack4(q) if q.shape[-1] != last else q
        bf = torch.bfloat16
        return sym.to(bf) * scale.to(bf) + zero.to(bf)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16)
        for d, axes in ctx.dims:
            g = collectives.reduce_scatter(ctx.mesh, g, g.dim() + d, axes)
        return g, None, None, None, None, None


def _ste(w: "QTG", idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The straight-through dequantization of a :class:`QTG` held here
    (its master a tensor or an :class:`FsdpMaster`); of the rows ``idx``
    when given (a table's lookup: a per-row scale and zero taken at the
    same rows).  A lookup in a table whose symbols were gathered
    dequantizes the table, so that the gradient reaches the master's
    block as the table's (the data ranks look up different rows)."""
    m = w.master
    block, dims, mesh = (m.block, m.dims, m.mesh) if isinstance(
        m, FsdpMaster) else (m, (), None)
    if idx is None or dims:
        out = _SteDeq.apply(block, w.q, w.scale, w.zero, dims, mesh)
        return out if idx is None else out[idx]
    rows = lambda t: t if t.shape[0] == 1 else t[idx]  # noqa: E731
    return _SteDeq.apply(block[idx], w.q[idx], rows(w.scale), rows(w.zero))


def to_device(w: Any, device: torch.device) -> Any:
    """Move a tensor or each part of a QT / QT4 / QTG tuple to ``device``."""
    if isinstance(w, (QT, QT4, QTG)):
        return type(w)(*(p.to(device) for p in w))
    return w.to(device)


def layer_slice(w: Any, l: int) -> Any:
    """Layer ``l`` of a layer-stacked tensor or QT / QT4 triple (the slice
    ``lax.scan`` hands each iteration in the JAX package); a part sharded
    at rest stays sharded (:class:`~repro_torch.distributed.ctx.Sharded`)."""
    if isinstance(w, (QT, QT4, QTG)):
        return type(w)(*(p[l] for p in w))
    return w[l]


def _unbind(p: Any) -> list:
    return p.unbind() if isinstance(p, Sharded) else list(torch.unbind(p))


def layer_views(w: Any) -> list:
    """Every layer of a layer-stacked tensor or QT / QT4 / QTG tuple, as
    views taken at once with ``torch.unbind``.  Under autograd, the
    backward of one ``unbind`` stacks the layers' gradients once, where a
    ``select`` a layer would fill a zero tensor of the whole stack for
    each layer."""
    if isinstance(w, (QT, QT4, QTG)):
        return [type(w)(*parts) for parts in zip(*(_unbind(p) for p in w))]
    return _unbind(w)


def stacked_layers(params: Dict[str, Any], prefix: str, n: int) -> list:
    """The ``n`` per-layer dicts of the ``prefix/*`` stack (names with the
    prefix cut), from one :func:`layer_views` a leaf."""
    pre = prefix + "/"
    views = {k[len(pre):]: layer_views(v) for k, v in params.items()
             if k.startswith(pre)}
    out = [{k: v[l] for k, v in views.items()} for l in range(n)]
    for k, v in views.items():
        assert len(v) == n, (prefix, k, len(v), n)
    return out


def checkpointed(fn, remat: bool):
    """``fn`` recomputed in the backward when ``remat`` is on (the JAX
    package's ``jax.checkpoint(body)``), else ``fn`` itself."""
    if not remat:
        return fn
    from torch.utils.checkpoint import checkpoint

    def wrapped(*args, **kw):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def gather_weight(w: Any) -> Any:
    """Exact sharded serving and training: all-gather a weight sharded at
    rest (or each part of a QT / QT4 / QTG triple) at its use site; its
    gradient, on a training mesh, goes back to this rank's block summed
    over the data axes (``distributed.ctx._GatherAtUse``).  Under
    sharded-compute hints only the blocks along axes that are not computed
    sharded are gathered — the FSDP (data) blocks — and none at all under
    ``feature_axes``: what stays on the model axis (or the feature axes)
    stays a :class:`Sharded` block for :func:`matmul` to compute on.  The
    identity with no hints, so every single-device path is unchanged.  A
    fused payload handle has no sharded form: compressed residency is
    single-device.

    In training a gathered FSDP block's gradient is reduce-scattered back
    over the same axes.  A :class:`QTG` gathers its uint8 symbols (packed
    nibbles at 4 bits), scale and zero, never its bf16 master, which
    stays a block: the straight-through gradient reaches it by that
    reduce-scatter (:class:`FsdpMaster`)."""
    h = get_hints()
    if h is None:
        return w
    if isinstance(w, FusedQT):
        raise NotImplementedError(
            "compressed-resident serving is single-device (see "
            "docs/SERVING.md §\"Which mode when\"); drop mesh= or use "
            "resident='dense'")
    if not h.exact_tp:
        keep = {h.model_axis} | set(h.feature_axes)
        if isinstance(w, QTG):
            return QTG(*(_gather_blocks(p, h.mesh, keep) for p in w[:3]),
                       _fsdp_master(w.master, h.mesh, keep))
        if isinstance(w, (QT, QT4)):
            return type(w)(*(_gather_blocks(p, h.mesh, keep) for p in w))
        return _gather_blocks(w, h.mesh, keep)
    if isinstance(w, (QT, QT4, QTG)):
        return type(w)(*(constrain_replicated(p) for p in w))
    return constrain_replicated(w)


def _entry(e) -> Tuple[str, ...]:
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _gather_blocks(p: Any, mesh, keep) -> Any:
    """``p`` with every sharded dim whose axes are not in ``keep``
    all-gathered: a :class:`Sharded` of the dims still sharded, or the
    tensor when none is."""
    if not isinstance(p, Sharded):
        return p
    out, spec = p.local, []
    for d, e in enumerate(p.spec):
        axes = _entry(e)
        gone = [a for a in axes if a not in keep]
        assert not gone or len(gone) == len(axes), \
            f"a dim sharded over kept and gathered axes {p.spec}"
        if gone:
            out = collectives.all_gather(mesh, out, d, e,
                                         grad="reduce_scatter")
            spec.append(None)
        else:
            spec.append(e)
    return Sharded(out, spec) if any(e is not None for e in spec) else out


def _fsdp_master(m: Any, mesh, keep) -> FsdpMaster:
    """A :class:`QTG` master's block under sharded compute, the dims that
    :func:`_gather_blocks` gathers its symbols along named
    (:class:`FsdpMaster`); nothing moves."""
    if not isinstance(m, Sharded):
        return FsdpMaster(m, (), mesh)
    dims, spec = [], []
    for d, e in enumerate(m.spec):
        axes = _entry(e)
        if axes and all(a not in keep for a in axes):
            dims.append((d - len(m.spec), axes))
            spec.append(None)
        else:
            spec.append(e)
    block = Sharded(m.local, spec) if any(e is not None for e in spec) \
        else m.local
    return FsdpMaster(block, tuple(dims), mesh)


def split_use(w: Any) -> Any:
    """``w`` (a tensor, a :class:`Sharded` block or a quantized tuple) as it
    enters compute that differs rank by rank along the model axis, under
    sharded-compute training: each part whole over that axis goes through
    :func:`~repro_torch.distributed.collectives.enter_split`, so its
    gradient is summed over it.  The identity otherwise."""
    h = sharded_compute()
    if h is None or not h.model_axis or h.mesh.shape[h.model_axis] == 1:
        return w
    m = h.model_axis

    def one(p):
        if isinstance(p, Sharded):
            if any(m in _entry(e) for e in p.spec):
                return p
            return Sharded(enter_split(h.mesh, p.local, (m,)), p.spec)
        return enter_split(h.mesh, p, (m,))
    if isinstance(w, (QT, QT4, QTG)):
        return type(w)(*(one(p) for p in w))
    return one(w)


def _local_weight(w: Any, mesh) -> Tuple[Any, Tuple]:
    """This rank's block of a (partly gathered) weight as plain tensors — a
    tensor or a QT / QT4 / QTG tuple — and the spec its symbols are cut by
    (one entry a dim).  A replicated scale / zero that spans a sharded dim
    of the symbols (a per-row scale) is cut to the same block; a QTG's
    :class:`FsdpMaster` keeps its block as a tensor."""
    if isinstance(w, QTG):
        qt, spec = _local_weight(QT(*w[:3]), mesh)
        m = w.master
        block = m.block.local if isinstance(m.block, Sharded) else m.block
        return QTG(*qt, FsdpMaster(block, m.dims, m.mesh)), spec
    parts = tuple(w) if isinstance(w, (QT, QT4)) else (w,)
    main = parts[0]
    spec = main.spec if isinstance(main, Sharded) else (None,) * main.dim()
    loc = main.local if isinstance(main, Sharded) else main
    full = [n * block_index(mesh, e)[0] for n, e in zip(loc.shape, spec)]
    out = [loc]
    for p in parts[1:]:
        if isinstance(p, Sharded):
            out.append(p.local)
            continue
        t = p
        for d, (e, n) in enumerate(zip(spec, full)):
            if e is not None and d < t.dim() and t.shape[d] == n and n > 1:
                size, idx = block_index(mesh, e)
                t = t.narrow(d, idx * (n // size), n // size)
        out.append(t)
    if isinstance(w, (QT, QT4)):
        return type(w)(*out), tuple(spec)
    return out[0], tuple(spec)


def local_weight(w: Any) -> Tuple[Any, Tuple]:
    """Under sharded-compute hints, this rank's block of the weight ``w``
    as plain tensors (a tensor or a QT / QT4 triple), its FSDP blocks
    gathered (:func:`gather_weight`), and the spec the block is cut by."""
    return _local_weight(gather_weight(w), sharded_compute().mesh)


def deq(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    """The weight dequantized in ``dtype`` (bf16 by default); under
    sharded-compute hints this rank's block of it (after
    :func:`gather_weight`)."""
    h = sharded_compute()
    if h is not None:
        w, _ = _local_weight(gather_weight(w), h.mesh)
    else:
        w = gather_weight(w)
    return _deq_plain(w, dtype)


def matmul(x: torch.Tensor, w: Any, *, gather: bool = False,
           x_axes: Any = None, carry: Optional[tuple] = None) -> torch.Tensor:
    """x @ w with dequantization at use (bf16 for QT / QT4 weights); a
    :class:`FusedQT` weight decodes inside the fused kernel (plain ``x @ w``
    only, as in the JAX package).

    Under sharded-compute hints the product is this rank's block
    (:func:`_matmul`): ``x_axes`` names the mesh axes ``x``'s last dim is
    split over (None: whole), ``carry`` the layout of the layer carry a
    row-parallel product over the model axis hands back
    (:func:`carry_spec`), and ``gather`` asks for the whole output (the
    logits, the router's)."""
    return _matmul(x, w, gather=gather, x_axes=x_axes, carry=carry)[0]


def _matmul(x: torch.Tensor, w: Any, *, gather: bool = False,
            x_axes: Any = None, carry: Optional[tuple] = None
            ) -> Tuple[torch.Tensor, Tuple[str, ...]]:
    """:func:`matmul` and the mesh axes its product's last dim is split
    over (``()`` when whole).

    One rank's ``x @ w`` under sharded compute: the weight stays where it
    rests after :func:`gather_weight` (its model-axis and feature-axis
    blocks).  Its output channels on the model axis make the product
    column-parallel: this rank's output block.  Its input channels on an
    axis make it row-parallel: ``x``'s matching block (cut here when ``x``
    is whole along K, gathered first when ``x`` is split over other axes)
    times the weight's rows is a partial sum, summed over those axes in
    float32 and rounded once — over the model axis a reduce-scatter along
    S when ``carry`` splits S there, else an all-reduce; over the feature
    axes (the weight-stationary decode) an all-reduce of the partial
    dot."""
    if isinstance(w, FusedQT):
        gather_weight(w)            # refuses a mesh
        return fused_decode_matmul(x, w), ()
    h = sharded_compute()
    if h is None:
        return x @ deq(w, x.dtype), ()
    mesh = h.mesh
    wl, spec = _local_weight(gather_weight(split_use(w)), mesh)
    wd = _deq_plain(wl, x.dtype)
    k_axes, x_axes = _split(mesh, spec[-2]), _split(mesh, x_axes)
    if x_axes and x_axes != k_axes:
        # x is a block of its features that this weight does not take:
        # whole features first (every rank of those axes repeats the
        # product: the gathered x's gradient is whole on each)
        x = collectives.all_gather(mesh, x, x.dim() - 1, x_axes,
                                   grad="cut")
        x_axes = ()
    if not k_axes:                  # no rank holds another block of K
        y = x @ wd
    else:
        if not x_axes:
            K = wd.shape[-2]
            x = x.narrow(-1, block_index(mesh, k_axes)[1] * K, K)
        y = _reduce_partial((x @ wd).float(), k_axes, h, carry).to(x.dtype)
    n_axes = _split(mesh, spec[-1])
    if gather and spec[-1] is not None:
        # the whole output is used alike by every rank (the router's
        # probabilities): its gradient is whole on each
        y = collectives.all_gather(mesh, y, y.dim() - 1, spec[-1],
                                   grad="cut")
        n_axes = ()
    return y, n_axes


def tied_logits(x: torch.Tensor, table: Any, *,
                x_axes: Any = None) -> torch.Tensor:
    """``x @ deq(table).T``, the logits of a tied embedding; under
    sharded-compute hints the table's rows (the vocabulary, its block on
    the model axis) are the product's output channels: column-parallel,
    the logits gathered (``x_axes`` as in :func:`matmul`)."""
    if sharded_compute() is None:
        return matmul(x, deq(table).T)
    return matmul(x, _transposed(table), gather=True, x_axes=x_axes)


def _transposed(table: Any) -> Any:
    """A ``(V, D)`` table (a tensor or a QT triple, its parts
    :class:`Sharded` blocks or whole) as the ``(D, V)`` weight of a
    product; a per-row scale and zero become per-column ones."""
    if isinstance(table, (QT4, QTG)):
        raise NotImplementedError("sharded tied logits of a nibble-packed "
                                  "or straight-through table")
    t = lambda p: (Sharded(p.local.t(), p.spec[::-1])  # noqa: E731
                   if isinstance(p, Sharded) else
                   p.t() if p.dim() == 2 else p)
    return QT(*(t(p) for p in table)) if isinstance(table, QT) \
        else t(table)


def _split(mesh, entry) -> Tuple[str, ...]:
    """The axes of the spec entry ``entry`` when they split a dim (more
    than one block), else ``()``."""
    return _entry(entry) if block_index(mesh, entry)[0] > 1 else ()


def _reduce_partial(y: torch.Tensor, axes: Tuple[str, ...], h,
                    carry: Optional[tuple]) -> torch.Tensor:
    """The sum over ``axes`` of a row-parallel partial product, along S in
    the layer carry's layout ``carry``: this rank's S block when the carry
    splits S (a reduce-scatter when over those axes), else an
    all-reduce."""
    if carry is not None and carry[1] is not None:
        if _entry(carry[1]) == axes:
            return collectives.reduce_scatter(h.mesh, y, 1, carry[1])
        return _cut(collectives.all_reduce_sum(
            h.mesh, y, axes, grad_axes=summed_axes(axes)), 1, carry[1],
            h.mesh)
    return collectives.all_reduce_sum(h.mesh, y, axes,
                                      grad_axes=summed_axes(axes))


def summed_axes(axes) -> Tuple[str, ...]:
    """The axes of ``axes`` over which the backward of an all-reduce whose
    total every rank then uses alike sums the gradient: those the rank
    losses are summed over (the installed hints' ``grad_axes``); over the
    others the loss is replicated and the backward is the identity."""
    h = get_hints()
    return tuple(a for a in _entry(axes) if h is not None
                 and a in h.grad_axes)


def _global_rows(n: int, h) -> int:
    """The global batch of ``n`` rows split over the hints' batch axes."""
    return n * block_index(h.mesh, h.batch_axes or None)[0]


def _deq_plain(w: Any, dtype) -> torch.Tensor:
    """A tensor or QT / QT4 / QTG tuple held whole here, dequantized in
    ``dtype`` (no hints consulted)."""
    if isinstance(w, QTG):
        return _ste(w).to(dtype)
    if isinstance(w, QT):
        return w.q.to(dtype) * w.scale.to(dtype) + w.zero.to(dtype)
    if isinstance(w, QT4):
        return (_unpack4(w.q).to(dtype) * w.scale.to(dtype)
                + w.zero.to(dtype))
    return w.to(dtype) if w.dtype != dtype else w


def _row_block_entry(w: Any):
    """The spec entry of a table sharded at rest along its rows only (each
    sharded part on dim 0 alone, by one entry; the other parts broadcast
    along rows), else None."""
    parts = tuple(w) if isinstance(w, (QT, QT4)) else (w,)
    entries = set()
    for p in parts:
        if isinstance(p, Sharded):
            if any(e is not None for e in p.spec[1:]):
                return None
            entries.add(p.spec[0])
        elif p.dim() and p.shape[0] != 1:
            return None
    return entries.pop() if len(entries) == 1 else None


def _take_sharded_rows(w: Any, idx: torch.Tensor, mesh,
                       entry) -> torch.Tensor:
    """:func:`take_rows` of a table whose rows rest sharded: each rank
    dequantizes the rows it holds (a clamped index elsewhere) and the
    ranks' rows are all-gathered, each token taking its owner's.  Pure data
    movement around the same per-row ops, so the rows are the ones the
    whole table gives, bit for bit, without gathering the table."""
    size, rank = block_index(mesh, entry)
    parts = tuple(w) if isinstance(w, (QT, QT4)) else (w,)
    local = tuple(p.local if isinstance(p, Sharded) else p for p in parts)
    n_loc = next(p for p in parts if isinstance(p, Sharded)).local.shape[0]
    table = type(w)(*local) if isinstance(w, (QT, QT4)) else local[0]
    rows = _lookup(table, (idx - rank * n_loc).clamp(0, n_loc - 1))
    every = collectives.all_gather(mesh, rows[None], 0, entry, grad="cut")
    owner = (idx // n_loc).clamp(max=size - 1)
    pick = owner.reshape((1,) + owner.shape + (1,)).expand(
        (1,) + rows.shape)
    return torch.gather(every, 0, pick)[0]


def take_rows(w: Any, idx: torch.Tensor,
              carry: Optional[tuple] = None) -> torch.Tensor:
    """Embedding lookup honoring quantized tables (dequantize only gathered
    rows; a :class:`QTG` table's rows go through the straight-through
    estimator with the master's rows).  A table sharded at rest is
    gathered first (:func:`gather_weight`), or, when only its rows are
    sharded and no gradient is taken on the mesh (``grad_axes``), only the
    looked-up rows are (:func:`_take_sharded_rows`).  Under sharded-compute
    hints the rows are handed back as the layer carry ``carry``
    (:func:`carry_spec`) rests."""
    h = get_hints()
    if h is not None and h.exact_tp and not h.grad_axes \
            and not isinstance(w, QTG):
        entry = _row_block_entry(w)
        if entry is not None:
            return _take_sharded_rows(w, idx, h.mesh, entry)
    if h is not None and not h.exact_tp:
        # sharded compute: the FSDP blocks gathered; a table whose rows rest
        # on the model axis is a row-parallel product (one-hot rows times
        # the table): each rank's rows of the tokens it holds, zeros for
        # the others, summed onto the carry's layout (exact: one term a
        # row is not zero); under feature_axes each rank's rows keep its
        # block of the features (the stationary carry)
        table, spec = _local_weight(gather_weight(w), h.mesh)
        rows_axes, f_axes = _split(h.mesh, spec[0]), _split(h.mesh, spec[-1])
        if not rows_axes:
            out = _lookup(table, idx)
            if carry is not None:
                out = _cut(out, 1, carry[1], h.mesh)
        else:
            parts = tuple(table) if isinstance(table, (QT, QT4, QTG)) \
                else (table,)
            n_loc = parts[0].shape[0]
            local = idx - block_index(h.mesh, rows_axes)[1] * n_loc
            own = ((local >= 0) & (local < n_loc))[..., None]
            rows = _lookup(table, local.clamp(0, n_loc - 1))
            out = _reduce_partial(
                torch.where(own, rows, torch.zeros_like(rows)), rows_axes, h,
                carry)
        if carry is not None and not f_axes:
            out = _cut(out, -1, carry[-1], h.mesh)
        assert not f_axes or (carry is not None
                              and f_axes == _split(h.mesh, carry[-1])), \
            (spec, carry)
        return out
    return _lookup(gather_weight(w), idx)


def _lookup(w: Any, idx: torch.Tensor) -> torch.Tensor:
    """The rows ``idx`` of a table held whole (a tensor or a QT / QT4 /
    QTG), dequantized."""
    if isinstance(w, QTG):
        return _ste(w, idx)
    if isinstance(w, (QT, QT4)):
        rows = w.q[idx]
        if isinstance(w, QT4):
            rows = _unpack4(rows)
        scale = w.scale if w.scale.dim() == 0 or w.scale.shape[0] == 1 \
            else w.scale[idx]
        zero = w.zero if w.zero.dim() == 0 or w.zero.shape[0] == 1 \
            else w.zero[idx]
        return rows.to(torch.bfloat16) * scale.to(torch.bfloat16) \
            + zero.to(torch.bfloat16)
    return w[idx]


# ------------------------------------------------------------------------ primitives

def rms_norm(x: torch.Tensor, scale: Any, eps: float = 1e-6, *,
             x_axes: Any = None, split: Any = None) -> torch.Tensor:
    """RMS norm over the last dim, statistics in float32.  Under
    sharded-compute hints ``x_axes`` names the mesh axes ``x``'s features
    are split over (a layer carry's in the weight-stationary decode, an
    SSM's inner channels over the model axis): the squares are summed over
    them and ``scale`` is taken at this rank's block (cut here when it
    rests whole, as it rests when split over the same axes).  ``split``
    says that the norm runs on compute that differs rank by rank along
    the model axis (a carry split along S there, a rank's heads): the
    scale's gradient is then summed over it (:func:`split_use`)."""
    h = sharded_compute()
    axes = () if h is None else _split(h.mesh, x_axes)
    if h is not None and split:
        scale = split_use(scale)
    if axes:
        sl, spec = local_weight(scale)
        s_axes = _split(h.mesh, spec[-1])
        assert s_axes in ((), axes), (spec, axes)
        n = sl.shape[-1] * block_index(h.mesh, s_axes or None)[0]
        if not s_axes:
            sl = _cut(sl, -1, axes, h.mesh)
        xf = x.float()
        # each rank normalizes its own features by the total: its
        # gradient is summed back over them
        ss = collectives.all_reduce_sum(
            h.mesh, torch.sum(xf * xf, dim=-1, keepdim=True), axes,
            grad_axes=axes)
        return (xf * torch.rsqrt(ss / n + eps)).to(x.dtype) \
            * sl.to(x.dtype)
    scale = gather_weight(scale) if h is None else local_weight(scale)[0]
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, n, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)            # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` op by op as the JAX package lowers it (negate, exp,
    add, divide, multiply, each rounded to ``x.dtype``); ``F.silu`` rounds
    once and differs in the last bf16 bit on about a third of the inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``: ``max(x, 0) + log1p(exp(-|x|))``, NaN passed
    through); ``F.softplus`` returns ``x`` itself above its threshold of
    20."""
    y = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, y)


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax written out as the JAX package computes it (exp of the
    max-shifted input, divided by its sum)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries along the last axis and their indices,
    ties broken toward the lower index as ``jax.lax.top_k`` breaks them (a
    stable descending sort; ``torch.topk`` documents no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def swiglu(x: torch.Tensor, w_gate: Any, w_up: Any, w_down: Any, *,
           x_axes: Any = None, carry: Optional[tuple] = None) -> torch.Tensor:
    """``silu(x @ w_gate) * (x @ w_up) @ w_down``; under sharded compute
    the hidden is the gate's column block and ``w_down`` takes it
    row-parallel (``x_axes`` and ``carry`` as in :func:`matmul`)."""
    g, g_axes = _matmul(x, w_gate, x_axes=x_axes)
    u = matmul(x, w_up, x_axes=x_axes)
    return matmul(silu(g) * u, w_down, x_axes=g_axes, carry=carry)


# -------------------------------------------------------------------------- attention

NEG_INF = -1e9


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: Any = 0,
                  kv_len: Any = None, q_block: int = 0,
                  kv_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, H, hd); k, v: (B, T, KV, hd).  ``q_offset`` (global position
    of q[0]) and ``kv_len`` (valid cache length) are scalars for a lockstep
    batch, or ``(B,)`` tensors for a slot batch, where each row is an
    independent request with its own cache length (continuous batching).
    KV heads are broadcast up to H, scores come from bf16 operands
    accumulated in float32, the softmax runs in float32 and the
    probabilities are cast to ``v``'s dtype for the second product — the
    JAX package's contract.

    ``q_block > 0`` attends ``q_block`` query rows at a time (S must be a
    multiple of it), so the live score tensor is (B, H, q_block, T) instead
    of (B, H, S, T); each block's softmax is exact over all of T.  Per-slot
    offsets take one block, as in the JAX package.

    Sharded compute: q / k / v are this rank's heads
    (:func:`attention_blocks`), and with ``kv_axes`` k / v are this rank's
    block of a T split over those mesh axes (the block at the rank's
    coordinate, its positions global): :func:`_combine` makes the softmax
    over all of T exact across the blocks.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    # JAX rounds a Python scalar to the dtype of the array it meets (weak
    # typing): hd**-0.5 becomes a bf16 value before it scales bf16 q
    scale = float(torch.tensor(hd ** -0.5, dtype=q.dtype))
    if G > 1:
        k = k[:, :, :, None, :].expand(B, T, KV, G, hd).reshape(B, T, H, hd)
        v = v[:, :, :, None, :].expand(B, T, KV, G, hd).reshape(B, T, H, hd)

    t0 = 0
    if kv_axes:
        h = get_hints()
        t0 = block_index(h.mesh, kv_axes)[1] * T

    def block(qb: torch.Tensor, off: Any, kf=None) -> torch.Tensor:
        # one block's float32 copy of k is a temporary of the product;
        # blocks share one (``kf``)
        Sb = qb.shape[1]
        s = torch.einsum("bsnh,btnh->bnst",
                         (qb * scale).to(torch.bfloat16).float(),
                         kf if kf is not None
                         else k.to(torch.bfloat16).float())
        if _per_slot(off) or _per_slot(kv_len):
            mask = _slot_mask(B, Sb, T, causal, off, kv_len, q.device, t0)
        else:
            tpos = torch.arange(T, device=q.device)
            if t0:
                tpos = tpos + t0
            qpos = off + torch.arange(Sb, device=q.device)
            mask = torch.ones((Sb, T), dtype=torch.bool, device=q.device)
            if causal:
                mask &= tpos <= qpos[:, None]
            if kv_len is not None:
                mask &= tpos < kv_len
        if kv_axes:
            return _combine(torch.where(mask, s, NEG_INF), v, h.mesh,
                            kv_axes)
        p = softmax(torch.where(mask, s, NEG_INF))
        return torch.einsum("bnst,btnh->bsnh", p.to(v.dtype), v)

    if q_block <= 0 or q_block >= S or _per_slot(q_offset):
        return block(q, q_offset)
    if S % q_block:
        raise ValueError(f"q_block {q_block} does not divide the "
                         f"{S} query rows")
    kf = k.to(torch.bfloat16).float()
    return torch.cat([block(q[:, i:i + q_block], q_offset + i, kf)
                      for i in range(0, S, q_block)], dim=1)


def _combine(s: torch.Tensor, v: torch.Tensor, mesh,
             axes: Tuple[str, ...]) -> torch.Tensor:
    """``softmax(s) @ v`` over a T split across the ranks of ``axes``, each
    holding its block of the masked float32 scores ``s`` (B, H, Sq, T_loc)
    and of ``v``: the row maxima all-reduced by max (exact), each block's
    exps taken against that global max and their sums all-reduced, so
    every probability is the unsplit softmax's up to the order of that
    float32 sum; the probabilities are cast to ``v``'s dtype before the
    second product, as unsplit; the partial outputs are accumulated and
    summed over the ranks in float32, then rounded to ``v``'s dtype once.
    A block that every row masks contributes exps of 0."""
    # the max carries no gradient (the softmax does not move with a shift)
    m = collectives.all_reduce(
        mesh, s.detach().amax(dim=-1, keepdim=True), axes, "max")
    e = torch.exp(s - m)
    # every rank divides its own block by the total: summed back over them
    total = collectives.all_reduce_sum(mesh, e.sum(dim=-1, keepdim=True),
                                       axes, grad_axes=axes)
    p = (e / total).to(v.dtype)
    o = torch.einsum("bnst,btnh->bsnh", p.float(), v.float())
    # the output stays in the block's split compute (the row-parallel
    # ``wo`` takes a rank's share of its gradient): summed back too
    return collectives.all_reduce_sum(mesh, o, axes,
                                      grad_axes=axes).to(v.dtype)


def _kv_run(H: int, KV: int, h0: int, Hl: int) -> Optional[Tuple[int, int]]:
    """The KV heads ``[kv0, kv1)`` q heads ``[h0, h0 + Hl)`` read, when they
    read them as whole groups (or all one head); None otherwise."""
    G = H // KV
    kv0, kv1 = h0 // G, (h0 + Hl - 1) // G + 1
    if Hl % (kv1 - kv0) == 0 and (Hl // (kv1 - kv0) == G or kv1 - kv0 == 1):
        return kv0, kv1
    return None


def attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, cache_side: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                Tuple[str, ...], Tuple[str, ...]]:
    """q (B, S, Hq, hd), k / v (B, T, KVc, hd) as this rank attends them
    under sharded-compute hints, the axes their T is split over
    (``gqa_attention``'s ``kv_axes``) and the axes the heads are (the
    attention output's, ``wo``'s ``x_axes``); the inputs themselves and
    ``()``, ``()`` otherwise.

    q arrives with the heads its projection's weight holds (all ``n_heads``
    or the model-axis block), k / v with the KV heads theirs hold (all or
    the block) and, on the cache side, the T block the cache holds
    (``cache_seq_axes``).  :func:`~repro_torch.distributed.ctx.
    constrain_scores` decides the compute's layout: heads over the model
    axis, or T over ``kv_seq_axes`` (then every head on every rank).  q
    head h reads KV head ``h // (n_heads / n_kv_heads)``, so a block of q
    heads reads a contiguous run of KV heads."""
    h = sharded_compute()
    if h is None:
        return q, k, v, (), ()
    mesh = h.mesh
    B, S, _, hd = q.shape
    H, KV = n_heads, n_kv_heads
    G = H // KV
    T = k.shape[1]
    split_t = cache_side and bool(h.cache_seq_axes)
    if split_t:
        T *= block_index(mesh, h.cache_seq_axes)[0]
    Bg = _global_rows(B, h)
    _, heads, _, seq = constrain_scores((Bg, H, S, T))
    kseq = constrain_heads((Bg, T, H, hd), is_cache_side=cache_side)[1]
    assert kseq in (None, seq), (kseq, seq)
    if split_t:
        assert _entry(seq) == tuple(h.cache_seq_axes), \
            (seq, h.cache_seq_axes)
    m = h.model_axis
    if heads is not None:
        size, idx = block_index(mesh, heads)
        Hl = H // size
        h0 = idx * Hl
        if q.shape[2] == H:
            q = q[:, :, h0:h0 + Hl]
        assert q.shape[2] == Hl, (tuple(q.shape), Hl)
        run = _kv_run(H, KV, h0, Hl)
        if k.shape[2] == KV and (run is None or run[1] - run[0] < KV):
            # every KV head rests here: those the block reads
            if run is not None:
                k, v = k[:, :, run[0]:run[1]], v[:, :, run[0]:run[1]]
            else:                     # no whole group: one KV head a q head
                sel = torch.arange(h0, h0 + Hl, device=k.device) // G
                k, v = k[:, :, sel], v[:, :, sel]
        # else the KV heads the block reads already (the projection's block)
        assert Hl % k.shape[2] == 0, (Hl, tuple(k.shape))
    else:
        if seq is None and torch.is_grad_enabled() and q.requires_grad \
                and m and mesh.shape[m] > 1:
            raise NotImplementedError(
                "sharded-compute training of attention whose heads do not "
                "split over the model axis")
        # every head to each rank of a T split, which attends over its own
        # block of T: the shares of the gradient summed back
        if q.shape[2] != H:
            q = collectives.all_gather(mesh, q, 2, m, grad="reduce_scatter")
        if k.shape[2] != KV:
            k = collectives.all_gather(mesh, k, 2, m, grad="reduce_scatter")
            v = collectives.all_gather(mesh, v, 2, m, grad="reduce_scatter")
    if seq is not None and not split_t:
        # a whole T attended split (a T-split decision over a whole k)
        size, idx = block_index(mesh, seq)
        Tl = T // size
        k, v = k[:, idx * Tl:(idx + 1) * Tl], v[:, idx * Tl:(idx + 1) * Tl]
    return q, k, v, _entry(seq), _split(mesh, heads)


def head_block(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's block of the q heads and of the KV heads they read, when
    exact-TP hints split the heads (``head_axes``); all heads otherwise.
    q head h reads KV head ``h // (H / KV)``, so both blocks are
    contiguous.  Attention does not mix heads, so attending over the block
    gives the block of the whole computation."""
    h = get_hints()
    if h is None or not h.head_axes:
        return q, k, v
    size, idx = block_index(h.mesh, h.head_axes)

    def block(t):
        n = t.shape[2] // size
        assert n * size == t.shape[2], (t.shape, h.head_axes)
        return t[:, :, idx * n:(idx + 1) * n]
    return block(q), block(k), block(v)


def gather_heads(attn: torch.Tensor) -> torch.Tensor:
    """The (B, S, H, hd) attention output of every head, from this rank's
    :func:`head_block` of it (an all-gather; the identity when the heads
    are not split)."""
    h = get_hints()
    if h is None or not h.head_axes:
        return attn
    # exact TP: every rank repeats what follows on the whole output
    return collectives.all_gather(h.mesh, attn, 2, h.head_axes, grad="cut")


def _per_slot(a: Any) -> bool:
    return isinstance(a, torch.Tensor) and a.dim() == 1


def _slot_mask(B: int, S: int, T: int, causal: bool, q_offset: Any,
               kv_len: Any, device: torch.device,
               t0: int = 0) -> torch.Tensor:
    """(B, 1, S, T) mask of a slot batch: row b keeps ``tpos <= q_offset[b]
    + s`` (causal) and ``tpos < kv_len[b]``; a scalar stands for every row.
    The head axis broadcasts against the (B, H, S, T) scores.  ``t0`` is
    the global position of the first of the T columns (a block of a split
    T)."""
    tpos = torch.arange(T, device=device)
    if t0:
        tpos = tpos + t0
    qpos = (torch.as_tensor(q_offset, device=device).reshape(-1, 1)
            + torch.arange(S, device=device))                 # (B|1, S)
    mask = torch.ones((B, S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= tpos <= qpos[..., None]
    if kv_len is not None:
        mask &= tpos < torch.as_tensor(kv_len, device=device).reshape(-1, 1, 1)
    return mask[:, None]


def update_kv_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: Any) -> None:
    """Write step-k/v (B, S, KV, hd) into preallocated (B, T, KV, hd) caches
    along T, **in place** (the JAX package returns updated copies; the port
    reuses the cache's memory).

    ``pos`` is the write offset: an int writes every row at the same
    position (lockstep), a ``(B,)`` tensor writes row b at ``pos[b]`` (slot
    batch: a freshly admitted request and one 100 tokens deep share one
    step).
    """
    S = k.shape[1]
    h = sharded_compute()
    if h is not None and h.cache_seq_axes:
        _update_owned(cache_k, cache_v, k, v, pos, h)
        return
    if _per_slot(pos):
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        cols = pos.to(k.device).reshape(-1, 1) + torch.arange(S,
                                                              device=k.device)
        cache_k[rows, cols] = k.to(cache_k.dtype)
        cache_v[rows, cols] = v.to(cache_v.dtype)
        return
    cache_k[:, pos:pos + S] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + S] = v.to(cache_v.dtype)


def _update_owned(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, pos: Any, h) -> None:
    """:func:`update_kv_cache` of a cache whose T rests split over
    ``cache_seq_axes``: this rank holds the positions
    ``[t0, t0 + T_loc)`` and writes only the step's rows that land there
    (the others' owners write theirs)."""
    S, Tl = k.shape[1], cache_k.shape[1]
    t0 = block_index(h.mesh, h.cache_seq_axes)[1] * Tl
    if _per_slot(pos):
        gpos = pos.to(k.device).reshape(-1, 1) + torch.arange(
            S, device=k.device)                             # (B, S)
        own = (gpos >= t0) & (gpos < t0 + Tl)
        rows = torch.arange(k.shape[0], device=k.device)[:, None].expand(
            -1, S)
        cache_k[rows[own], gpos[own] - t0] = k[own].to(cache_k.dtype)
        cache_v[rows[own], gpos[own] - t0] = v[own].to(cache_v.dtype)
        return
    lo, hi = max(pos, t0), min(pos + S, t0 + Tl)
    if lo < hi:
        cache_k[:, lo - t0:hi - t0] = k[:, lo - pos:hi - pos].to(
            cache_k.dtype)
        cache_v[:, lo - t0:hi - t0] = v[:, lo - pos:hi - pos].to(
            cache_v.dtype)


# --------------------------------------------------------- the layer carry
#
# Under sharded-compute hints a layer carry (B, S, D) rests as
# ``distributed.ctx.constrain_activation`` decides for its global shape
# (:func:`carry_spec`): this rank's rows (split by the caller), and its
# block of S over the model axis (sequence parallelism) or of D over the
# feature axes (the weight-stationary decode).  The model code takes that
# decision once a step and hands it, with the carry, to the functions that
# read the layout (these, :func:`take_rows`, :func:`rms_norm`,
# :func:`matmul`), which never infer it from a tensor's size.  With no
# hints, or exact-TP ones, the decision is None and each is the identity.


def carry_spec(rows: int, S: int, D: int) -> Optional[tuple]:
    """The layout of a layer carry of this rank's ``rows`` rows, ``S``
    positions and ``D`` features under sharded-compute hints (the spec
    ``constrain_activation`` decides for its global shape); None when it
    rests whole, with no hints or exact-TP ones."""
    h = sharded_compute()
    if h is None:
        return None
    return constrain_activation((_global_rows(rows, h), S, D))


def carry_features(spec: Optional[tuple]) -> Any:
    """The mesh axes a carry of layout ``spec`` splits its features over
    (None when whole): the ``x_axes`` of its norm and of its products."""
    return None if spec is None else spec[-1]


def carry_seq(spec: Optional[tuple]) -> Any:
    """The mesh axes a carry of layout ``spec`` splits its S positions over
    (None when whole): a norm on it takes ``split=`` them."""
    return None if spec is None else spec[1]


def _cut(x: torch.Tensor, dim: int, entry, mesh) -> torch.Tensor:
    """This rank's block of ``x`` (whole along ``dim``, alike on every rank
    of the entry's axes) over the spec entry ``entry``; ``x`` itself when
    ``entry`` is None (:func:`~repro_torch.distributed.collectives.cut`:
    its backward all-gathers)."""
    return collectives.cut(mesh, x, dim, _entry(entry))


def activation_block(x: torch.Tensor, spec: Optional[tuple]) -> torch.Tensor:
    """This rank's block of a layer carry held whole along S and D (its
    rows this rank's): cut along each dim its layout ``spec`` splits."""
    if spec is None:
        return x
    mesh = sharded_compute().mesh
    return _cut(_cut(x, 1, spec[1], mesh), -1, spec[-1], mesh)


def constrain_carry(x: torch.Tensor, S: int, D: int) -> torch.Tensor:
    """The JAX package's ``constrain_activation`` of a layer carry of ``S``
    positions and ``D`` features, at its places (after the embedding, after
    each layer).  The carry's producers here — :func:`take_rows` and the
    row-parallel products, and the residual sums of them — already hand
    back this rank's block of the layout :func:`carry_spec` decides, so
    this asserts it and returns ``x``."""
    spec = carry_spec(x.shape[0], S, D)
    if spec is not None:
        mesh = sharded_compute().mesh
        want = (x.shape[0], S // block_index(mesh, spec[1])[0],
                D // block_index(mesh, spec[-1])[0])
        assert tuple(x.shape) == want, (tuple(x.shape), want, spec)
    return x


def whole_activation(x: torch.Tensor, spec: Optional[tuple], *,
                     features: bool = False) -> torch.Tensor:
    """A layer carry of layout ``spec`` with its S positions whole
    (all-gathered over the model axis when sequence-parallel) and, with
    ``features``, its D whole (all-gathered over the feature axes); rows
    stay this rank's.  It hands the carry to compute that differs rank by
    rank (the block's column-parallel products, its experts): in training
    the gather's backward reduce-scatters the ranks' shares of the
    gradient, and a carry already whole over the model axis enters
    through :func:`~repro_torch.distributed.collectives.enter_split`."""
    h = sharded_compute()
    if h is None:
        return x
    mesh = h.mesh
    if spec is not None and spec[1] is not None:
        x = collectives.all_gather(mesh, x, 1, spec[1],
                                   grad="reduce_scatter")
    elif h.model_axis:
        x = enter_split(mesh, x, (h.model_axis,))
    if features and spec is not None and spec[-1] is not None:
        x = collectives.all_gather(mesh, x, x.dim() - 1, spec[-1],
                                   grad="reduce_scatter")
    return x


def last_position(x: torch.Tensor, spec: Optional[tuple]) -> torch.Tensor:
    """``x[:, -1:]`` of a layer carry of layout ``spec``: from the last
    rank along the model axis when the carry is split along S."""
    if spec is None or spec[1] is None:
        return x[:, -1:]
    mesh = sharded_compute().mesh
    (m,) = _entry(spec[1])
    return collectives.pick(mesh, x[:, -1:], m, mesh.shape[m] - 1)


def cache_rows(t: Any) -> Any:
    """This rank's block of activation rows that are whole on every rank
    where the cache's rows are split (``cache_batch_axes``, the
    weight-stationary decode); ``t`` otherwise (ints too)."""
    h = sharded_compute()
    if h is None or not h.cache_batch_axes or not isinstance(
            t, torch.Tensor) or t.dim() == 0:
        return t
    size, idx = block_index(h.mesh, h.cache_batch_axes)
    n = t.shape[0] // size
    return t[idx * n:(idx + 1) * n]


def gather_cache_rows(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`cache_rows`: every rank's rows, gathered."""
    h = sharded_compute()
    if h is None or not h.cache_batch_axes:
        return t
    return collectives.all_gather(h.mesh, t, 0, h.cache_batch_axes,
                                  grad="cut")


def cache_seq_block(S: int, max_len: int) -> Tuple[int, int, int, int]:
    """(lo, hi, t0, T_loc): the positions ``[lo, hi)`` of a prompt's
    ``[0, S)`` that this rank's block of a ``max_len``-row cache holds,
    the block's first position and its length — ``(0, S, 0, max_len)``
    unless the cache's T rests split (``cache_seq_axes``)."""
    h = sharded_compute()
    if h is None or not h.cache_seq_axes:
        return 0, S, 0, max_len
    size, idx = block_index(h.mesh, h.cache_seq_axes)
    Tl = max_len // size
    assert Tl * size == max_len, (max_len, h.cache_seq_axes)
    t0 = idx * Tl
    hi = min(S, t0 + Tl)
    return min(t0, hi), hi, t0, Tl


# ------------------------------------------------------------- paged KV cache
#
# Block-pool primitives for the paged KV cache: the pool leaf layout is
# (n_blocks, block_size, KV, hd_store) a layer, and a request's logical
# sequence is the concatenation of the blocks its (max_blocks,) row of the
# block table names.  Block id 0 is the TRASH block: inactive lanes of the
# decode step point every table entry at it, so their garbage writes land in
# memory no request ever gathers as live rows.  The JAX package returns
# updated pools; the port writes the pool in place, as ``update_kv_cache``
# writes the slot cache.


def gather_blocks(pool_leaf: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Gather per-request sequences out of a block pool.

    pool_leaf: (NB, BS, ...) one layer's pool; bt: (B, MB) integer block
    table.  Returns (B, MB * BS, ...): each request's blocks concatenated in
    table order, standing in for the slot cache's (B, T, ...) axis
    (positions >= kv_len are masked by attention like slot-pool padding).
    """
    g = pool_leaf[bt.to(device=pool_leaf.device, dtype=torch.int64)]
    return g.reshape((bt.shape[0], -1) + tuple(pool_leaf.shape[2:]))


def scatter_blocks(pool_leaf: torch.Tensor, bt: torch.Tensor,
                   positions: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Write per-request rows into the pool through the block table, **in
    place**, and return the pool.

    pool_leaf: (NB, BS, ...); bt: (B, MB); positions: (B, S) global token
    positions; val: (B, S, ...).  Row (b, s) lands at block
    ``bt[b, positions[b, s] // BS]``, offset ``positions[b, s] % BS``.
    Duplicate targets only arise from trash-block writes (several idle lanes
    aiming at block 0), where any winner is equally garbage.
    """
    NB, BS = pool_leaf.shape[0], pool_leaf.shape[1]
    dev = pool_leaf.device
    bt = bt.to(device=dev, dtype=torch.int64)
    positions = positions.to(device=dev, dtype=torch.int64)
    blk = torch.gather(bt, 1, positions // BS)                 # (B, S)
    idx = (blk * BS + positions % BS).reshape(-1)              # (B*S,)
    # .view, not .reshape: a reshape that had to copy would take the writes
    flat = pool_leaf.view((NB * BS,) + tuple(pool_leaf.shape[2:]))
    assert flat.data_ptr() == pool_leaf.data_ptr()
    flat[idx] = val.reshape((-1,) + tuple(val.shape[2:])).to(pool_leaf.dtype)
    return pool_leaf


def kv_quantize(x: torch.Tensor, bits: int):
    """Asymmetric per-(token, head) KV quantization over head_dim, applied
    as paged blocks are written (the JAX package's ``kv_quantize``).

    x: (..., hd) -> (q uint8 (..., hd) [or (..., hd/2) nibble-packed at
    bits=4, the low nibble at the even index], scale bf16 (..., 1), zero
    bf16 (..., 1)).  Computed in float32; ``torch.round`` rounds half to
    even, as ``jnp.round`` does.
    """
    assert bits in (8, 4), bits
    xf = x.float()
    lo = torch.amin(xf, dim=-1, keepdim=True)
    hi = torch.amax(xf, dim=-1, keepdim=True)
    qmax = (1 << bits) - 1
    scale = (hi - lo) / qmax
    scale = torch.where(scale == 0.0, 1.0, scale)    # constant vector guard
    q = torch.clamp(torch.round((xf - lo) / scale), 0, qmax).to(torch.uint8)
    if bits == 4:
        q = q[..., 0::2] | (q[..., 1::2] << 4)       # nibble-pack along hd
    return q, scale.to(torch.bfloat16), lo.to(torch.bfloat16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: uint8 symbols -> bf16 K/V rows,
    written as :func:`deq` is (a bf16 product, then a bf16 sum)."""
    assert bits in (8, 4), bits
    if bits == 4:
        q = _unpack4(q)
    bf = torch.bfloat16
    return q.to(bf) * scale.to(bf) + zero.to(bf)


# ---------------------------------------------------------------------- loss helpers

def sharded_xent(x: torch.Tensor, head: Any, labels: torch.Tensor,
                 vocab: int, carry: Optional[tuple], *,
                 tied: bool = False) -> torch.Tensor:
    """:func:`softmax_xent` of ``x @ head`` under sharded-compute hints: the
    mean over every token of the global batch, on every rank.

    ``x`` is this rank's block of the final carry (layout ``carry``) and
    ``labels`` its rows' labels, every position.  The carry's S is
    gathered and ``head`` (``(D, V)``; a tied ``(V, D)`` table with
    ``tied``) is column-parallel over the vocabulary, so a rank holds the
    logits of its block of the vocabulary for its rows: the log-sum-exp
    and the label's logit are summed over the model axis (the max taken
    first, exact, with no gradient), every rank then holds each token's
    loss alike, and the token sum and count are summed over the data axes
    — the logits are never gathered.  In the backward the model-axis sums
    are the identity (the loss is replicated there) and the data-axis sum
    sums the ranks' gradients (rank losses are summed there)."""
    h = sharded_compute()
    mesh = h.mesh
    xs = whole_activation(x, carry)
    if tied:
        # this rank's rows of the table dequantized, then x @ rows.T (a
        # QT4 packs its nibbles along D and a QTG's master is the table:
        # neither has a transposed form)
        wl, spec = _local_weight(gather_weight(split_use(head)), mesh)
        logits = xs @ _deq_plain(wl, xs.dtype).T
        v_axes = _split(mesh, spec[0])
    else:
        logits, v_axes = _matmul(xs, head)
    lf = logits.float()
    Vl = lf.shape[-1]
    v0 = block_index(mesh, v_axes or None)[1] * Vl
    m = collectives.all_reduce(mesh, lf.detach().amax(-1, keepdim=True),
                               v_axes, "max")
    se = collectives.all_reduce_sum(mesh, torch.exp(lf - m).sum(-1),
                                    v_axes, grad_axes=())
    lse = m[..., 0] + torch.log(se)
    own = (labels >= v0) & (labels < v0 + Vl)
    ll = torch.gather(lf, -1, (labels - v0).clamp(0, Vl - 1).long()[
        ..., None])[..., 0]
    ll = collectives.all_reduce_sum(
        mesh, torch.where(own, ll, torch.zeros_like(ll)), v_axes,
        grad_axes=())
    mask = (labels >= 0) & (labels < vocab)
    data = h.batch_axes
    num = collectives.all_reduce_sum(mesh, torch.sum((lse - ll) * mask),
                                     data, grad_axes=data)
    cnt = collectives.all_reduce_sum(mesh, torch.sum(mask).float(), data)
    return num / torch.clamp(cnt, min=1)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Mean token cross-entropy in float32; labels outside ``[0, vocab)``
    (padding) are masked out."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(0, logits.shape[-1] - 1)
                      .long()[..., None])[..., 0]
    mask = (labels >= 0) & (labels < vocab)
    return torch.sum((lse - ll) * mask) / torch.clamp(torch.sum(mask), min=1)
