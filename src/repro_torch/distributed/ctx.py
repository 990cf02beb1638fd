"""Process-wide sharding-hints context and the sharded-at-rest weight
(PyTorch port of ``repro/distributed/ctx.py``).

Models are mesh-agnostic; the serving layer installs :class:`ShardingHints`
around each step it runs on a mesh (``ServeSteps``), and the weight reads
and layers of ``models.layers`` consult them.  Two profiles:

* **exact TP** (``exact_tp``, the serving engines' default): a weight rests
  sharded along its output channels — each rank keeps its block as a
  :class:`Sharded` — and :func:`constrain_replicated` all-gathers it at its
  use site.  The gather is pure data movement, so the consuming op reads
  the full tensor bit for bit and rounds exactly like one device.
  Attention may also split its heads (``head_axes``): each rank attends
  over its block and the blocks are gathered, which no head's result
  depends on.  The gather is differentiable (training on a mesh): its
  backward sums the full gradient over ``grad_axes`` — the data axes,
  whose ranks computed on different batch rows — and keeps this rank's
  block (a reduce-scatter along a dim those axes split).
* **sharded compute** (the production cells' hints, ``exact_tp`` off):
  each rank computes only its block.  The reference annotates activations
  for its compiler (``constrain_heads``, ``constrain_scores``,
  ``constrain_activation``); here each of those is a function that
  returns the same decision — the partition spec the reference would
  constrain the tensor of that global shape to, from the same
  :func:`_fits` tests — and the layers compute that block themselves: the
  heads over ``model``, the cache's T over ``kv_seq_axes`` (attended block
  by block and combined exactly), the layer carry's S over ``model``
  (``seq_sp``) or its D over the data axes (``feature_axes``, the
  weight-stationary decode).  Weights are gathered only along their FSDP
  blocks, and none under ``feature_axes`` (``models.layers.gather_weight``).
  Training computes so too (``launch/specs.py``'s train cells of the
  dense and MoE families): every collective of the sharded forward is
  differentiable (``distributed/collectives.py`` says which conjugate
  each takes and why), the FSDP gather's backward reduce-scatters the
  gradient over the data axes, and ``grad_axes`` names the axes the rank
  losses are summed over.

The port's rows arrive split by the caller (``ServeSteps.rows_over``), so
``batch_axes`` states how they are split rather than asking for a split;
the deciders take global shapes, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardingHints:
    mesh: object
    batch_axes: Tuple[str, ...] = ("data",)   # () when batch is unsharded
    model_axis: Optional[str] = "model"
    kv_seq_axes: Tuple[str, ...] = ()         # cache T-dim sharding (decode)
    seq_sp: bool = True                       # sequence-parallel layer carries
    feature_axes: Tuple[str, ...] = ()        # weight-stationary decode
    exact_tp: bool = False                    # bit-identical sharded serving:
    #   weights stay sharded at REST (per-rank memory divided along output
    #   channels) and are all-gathered at their USE site, so every compute
    #   op runs with reference shapes and rounds exactly like one device
    head_axes: Tuple[str, ...] = ()           # exact TP: attention heads
    #   split over these axes; each rank attends over its block of heads
    #   (its KV cache holds only those) and the outputs are gathered
    grad_axes: Tuple[str, ...] = ()           # training: the axes the
    #   rank losses are summed over (the data axes; the loss is replicated
    #   over the others).  A gradient is summed over them: a gathered
    #   weight's before the rank keeps its block, an all-reduce's in its
    #   backward, a whole leaf's after the backward
    cache_seq_axes: Tuple[str, ...] = ()      # sharded compute: the axes
    #   the cache's T rests on (its placement; ``kv_seq_axes`` is what
    #   attention decides, () in the reference's prefill cells)
    cache_batch_axes: Tuple[str, ...] = ()    # weight-stationary decode:
    #   the axes the cache's rows rest on while the activation rows are
    #   whole on every rank


_HINTS: list = [None]


def set_hints(h: Optional[ShardingHints]) -> None:
    _HINTS[0] = h


def get_hints() -> Optional[ShardingHints]:
    return _HINTS[0]


def _fits(dim: int, mesh, axes: Tuple[str, ...]) -> bool:
    if not axes:
        return False
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return dim % n == 0


def constrain_heads(shape: Sequence[int], *,
                    is_cache_side: bool = False) -> Optional[tuple]:
    """The spec ``(batch, seq, heads, None)`` of a global ``(B, T, H, hd)``
    q / k / v under non-exact hints (None with no hints or exact TP): batch
    over the batch axes, the cache's T over ``kv_seq_axes`` (cache side
    only), the heads over the model axis unless T took it."""
    h = get_hints()
    if h is None or h.exact_tp:
        return None
    B, T, H, _ = shape
    batch = h.batch_axes if _fits(B, h.mesh, h.batch_axes) else None
    seq = h.kv_seq_axes if (is_cache_side
                            and _fits(T, h.mesh, h.kv_seq_axes)) else None
    heads = None
    m = h.model_axis
    if m and _fits(H, h.mesh, (m,)) and (seq is None or m not in seq):
        heads = m
    return (batch, seq, heads, None)


def constrain_scores(shape: Sequence[int]) -> Optional[tuple]:
    """The spec ``(batch, heads, None, seq)`` of global ``(B, H, Sq, T)``
    attention scores under non-exact hints (None otherwise)."""
    h = get_hints()
    if h is None or h.exact_tp:
        return None
    B, H, _, T = shape
    batch = h.batch_axes if _fits(B, h.mesh, h.batch_axes) else None
    seq = h.kv_seq_axes if _fits(T, h.mesh, h.kv_seq_axes) else None
    heads = None
    m = h.model_axis
    if m and _fits(H, h.mesh, (m,)) and (seq is None or m not in seq):
        heads = m
    return (batch, heads, None, seq)


def constrain_activation(shape: Sequence[int]) -> Optional[tuple]:
    """The spec of a global ``(B, S, D)`` layer carry under non-exact hints
    (None when it stays whole: no hints, exact TP, fewer than 3 dims, or
    nothing fits).  With ``feature_axes`` D rides them; otherwise B rides
    the batch axes and, with ``seq_sp``, S rides the model axis
    (sequence parallelism: the row-parallel all-reduce becomes a
    reduce-scatter + all-gather pair of equal bytes).  A decode step's S
    of 1 never fits."""
    h = get_hints()
    if h is None or h.exact_tp or len(shape) < 3:
        return None
    if h.feature_axes:
        if not _fits(shape[-1], h.mesh, h.feature_axes):
            return None
        return (None,) * (len(shape) - 1) + (h.feature_axes,)
    batch = h.batch_axes if _fits(shape[0], h.mesh, h.batch_axes) else None
    m = h.model_axis
    seq = m if (h.seq_sp and m and _fits(shape[1], h.mesh, (m,))) else None
    if batch is None and seq is None:
        return None
    return (batch, seq) + (None,) * (len(shape) - 2)


def sharded_compute() -> Optional[ShardingHints]:
    """The installed hints when they ask for sharded compute (not exact
    TP), else None."""
    h = get_hints()
    return h if h is not None and not h.exact_tp else None


class Sharded:
    """This rank's block of a tensor that rests sharded over the mesh:
    ``local`` and the spec it was cut by (one entry a dimension, padded
    with ``None``).  Model code reads it only through the weight reads of
    ``models.layers``: under exact TP they gather it first
    (:func:`constrain_replicated`); under sharded compute they gather its
    FSDP blocks and compute on the block that stays (``layers.matmul``,
    ``take_rows``, ``deq``).  Any other use fails for want of tensor
    methods.  Indexing the leading dimension, which must be unsharded (the
    layer stack), keeps the rest of the spec."""
    __slots__ = ("local", "spec")

    def __init__(self, local: torch.Tensor, spec: Sequence):
        assert len(spec) == local.dim(), (spec, local.shape)
        self.local = local
        self.spec = tuple(spec)

    def __getitem__(self, l) -> "Sharded":
        assert self.spec[0] is None, f"index of sharded dim 0 {self.spec}"
        return Sharded(self.local[l], self.spec[1:])

    def unbind(self) -> list:
        assert self.spec[0] is None, f"unbind of sharded dim 0 {self.spec}"
        return [Sharded(t, self.spec[1:]) for t in torch.unbind(self.local)]

    def to(self, device) -> "Sharded":
        return Sharded(self.local.to(device), self.spec)

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def nbytes(self) -> int:
        return self.local.numel() * self.local.element_size()

    def __repr__(self) -> str:
        return (f"Sharded(local={tuple(self.local.shape)}, spec={self.spec}, "
                f"{self.local.dtype})")


def block_index(mesh, entry) -> Tuple[int, int]:
    """(number of blocks, this rank's block) of a dim sharded by the spec
    entry ``entry`` (an axis name or a tuple of them, the first major)."""
    axes = () if entry is None else \
        (entry,) if isinstance(entry, str) else tuple(entry)
    size, idx = 1, 0
    for a in axes:
        size *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coord[a]
    return size, idx


def local_block(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec``: along each
    sharded dim, the block at the rank's coordinate over the entry's axes
    (the first axis major).  A view of ``t``."""
    out = t
    for d, e in enumerate(spec):
        if e is None:
            continue
        size, idx = block_index(mesh, e)
        step = t.shape[d] // size
        assert step * size == t.shape[d], (t.shape, spec)
        out = out.narrow(d, idx * step, step)
    return out


def shard(t: torch.Tensor, spec: Sequence, mesh):
    """``t`` placed by ``spec``: a :class:`Sharded` holding a copy of this
    rank's block (so the full tensor can be freed), or ``t`` itself when
    ``spec`` shards nothing."""
    entries = tuple(spec) + (None,) * (t.dim() - len(spec))
    if all(e is None for e in entries):
        return t
    return Sharded(local_block(t, entries, mesh).clone(), entries)


class _GatherAtUse(torch.autograd.Function):
    """All-gather a block along each sharded dim of ``spec`` (forward); sum
    the full gradient over ``grad_axes`` and keep this rank's block
    (backward): a reduce-scatter along each dim whose entry names only
    those axes, an all-reduce over the ones no such dim names, then the
    block of the dims left (their ranks repeat the compute: the gradient
    is whole on each)."""

    @staticmethod
    def forward(ctx, local, spec, mesh, grad_axes):
        from . import collectives
        ctx.spec, ctx.mesh, ctx.grad_axes = spec, mesh, grad_axes
        out = local
        for d, e in enumerate(spec):
            if e is not None:
                out = collectives.all_gather(mesh, out, d, e)
        return out

    @staticmethod
    def backward(ctx, g):
        from . import collectives
        spec, done = list(ctx.spec), set()
        for d, e in enumerate(ctx.spec):
            axes = () if e is None else (e,) if isinstance(e, str) \
                else tuple(e)
            if axes and all(a in ctx.grad_axes for a in axes):
                g = collectives.reduce_scatter(ctx.mesh, g, d, axes)
                spec[d] = None
                done.update(axes)
        g = collectives.all_reduce_sum(
            ctx.mesh, g, tuple(a for a in ctx.grad_axes if a not in done))
        return local_block(g, spec, ctx.mesh).clone(), None, None, None


def constrain_replicated(x: Any) -> Any:
    """Exact sharded serving and training: gather a :class:`Sharded` weight
    to every rank of its axes at its use site — an all-gather along each
    sharded dim, the full tensor bit for bit (differentiable: see
    :class:`_GatherAtUse`).  Anything else passes through, as it does with
    no ``exact_tp`` hints installed."""
    h = get_hints()
    if h is None or not h.exact_tp or not isinstance(x, Sharded):
        return x
    return _GatherAtUse.apply(x.local, x.spec, h.mesh, h.grad_axes)
