"""The collectives of the port's multi-device path, over the process groups
of a :class:`repro_torch.launch.mesh.Mesh`.

Each is pure data movement or a sum: :func:`all_gather` (concatenate
every rank's block along a dimension, over one or more mesh axes),
:func:`all_reduce_sum`, :func:`reduce_scatter` (the sum, of which each rank
keeps its block along a dimension), :func:`pick` (one rank's value to the
others of an axis) and :func:`gather_object` (a Python object from every
rank of the world).  The tensor ones skip the wire when their axes have
one rank.

Every tensor stays on its device: ``gloo`` takes CUDA tensors for the
all-gather and the all-reduce (checked on torch 2.11 with ranks sharing
one H100), so the port stages nothing through the host itself (the
backend copies as it needs).  ``gloo`` has no CUDA reduce-scatter, so on
it :func:`reduce_scatter` is an all-reduce of which the rank keeps its
block (the same sum; the recording still names the collective the
program asks for).  :data:`counts` counts the calls that reach the wire,
which the smoke's ``mesh`` and ``sharded`` lines report.

Inside :func:`recording` every such call is also recorded: its kind, its
output bytes (and a reduce-scatter's input bytes), the size of its group
and whether the group stays inside one node of
``launch.mesh.GPUS_PER_NODE`` cards (ranks numbered row-major over the
mesh axes, as ``init_device_mesh`` numbers them).  The dry-run prices
the records (``launch/roofline.py``).

**Gradients.**  On a training mesh every tensor collective is
differentiable.  Its forward is the call above, bit for bit; its backward
is its conjugate, which the call site names where a choice exists, and
goes out through the same functions (so it is counted and recorded too).
The backward collectives run in the order autograd reaches them, which
depends only on the program, the same on every rank: no data decides
whether one is issued.  A tensor that takes a gradient reaching a
collective whose site named no backward raises.

Which conjugate is right follows from two facts of the train step
(``training/train_loop.py``).  The rank losses are **summed over the data
axes** (each scaled by 1 / |data|; ``ShardingHints.grad_axes`` names
them), and the loss is **replicated over** ``model`` (every model rank
holds the same value and seeds its backward with it once).  So a tensor
every rank of ``model`` holds alike and computes on alike has its whole
gradient on each of them, while a tensor that feeds compute which differs
rank by rank (a column-parallel product, an expert block) gets from each
rank only that rank's share, and the shares must be summed:

* :func:`all_gather` of blocks: ``grad="reduce_scatter"`` when the
  gathered tensor feeds compute that differs rank by rank (the shares
  summed, each rank keeping its block's sum); ``grad="cut"`` when every
  rank computes on it alike (its gradient is whole on each: the rank
  keeps its block, no wire);
* :func:`reduce_scatter` ↔ an all-gather of the blocks' gradients;
* :func:`cut` (a whole tensor to this rank's block) ↔ an all-gather;
* :func:`all_reduce_sum` of partial sums: the backward sums over
  ``grad_axes`` and is the identity over the other axes — the identity
  over ``model`` when the sum is then used alike by every rank (the loss
  replicated there), a sum over the data axes where the rank losses are
  summed, and a sum over axes whose ranks go on to use the total
  differently (a norm's squares, a softmax's denominator);
* :func:`enter_split`: the identity forward, a sum over ``axes`` backward,
  for a tensor whole over ``model`` that enters compute which differs rank
  by rank (Megatron's *f*).  An all-gather with ``grad="reduce_scatter"``
  is an all-gather followed by it.

``min`` / ``max`` all-reduces carry no gradient: their inputs must be
detached.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

counts: Dict[str, int] = {"all_gather": 0, "all_reduce": 0,
                          "reduce_scatter": 0}

_RECORDS: List[Optional[list]] = [None]


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


@contextlib.contextmanager
def recording() -> Iterator[list]:
    """Record every collective that reaches the wire inside the block, as
    dicts ``{"kind", "bytes", "group", "intra_node", "axis", "dtype"}``
    (``kind`` ``"all-gather"``, ``"all-reduce"`` or ``"reduce-scatter"``,
    ``bytes`` the output's, ``axis`` the mesh axis, ``dtype`` the
    element type's name; a reduce-scatter's also ``"in_bytes"``, its
    input's)."""
    prev, _RECORDS[0] = _RECORDS[0], []
    try:
        yield _RECORDS[0]
    finally:
        _RECORDS[0] = prev


def axis_ranks(mesh, axis: str) -> List[int]:
    """The world ranks of this rank's group along ``axis`` (the ranks that
    differ from it only there), numbered row-major over the mesh axes."""
    stride = 1
    for a in reversed(mesh.axis_names):
        if a == axis:
            break
        stride *= mesh.shape[a]
    base = mesh.rank - mesh.coord[axis] * stride
    return [base + i * stride for i in range(mesh.shape[axis])]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _record(kind: str, mesh, axis: str, t: torch.Tensor, **extra) -> None:
    if _RECORDS[0] is None:
        return
    from repro_torch.launch.mesh import GPUS_PER_NODE
    nodes = {r // GPUS_PER_NODE for r in axis_ranks(mesh, axis)}
    _RECORDS[0].append(dict({"kind": kind, "bytes": _nbytes(t),
                             "group": mesh.shape[axis],
                             "intra_node": len(nodes) == 1, "axis": axis,
                             "dtype": str(t.dtype).replace("torch.", "")},
                            **extra))


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _declared(grad, kinds, what: str):
    if grad not in kinds:
        raise RuntimeError(
            f"{what} of a tensor that takes a gradient, and its call site "
            f"names no backward (grad= one of {kinds}, got {grad!r})")
    return grad


def all_gather(mesh, t: torch.Tensor, dim: int, axes, *,
               grad: Optional[str] = None) -> torch.Tensor:
    """Every rank's block of ``t`` along ``dim``, concatenated in the order
    of the mesh coordinate over ``axes`` (the first axis major, as a spec
    entry names them).  Exact: the result is the full tensor bit for bit.
    ``grad`` is the backward (``"reduce_scatter"`` or ``"cut"``, see the
    module docstring), needed only when ``t`` takes a gradient."""
    if _differentiable(t) and _gathers(mesh, axes):
        return _AllGather.apply(t, mesh, dim, axes, _declared(
            grad, ("reduce_scatter", "cut"), "all_gather"))
    return _all_gather(mesh, t, dim, axes)


def _gathers(mesh, axes) -> bool:
    return any(mesh.shape[a] > 1 for a in _axes(axes))


def _all_gather(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    for a in reversed(_axes(axes)):
        n = mesh.shape[a]
        if n == 1:
            continue
        counts["all_gather"] += 1
        import torch.distributed as dist
        src = t.contiguous()
        if mesh.backend == "fake":
            # a dry-run's world moves nothing: one buffer is all it needs
            # (the fake backend's list form costs ~10 ms a call)
            import warnings
            buf = src.new_empty((n,) + tuple(src.shape))
            with warnings.catch_warnings():   # renamed in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(buf, src, group=mesh.groups[a])
            t = torch.cat(buf.unbind(0), dim=dim)
        else:
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=mesh.groups[a])
            t = torch.cat(parts, dim=dim)
        _record("all-gather", mesh, a, t)
    return t


def all_reduce_sum(mesh, t: torch.Tensor, axes, *,
                   grad_axes: Optional[Tuple[str, ...]] = None
                   ) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (one axis after the
    other), returned as a new tensor.  A float sum: its rounding depends on
    the backward's order, so callers hold it to a tolerance.  ``grad_axes``
    (those of ``axes`` the backward sums over, ``()`` for the identity) is
    needed only when ``t`` takes a gradient."""
    if _differentiable(t) and _gathers(mesh, axes):
        if grad_axes is None:
            _declared(None, ("grad_axes",), "all_reduce_sum")
        return _AllReduceSum.apply(t, mesh, axes, tuple(grad_axes))
    return _all_reduce(mesh, t, axes, "sum")


def all_reduce(mesh, t: torch.Tensor, axes, op: str) -> torch.Tensor:
    """``t`` reduced by ``op`` (``"sum"``, ``"min"`` or ``"max"``) over the
    ranks along ``axes``, returned as a new tensor (``t`` itself when every
    axis has one rank).  ``min`` and ``max`` are exact and carry no
    gradient; a sum that does is :func:`all_reduce_sum`'s."""
    if _differentiable(t) and _gathers(mesh, axes):
        raise RuntimeError(f"all_reduce({op!r}) of a tensor that takes a "
                           f"gradient (detach it, or all_reduce_sum with "
                           f"grad_axes=)")
    return _all_reduce(mesh, t, axes, op)


def _all_reduce(mesh, t: torch.Tensor, axes, op: str) -> torch.Tensor:
    out = t
    for a in _axes(axes):
        if mesh.shape[a] == 1:
            continue
        counts["all_reduce"] += 1
        import torch.distributed as dist
        out = out.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()),
                        group=mesh.groups[a])
        _record("all-reduce", mesh, a, out)
    return out


def reduce_scatter(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes``, of which this rank
    keeps its block along ``dim`` (the block at its coordinate over
    ``axes``, the first axis major, as :func:`all_gather` concatenates):
    the inverse layout of an all-gather.  A float sum, as
    :func:`all_reduce_sum`'s.  Its backward all-gathers the blocks'
    gradients."""
    if _differentiable(t) and _gathers(mesh, axes):
        return _ReduceScatter.apply(t, mesh, dim, axes)
    return _reduce_scatter(mesh, t, dim, axes)


def _reduce_scatter(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    import torch.distributed as dist
    for a in _axes(axes):
        n = mesh.shape[a]
        if n == 1:
            continue
        counts["reduce_scatter"] += 1
        src = t.contiguous()
        assert src.shape[dim] % n == 0, (tuple(src.shape), dim, a, n)
        step = src.shape[dim] // n
        if mesh.backend == "gloo":
            full = src.clone()
            dist.all_reduce(full, group=mesh.groups[a])
            out = full.narrow(dim, mesh.coord[a] * step, step).clone()
        else:
            # the collective splits dim 0: bring ``dim`` to the front
            moved = src.movedim(dim, 0).contiguous()
            buf = moved.new_empty((step,) + tuple(moved.shape[1:]))
            import warnings
            with warnings.catch_warnings():   # renamed in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(buf, moved, group=mesh.groups[a])
            out = buf.movedim(0, dim)
        _record("reduce-scatter", mesh, a, out, in_bytes=_nbytes(src))
        t = out
    return t


def cut(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """This rank's block of ``t`` (whole along ``dim`` on every rank of
    ``axes``) at its coordinate over them, the first axis major: a view,
    no wire.  Its backward all-gathers the blocks' gradients (the whole
    tensor's gradient on every rank)."""
    axes = _axes(axes)
    size, idx = 1, 0
    for a in axes:
        size *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coord[a]
    if size == 1:
        return t
    n = t.shape[dim] // size
    assert n * size == t.shape[dim], (tuple(t.shape), dim, axes)
    if _differentiable(t):
        return _Cut.apply(t, mesh, dim, axes, idx * n, n)
    return t.narrow(dim, idx * n, n)


def enter_split(mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """``t`` itself (whole over ``axes``) as it enters compute that differs
    rank by rank: its backward sums the ranks' gradients over ``axes``.
    The identity when ``t`` takes no gradient or the axes have one rank."""
    if not (_differentiable(t) and _gathers(mesh, axes)):
        return t
    return _EnterSplit.apply(t, mesh, tuple(_axes(axes)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim, axes, grad):
        ctx.mesh, ctx.dim, ctx.axes, ctx.grad = mesh, dim, axes, grad
        return _all_gather(mesh, t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "reduce_scatter":
            out = _reduce_scatter(ctx.mesh, g, ctx.dim, ctx.axes)
        else:
            out = g
            for a in _axes(ctx.axes):
                n = ctx.mesh.shape[a]
                step = out.shape[ctx.dim] // n
                out = out.narrow(ctx.dim, ctx.mesh.coord[a] * step, step)
        return out, None, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, grad_axes):
        ctx.mesh, ctx.grad_axes = mesh, grad_axes
        return _all_reduce(mesh, t, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(ctx.mesh, g, ctx.grad_axes, "sum"), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return _reduce_scatter(mesh, t, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(ctx.mesh, g, ctx.dim, ctx.axes), None, None, None


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim, axes, start, n):
        ctx.mesh, ctx.dim, ctx.axes = mesh, dim, axes
        return t.narrow(dim, start, n)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(ctx.mesh, g, ctx.dim, ctx.axes), None, None,
                None, None, None)


class _EnterSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.mesh, g, ctx.axes, "sum"), None, None


def pick(mesh, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
    """The value of ``t`` held by the rank at coordinate ``src`` along
    ``axis`` (the others' values are ignored): a broadcast, written as an
    all-gather so that it needs no global rank numbers."""
    if mesh.shape[axis] == 1:
        return t
    n = mesh.shape[axis]
    parts = all_gather(mesh, t.unsqueeze(0), 0, axis, grad="cut")
    assert parts.shape[0] == n, parts.shape
    return parts[src]


def gather_object(obj: Any) -> List[Any]:
    """``obj`` from every rank of the world, in rank order."""
    import torch.distributed as dist
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out

