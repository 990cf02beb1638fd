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
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

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
    dicts ``{"kind", "bytes", "group", "intra_node"}`` (``kind``
    ``"all-gather"``, ``"all-reduce"`` or ``"reduce-scatter"``, ``bytes``
    the output's; a reduce-scatter's also ``"in_bytes"``, its input's)."""
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
                             "intra_node": len(nodes) == 1}, **extra))


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_gather(mesh, t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Every rank's block of ``t`` along ``dim``, concatenated in the order
    of the mesh coordinate over ``axes`` (the first axis major, as a spec
    entry names them).  Exact: the result is the full tensor bit for bit."""
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


def all_reduce_sum(mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (one axis after the
    other), returned as a new tensor.  A float sum: its rounding depends on
    the backend's order, so callers hold it to a tolerance."""
    return all_reduce(mesh, t, axes, "sum")


def all_reduce(mesh, t: torch.Tensor, axes, op: str) -> torch.Tensor:
    """``t`` reduced by ``op`` (``"sum"``, ``"min"`` or ``"max"``) over the
    ranks along ``axes``, returned as a new tensor (``t`` itself when every
    axis has one rank).  ``min`` and ``max`` are exact."""
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
    :func:`all_reduce_sum`'s."""
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


def pick(mesh, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
    """The value of ``t`` held by the rank at coordinate ``src`` along
    ``axis`` (the others' values are ignored): a broadcast, written as an
    all-gather so that it needs no global rank numbers."""
    if mesh.shape[axis] == 1:
        return t
    n = mesh.shape[axis]
    parts = all_gather(mesh, t.unsqueeze(0), 0, axis)
    assert parts.shape[0] == n, parts.shape
    return parts[src]


def gather_object(obj: Any) -> List[Any]:
    """``obj`` from every rank of the world, in rank order."""
    import torch.distributed as dist
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out

