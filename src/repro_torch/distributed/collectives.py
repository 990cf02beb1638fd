"""The collectives of the port's multi-device path, over the process groups
of a :class:`repro_torch.launch.mesh.Mesh`.

Each is pure data movement or a sum: :func:`all_gather` (concatenate
every rank's block along a dimension, over one or more mesh axes),
:func:`all_reduce_sum`, :func:`pick` (one rank's value to the others of an
axis) and :func:`gather_object` (a Python object from every rank of the
world).  The tensor ones skip the wire when their axes have one rank.

Every tensor stays on its device: ``gloo`` takes CUDA tensors for the
all-gather and the all-reduce (checked on torch 2.11 with ranks sharing
one H100), so the port stages nothing through the host itself (the
backend copies as it needs).  :data:`counts` counts the calls that reach
the wire, which the smoke's ``mesh`` lines report.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

counts: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


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
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.groups[a])
        t = torch.cat(parts, dim=dim)
    return t


def all_reduce_sum(mesh, t: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks along ``axes`` (one axis after the
    other), returned as a new tensor.  A float sum: its rounding depends on
    the backend's order, so callers hold it to a tolerance."""
    out = t
    for a in _axes(axes):
        if mesh.shape[a] == 1:
            continue
        counts["all_reduce"] += 1
        import torch.distributed as dist
        out = out.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.groups[a])
    return out


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

