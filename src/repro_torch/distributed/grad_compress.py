"""Gradient compression for a bandwidth-bound all-reduce (PyTorch port of
``repro/distributed/grad_compress.py``; local math only).

The uint8 mixed symmetric / asymmetric grid the paper applies to weights,
applied to the gradient's wire format in blocks of 256 elements, with
**error feedback**: the local quantization residual is added back into the
next step's gradient, so the compression error does not accumulate as a
bias (EF-SGD).  Gradients are flat ``{name: tensor}`` dicts.

On a mesh (:func:`compress_decompress_blocks`) each rank holds its block
of every summed gradient and gets its block of the single-device
:func:`compress_decompress` of the whole tensor, bit for bit, with no
gather: the 256-element blocks are the whole tensor's row-major flatten,
a rank's elements of each block are found from its spec, and a block
whose elements more than one rank holds (or that the zero padding of
the last block reaches) takes its ``lo`` / ``hi`` from an exact min /
max all-reduce over the axes that split the tensor.  Which blocks
straddle follows from the shapes alone, so every rank issues the same
collectives.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

f32 = torch.float32
_BLOCK = 256

Grads = Dict[str, torch.Tensor]


def _q8_blockwise(g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block symmetric / asymmetric uint8 quantization of one gradient
    (flattened, zero-padded to whole blocks)."""
    flat = g.reshape(-1).to(f32)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    xb = flat.reshape(-1, _BLOCK)
    lo = torch.amin(xb, dim=1, keepdim=True)
    hi = torch.amax(xb, dim=1, keepdim=True)
    q, scale, zero = _q8_from_range(xb, lo, hi)
    return q, scale, zero


def _q8_from_range(xb: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The uint8 symbols, scale and zero of ``xb`` on the grid of its
    blocks' ranges ``[lo, hi]`` (broadcast against it)."""
    single = lo * hi >= 0.0
    absmax = torch.where(torch.abs(hi) >= torch.abs(lo), hi, lo)
    scale = torch.where(single,
                        torch.where(absmax == 0.0, 1.0, absmax / 255.0),
                        torch.where(hi == lo, 1.0, (hi - lo) / 255.0))
    zero = torch.where(single, 0.0, lo)
    q = torch.clamp(torch.round((xb - zero) / scale), 0.0, 255.0
                    ).to(torch.uint8)
    return q, scale, zero


def _dq8_blockwise(q: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   shape) -> torch.Tensor:
    x = q.to(f32) * scale + zero
    n = 1
    for d in shape:
        n *= int(d)
    return x.reshape(-1)[:n].reshape(shape)


@torch.no_grad()
def compress_decompress(grads: Grads) -> Grads:
    """Quantize and dequantize every gradient (the wire format simulated);
    leaves under one block ride along uncompressed."""
    def qdq(g):
        if g.numel() < _BLOCK:
            return g
        q, s, z = _q8_blockwise(g)
        return _dq8_blockwise(q, s, z, g.shape).to(g.dtype)
    return {n: qdq(g) for n, g in grads.items()}


def _layout(shape: Sequence[int], spec: Sequence, mesh_shape, coord
            ) -> Tuple[int, int, np.ndarray]:
    """The elements a rank (``coord``: ``{axis: coordinate}``) holds of a
    tensor of ``shape`` cut by ``spec`` as segments of the row-major
    flatten: (segments R, segment length, the (R,) starts in the
    flatten).  With ``k`` the last split dim, each fixed index of the dims
    before it and the rank's range along it, with every index after it,
    is one contiguous segment.  ``mesh_shape`` maps each axis to its
    size."""
    shape = [int(d) for d in shape]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    k = max(d for d, e in enumerate(entries) if e is not None)
    inner = int(np.prod(shape[k + 1:], dtype=np.int64))
    strides = [int(np.prod(shape[d + 1:], dtype=np.int64))
               for d in range(len(shape))]
    starts = np.zeros(1, np.int64)
    for d in range(k + 1):
        e = entries[d]
        size, idx = 1, 0
        for a in (() if e is None else (e,) if isinstance(e, str)
                  else tuple(e)):
            size *= mesh_shape[a]
            idx = idx * mesh_shape[a] + coord[a]
        n = shape[d] // size
        if d < k:
            rng = (idx * n + np.arange(n, dtype=np.int64)) * strides[d]
            starts = (starts[:, None] + rng[None, :]).reshape(-1)
        else:
            starts = starts + idx * n * strides[d]
            length = n * inner
    return starts.size, length, starts


@functools.lru_cache(maxsize=None)
def _straddling(shape: Tuple[int, ...], spec: tuple,
                mesh_shape: Tuple[Tuple[str, int], ...]) -> np.ndarray:
    """The sorted ids of the 256-element blocks of the whole tensor whose
    elements more than one segment holds (of any rank: a segment start
    that is not a block boundary), and the last block when the zero
    padding reaches it: the same on every rank, from the shapes alone
    (``mesh_shape`` the mesh's ``(axis, size)`` pairs).  Read-only."""
    import itertools
    from .sharding import entry_axes
    sizes = dict(mesh_shape)
    axes = sorted({a for e in spec if e is not None
                   for a in entry_axes(e)})
    ids = [np.zeros(0, np.int64)]
    for c in itertools.product(*(range(sizes[a]) for a in axes)):
        _, _, starts = _layout(shape, spec, sizes, dict(zip(axes, c)))
        ids.append(starts[starts % _BLOCK != 0] // _BLOCK)
    n = int(np.prod(shape, dtype=np.int64))
    if n % _BLOCK:
        ids.append(np.array([n // _BLOCK], np.int64))
    return np.unique(np.concatenate(ids))


@torch.no_grad()
def compress_decompress_block(g: torch.Tensor, shape: Sequence[int],
                              spec: Sequence, mesh) -> torch.Tensor:
    """This rank's block of :func:`compress_decompress` of the whole
    ``shape`` tensor whose block, cut by ``spec``, is ``g`` (see the module
    docstring).  Bitwise the single-device result's block."""
    from .ctx import block_index
    n = int(np.prod(shape, dtype=np.int64))
    spec = tuple(e if block_index(mesh, e)[0] > 1 else None for e in spec)
    if not any(e is not None for e in spec):
        return compress_decompress({"g": g})["g"]
    if n < _BLOCK:
        return g
    R, L, starts = _layout(shape, spec, mesh.shape, mesh.coord)
    dev = g.device
    st = torch.as_tensor(starts, device=dev)
    off = st % _BLOCK                                    # (R,)
    P = -(-(_BLOCK - 1 + L) // _BLOCK) * _BLOCK
    nb = P // _BLOCK
    pos = off[:, None] + torch.arange(L, device=dev)     # (R, L)
    x = g.reshape(R, L).to(f32)
    lo = torch.full((R, P), float("inf"), device=dev).scatter_(1, pos, x)
    hi = torch.full((R, P), float("-inf"), device=dev).scatter_(1, pos, x)
    lo = lo.view(R, nb, _BLOCK).amin(-1)
    hi = hi.view(R, nb, _BLOCK).amax(-1)
    bid = (st // _BLOCK)[:, None] + torch.arange(nb, device=dev)
    shared = torch.as_tensor(_straddling(
        tuple(shape), spec, tuple(mesh.shape.items())), device=dev)
    if shared.numel():
        from . import collectives
        from .sharding import entry_axes
        axes = tuple(dict.fromkeys(a for e in spec if e is not None
                                   for a in entry_axes(e)))
        where = torch.searchsorted(shared, bid.reshape(-1)).clamp(
            max=shared.numel() - 1)
        hit = shared[where] == bid.reshape(-1)
        slo = torch.full((shared.numel(),), float("inf"), device=dev)
        shi = torch.full((shared.numel(),), float("-inf"), device=dev)
        slo.scatter_reduce_(0, where[hit], lo.reshape(-1)[hit], "amin")
        shi.scatter_reduce_(0, where[hit], hi.reshape(-1)[hit], "amax")
        if n % _BLOCK:                # the single device's zero padding
            last = shared == n // _BLOCK
            slo = torch.where(last, slo.clamp(max=0.0), slo)
            shi = torch.where(last, shi.clamp(min=0.0), shi)
        slo = collectives.all_reduce(mesh, slo, axes, "min")
        shi = collectives.all_reduce(mesh, shi, axes, "max")
        lo = torch.where(hit, slo[where], lo.reshape(-1)).view(R, nb)
        hi = torch.where(hit, shi[where], hi.reshape(-1)).view(R, nb)
    xp = torch.zeros((R, P), dtype=f32, device=dev).scatter_(1, pos, x)
    q, scale, zero = _q8_from_range(xp.view(R, nb, _BLOCK), lo[..., None],
                                    hi[..., None])
    dq = (q.to(f32) * scale + zero).view(R, P)
    return torch.gather(dq, 1, pos).reshape(g.shape).to(g.dtype)


@torch.no_grad()
def compress_decompress_blocks(grads: Grads, shapes: Dict[str, Any],
                               specs: Dict[str, Any], mesh) -> Grads:
    """:func:`compress_decompress_block` of each leaf of a tree of blocks
    (``shapes`` the whole tensors', ``specs`` each block's cut, ``None``
    for a leaf every rank holds whole), in the tree's order."""
    return {n: compress_decompress_block(g, shapes[n], specs[n] or (),
                                         mesh)
            for n, g in grads.items()}


@torch.no_grad()
def ef_compress(grads: Grads, residual: Optional[Grads]
                ) -> Tuple[Grads, Grads]:
    """Error-feedback compression: returns (compressed grads, new residual),
    ``new_residual = (g + residual) - Q(g + residual)``."""
    if residual is None:
        residual = {n: torch.zeros(g.shape, dtype=f32, device=g.device)
                    for n, g in grads.items()}
    comp, new_res = {}, {}
    for n, g in grads.items():
        r = residual[n]
        if g.numel() < _BLOCK:
            comp[n], new_res[n] = g, torch.zeros_like(r)
            continue
        corrected = g.to(f32) + r
        q, s, z = _q8_blockwise(corrected)
        dq = _dq8_blockwise(q, s, z, g.shape)
        comp[n], new_res[n] = dq.to(g.dtype), corrected - dq
    return comp, new_res


def wire_bytes(grads: Grads, *, compressed: bool) -> int:
    """Bytes a gradient all-reduce moves a hop: 4 a float32 element, or
    with compression 1 an element plus a scale and zero (8 bytes) a block
    for every leaf of at least one block."""
    total = 0
    for g in grads.values():
        n = int(g.numel())
        if compressed and n >= _BLOCK:
            total += n + -(-n // _BLOCK) * 8
        else:
            total += n * 4
    return total
