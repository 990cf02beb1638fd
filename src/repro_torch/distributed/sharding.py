"""Logical-axis sharding rules -> partition specs (PyTorch port of
``repro/distributed/sharding.py``).

Models annotate every parameter / cache / batch dimension with a *logical*
axis name ("embed", "heads", "expert", "batch", ...).  This module maps
logical axes onto mesh axes per a :class:`Rules` profile, with two safety
valves, as in the JAX package:

* **divisibility** — a logical axis only binds to a mesh-axis tuple whose
  size divides the dimension; otherwise the tuple is shortened (prefix)
  until it divides, possibly to unsharded;
* **no-duplicate mesh axes** — a mesh axis may appear once per spec; later
  logical axes skip mesh axes already claimed by earlier dims.

The module is pure: it runs no collective and places nothing.  A mesh is
any object with a ``.shape`` mapping of axis name to size (the port's
:class:`repro_torch.launch.mesh.Mesh`, or a stand-in in tests), and a
resolved spec is a :class:`P`: a tuple with one entry a dimension (``None``,
an axis name, or a tuple of axis names), trailing ``None`` entries trimmed.
The placement of a tensor by its spec (each rank keeping its block) is
:func:`repro_torch.distributed.ctx.local_block`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

AxesSpec = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry a dimension, trailing ``None`` entries
    trimmed by :func:`resolve_spec` (the canonical form of
    ``jax.sharding.PartitionSpec`` the JAX package compares)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def padded(self, ndim: int) -> Tuple:
        """The spec's entries padded with ``None`` to ``ndim``."""
        return tuple(self) + (None,) * (ndim - len(self))

    def trimmed(self) -> "P":
        """The spec with its trailing ``None`` entries dropped."""
        e = list(self)
        while e and e[-1] is None:
            e.pop()
        return P(*e)


def _as_tuple(a: AxesSpec) -> Tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, str):
        return (a,)
    return tuple(a)


def entry_axes(e: AxesSpec) -> Tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    return _as_tuple(e)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Mapping logical axis name -> preferred mesh axes (in priority order)."""

    table: Dict[str, AxesSpec]

    def lookup(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return _as_tuple(self.table.get(logical))


def mesh_prod(mesh, axes: Sequence[str]) -> int:
    return math.prod(int(mesh.shape[a]) for a in axes)


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Rules, mesh) -> P:
    """Build the spec for one tensor, honoring divisibility + uniqueness.

    Tuple candidates keep prefix semantics: shortening drops mesh axes from
    the RIGHT until the surviving product divides the dim.  The dedup filter
    against ``used`` is re-applied after every shortening step: a surviving
    prefix never resurrects an axis an earlier dim already claimed.
    """
    assert len(axes) == len(shape), (axes, shape)
    used: set = set()
    entries = []
    for logical, dim in zip(axes, shape):
        # dedup WITHIN the candidate tuple (first occurrence wins) and drop
        # axes this mesh does not have
        cand, seen = [], set()
        for a in rules.lookup(logical):
            if a in seen or a not in mesh.shape:
                continue
            seen.add(a)
            cand.append(a)
        while True:
            cand = [a for a in cand if a not in used]
            if not cand or dim % mesh_prod(mesh, cand) == 0:
                break
            cand.pop()
        if cand:
            used.update(cand)
            entries.append(tuple(cand) if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    flat = [a for e in entries for a in _as_tuple(e)]
    assert len(flat) == len(set(flat)), \
        f"duplicate mesh axes in resolved spec {entries} for {axes}/{shape}"
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def tree_shardings(schema_axes: Dict[str, Sequence[Optional[str]]],
                   schema_shapes: Dict[str, Sequence[int]],
                   rules: Rules, mesh) -> Dict[str, P]:
    return {name: resolve_spec(schema_axes[name], schema_shapes[name],
                               rules, mesh)
            for name in schema_axes}


# -------------------------------------------------------- quantized (QT) leaves

def follower_spec(qspec: P, q_shape: Sequence[int],
                  follower_shape: Sequence[int], mesh) -> P:
    """Spec of a QT ``scale`` / ``zero`` that FOLLOWS the resolved ``q``
    spec: a follower dim inherits q's mesh axes on that dim iff the sizes
    line up (size-1 broadcast dims replicate; a per-group dim whose group
    count the axis product does not divide replicates).  Each rank then
    holds the (s, z) rows of precisely its own output-channel slice."""
    entries = list(qspec) + [None] * (len(q_shape) - len(qspec))
    out = []
    for dim, _qdim, e in zip(follower_shape, q_shape, entries):
        if e is None or dim == 1:
            out.append(None)
            continue
        out.append(e if dim % mesh_prod(mesh, _as_tuple(e)) == 0 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def leaf_shardings(axes: Sequence[Optional[str]], value: Any, rules: Rules,
                   mesh):
    """Spec (or a QT / QT4 / QTG of specs) for one parameter leaf.

    Plain tensors resolve through :func:`resolve_spec`.  Quantized triples
    resolve the ``q`` symbols against the schema axes (QT4's nibble-packed
    last dim checked at its packed size) and derive ``scale`` / ``zero``
    with :func:`follower_spec`, so the triple lands consistently sharded
    along the output-channel axis; a QTG's master resolves on its own
    shape."""
    from repro_torch.models.layers import QT, QT4, QTG
    if isinstance(value, (QT, QT4, QTG)):
        q_shape = tuple(value.q.shape)
        qspec = resolve_spec(axes, q_shape, rules, mesh)
        sspec = follower_spec(qspec, q_shape, tuple(value.scale.shape), mesh)
        zspec = follower_spec(qspec, q_shape, tuple(value.zero.shape), mesh)
        if isinstance(value, QTG):
            return QTG(qspec, sspec, zspec,
                       resolve_spec(axes, tuple(value.master.shape), rules,
                                    mesh))
        return type(value)(qspec, sspec, zspec)
    return resolve_spec(axes, tuple(value.shape), rules, mesh)


# ------------------------------------------------------------------- profiles

def _axes(mesh, *names: str) -> Tuple[str, ...]:
    return tuple(n for n in names if n in mesh.shape)


def train_rules(mesh) -> Rules:
    """FSDP(data) x TP(model) x EP(model); batch over (pod, data)."""
    return Rules({
        "vocab": "model",
        "embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "expert": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "layers": None,
        "batch": _axes(mesh, "pod", "data"),
        "seq": None,
    })


def opt_state_rules(mesh) -> Rules:
    """ZeRO: optimizer moments shard over pod x data on top of the TP axes."""
    r = dict(train_rules(mesh).table)
    r["embed"] = _axes(mesh, "pod", "data")
    r["expert_embed"] = _axes(mesh, "pod", "data")
    return Rules(r)


def serve_rules(mesh, *, long_context: bool = False) -> Rules:
    """Weights like training; KV cache batch-sharded (``slot`` rows of the
    continuous-batching pool resolve like lockstep batch rows), or
    sequence-sharded for the single-request long-context cell."""
    return Rules({
        "vocab": "model",
        "embed": "data",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "expert": "model",
        "expert_embed": "data",
        "expert_mlp": None,
        "layers": None,
        "batch": () if long_context else _axes(mesh, "pod", "data"),
        "slot": () if long_context else _axes(mesh, "pod", "data"),
        "kv_seq": _axes(mesh, "pod", "data") if long_context else (),
        "seq": None,
    })


def serve_tp_table(cfg, mesh, axes: Sequence[Optional[str]]) -> Rules:
    """Exact serving TP: the rule table for ONE weight tensor that shards
    only its output-channel axis (the last dim) over model.

    Contraction dims stay whole everywhere, and the weight is all-gathered
    at its use site (:func:`repro_torch.models.layers.gather_weight`), so
    the sharded compute never sums a floating-point reduction across ranks:
    greedy decode is bit-identical to one device.  The embedding table /
    lm_head shard over ``vocab``; ``heads`` / ``kv`` output columns shard
    only when whole heads divide the model axis; everything else (norms,
    1-D params, contraction-dim axes) replicates.
    """
    table: Dict[str, AxesSpec] = {a: None for a in axes if a}
    if "vocab" in axes:
        table["vocab"] = "model"
        return Rules(table)
    out = axes[-1] if len(axes) >= 2 else None
    if out is not None:
        m = mesh.shape.get("model", 1)
        ok = {"heads": bool(cfg.n_heads) and cfg.n_heads % m == 0,
              "kv": kv_divisible(cfg, mesh)}.get(out, True)
        if ok:
            table[out] = "model"
    return Rules(table)


def kv_divisible(cfg, mesh) -> bool:
    m = mesh.shape.get("model", 1)
    return bool(cfg.n_kv_heads) and cfg.n_kv_heads % m == 0


def kv_serve_rules(cfg, mesh, *, long_context: bool = False
                   ) -> Tuple[Rules, Tuple[str, ...]]:
    """The reference's arch-aware serving rules (``launch/specs.py``'s
    ``_serve_rules``): the KV-cache heads over model when whole heads
    divide it, otherwise the cache's sequence over model (the
    flash-decoding layout); for the single-request long-context cell the
    sequence over the data axes.  Returns (rules, the cache's T axes)."""
    table = dict(serve_rules(mesh, long_context=long_context).table)
    if long_context:
        kv_seq = _axes(mesh, "pod", "data")
        table["kv"] = "model" if kv_divisible(cfg, mesh) else None
        table["kv_seq"] = kv_seq
        return Rules(table), kv_seq
    if kv_divisible(cfg, mesh):
        table["kv"] = "model"
        table["kv_seq"] = ()
        return Rules(table), ()
    table["kv"] = None
    table["kv_seq"] = "model"
    return Rules(table), ("model",)


def arch_rules(cfg, mesh, base: Rules) -> Rules:
    """KV weight columns shard over model only when whole KV heads divide
    the axis; otherwise wk / wv stay replicated over model."""
    table = dict(base.table)
    table["kv"] = "model" if kv_divisible(cfg, mesh) else None
    return Rules(table)


# ------------------------------------------------------------- tensor helpers

def param_shardings(cfg, mesh, rules: Rules) -> Dict[str, P]:
    from repro_torch.models import api
    sch = api.build(cfg).schema(cfg)
    return tree_shardings({n: s.axes for n, s in sch.items()},
                          {n: s.shape for n, s in sch.items()}, rules, mesh)


def cache_shapes(cfg, batch: int, max_len: int,
                 **cache_kw) -> Dict[str, Tuple[int, ...]]:
    """Leaf shapes of the family's cache, from its own ``init_cache`` on the
    ``meta`` device (nothing allocated); ``cache_kw`` the family does not
    take is dropped."""
    import inspect
    from repro_torch.models import api
    mod = api.build(cfg)
    accepted = inspect.signature(mod.init_cache).parameters
    init_kw = {k: v for k, v in cache_kw.items() if k in accepted}
    cache = mod.init_cache(cfg, batch, max_len, device="meta", **init_kw)
    return {k: tuple(v.shape) for k, v in cache.items()}


def cache_shardings(cfg, mesh, rules: Rules, batch: int, max_len: int,
                    **cache_kw) -> Dict[str, P]:
    """Specs for the KV-cache leaves.  ``cache_kw`` forwards family cache
    options (``layout="slot"`` for the continuous-batching pool,
    ``kv_bits=8`` for the int8 cache) through :func:`api.cache_specs`,
    which drops options a family does not take."""
    from repro_torch.models import api
    specs = api.cache_specs(cfg, **cache_kw)
    shapes = cache_shapes(cfg, batch, max_len, **cache_kw)
    return tree_shardings(specs, {k: shapes[k] for k in specs}, rules, mesh)


def batch_sharding(mesh, rules: Rules, shape: Sequence[int]) -> P:
    """Shard dim 0 (batch) of a (B, ...) input, honoring divisibility of B."""
    axes = ["batch"] + [None] * (len(shape) - 1)
    return resolve_spec(axes, shape, rules, mesh)
