"""twin-consistency: prove the hand-maintained serving twins op for op
(counterpart of ``repro/analysis/twins.py``).

The per-layer ``resident_*`` and paged ``paged_*`` twins in
``models/dense.py`` / ``models/moe.py`` are a bitwise hazard: each must
compute what its whole-tree step computes, and otherwise only end-to-end
greedy-identity tests notice drift.  The port has no scan to read a layer
body from, so this checker compares whole steps: it records the aten ops
each side dispatches (a ``TorchDispatchMode`` on a microscopic config on the
CPU), the twin side composed the way ``serving.engine.ServeSteps`` composes
it (``embed_step`` -> the block once a layer -> the final norm / head), and
compares the two sequences after canonicalization.

Canonicalization (the documented differences between a twin and its
whole step):

* routing and bookkeeping ops are dropped (``ROUTING_OPS``): they move,
  reshape or select bytes and cannot change a value.  The paged twins
  route K/V through block tables (index / scatter) where the slot path
  writes cache rows in place (copies); the twins slice a layer's weights
  and cache rows with views where the steps slice stacked tensors.
* non-float and scalar (0-d) outputs are dropped — positions, masks and
  routing indices are integer ops, and the MoE forward carries a scalar
  aux accumulator its twins do not.
* an op's in-place and out-of-place forms are one op (``add_`` = ``add``).

Everything that remains — matmuls, norms, rope, softmax, the quantize
grids, casts (``_to_copy``) — must match in op, output shape and dtype, in
order.  A twin that adds, drops, or re-types one float op fails with the
first divergence.
"""
from __future__ import annotations

import dataclasses
import inspect
from pathlib import Path
from typing import Any, Callable, List, Sequence, Tuple

from .base import Finding, REPO_ROOT

# aten ops (overload packets, in-place "_" dropped) that move or select
# bytes without changing them, each dropped with its reason:
ROUTING_OPS = frozenset({
    # views and reshapes: a new index map over the same bytes
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "split", "split_with_sizes",
    "chunk", "unbind", "alias", "as_strided", "narrow", "flatten",
    "unflatten", "detach", "view_as", "expand_as", "movedim",
    # index and scatter: read or write rows a table names (the paged path)
    "index", "index_select", "gather", "take", "index_put", "scatter",
    "scatter_add", "index_copy", "index_add", "masked_select",
    # copies: the same values in new storage (cache writes, .contiguous())
    "copy", "clone", "contiguous", "lift_fresh", "lift_fresh_copy",
    "repeat", "repeat_interleave", "flip", "roll", "constant_pad_nd", "pad",
    # joins: bytes side by side
    "cat", "stack",
    # factories: no input values at all
    "zeros", "ones", "empty", "full", "arange", "zeros_like", "ones_like",
    "empty_like", "full_like", "new_zeros", "new_ones", "new_empty",
    "new_full", "scalar_tensor", "empty_strided", "fill", "zero", "tril",
    "triu",
    # comparisons and where: choose between values already computed
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "logical_and", "logical_or", "logical_not",
})

Op = Tuple[str, Tuple[Tuple[Tuple[int, ...], str], ...]]


def record_ops(fn: Callable[[], Any]) -> List[Op]:
    """Run ``fn`` once under a dispatch mode; its canonical float ops."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    ops: List[Op] = []

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name not in ROUTING_OPS:
                outs = tuple(
                    (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)
                    and t.dtype.is_floating_point and t.dim())
                if outs:
                    ops.append((name, outs))
            return out

    with torch.no_grad(), _Recorder():
        fn()
    return ops


def diff_ops(ref: Sequence[Op], twin: Sequence[Op]) -> str:
    """Empty string when identical, else a first-divergence description."""
    for i, (a, b) in enumerate(zip(ref, twin)):
        if a != b:
            return (f"op {i}: whole step has {a[0]}{list(a[1])} but twin "
                    f"has {b[0]}{list(b[1])}")
    if len(ref) != len(twin):
        longer, who = (ref, "whole step") if len(ref) > len(twin) \
            else (twin, "twin")
        extra = longer[min(len(ref), len(twin))]
        return (f"length {len(ref)} vs {len(twin)}: {who} additionally "
                f"computes {extra[0]}{list(extra[1])}")
    return ""


# ----------------------------------------------------------- pair builders

@dataclasses.dataclass(frozen=True)
class TwinPair:
    """One contract: ``twin`` must dispatch ``ref``'s float ops."""

    name: str
    ref_ops: Callable[[], List[Op]]
    twin_ops: Callable[[], List[Op]]
    twin_obj: Any                        # for file:line of the finding


B, S_CHUNK, MAX_LEN, BS = 2, 4, 8, 4     # MAX_LEN == MB * BS (MB = 2)


def _tiny_cfg(family: str):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    moe = MoEConfig(num_experts=4, top_k=2) if family == "moe" else None
    return ArchConfig(name=f"lint-{family}", family=family, n_layers=2,
                      d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                      vocab=64, head_dim=8, moe=moe,
                      source="twin-consistency lint config")


def _setup(family: str):
    """(module, cfg, params, make_inputs) on the CPU, params drawn from a
    seeded ``torch.Generator`` (``init``)."""
    import importlib

    import torch
    from repro_torch.models import dense
    mod = importlib.import_module(f"repro_torch.models.{family}")
    cfg = _tiny_cfg(family)
    cpu = torch.device("cpu")
    params = mod.init(cfg, 0, device=cpu)

    def inputs():
        gen = torch.Generator().manual_seed(0)
        return dict(
            tokens=torch.randint(0, cfg.vocab, (B, S_CHUNK), generator=gen),
            token1=torch.randint(0, cfg.vocab, (B, 1), generator=gen),
            cache=mod.init_cache(cfg, B, MAX_LEN, device=cpu),
            pool=mod.init_kv_pool(cfg, n_blocks=B * 2 + 1, block_size=BS,
                                  device=cpu),
            bt=torch.arange(1, B * 2 + 1, dtype=torch.int32).reshape(B, 2),
            posv=torch.zeros((B,), dtype=torch.int32))

    return mod, dense, cfg, params, inputs


def compose_step(mod, dense, cfg, params, tokens, cache, pos):
    """``ServeSteps``' per-layer step: embed, ``resident_block`` once a
    layer, head."""
    x = mod.embed_step(cfg, params, tokens)
    for l in range(cfg.n_layers):
        x, cache = mod.resident_block(cfg, dense._layer(params, l), x, cache,
                                      l, pos)
    return mod.head_step(cfg, params, x), cache


def compose_prefill(mod, dense, cfg, params, tokens):
    """``ServeSteps``' per-layer prefill up to the final norm (what
    ``forward(collect_cache=True)`` returns)."""
    import torch
    from repro_torch.models.layers import rms_norm
    x = mod.embed_step(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1])
    kvs = []
    for l in range(cfg.n_layers):
        x, kv = mod.resident_prefill_block(cfg, dense._layer(params, l), x,
                                           positions=positions)
        kvs.append(kv)
    return rms_norm(x, params["final_norm"]), kvs


def twin_pairs(family: str) -> List[TwinPair]:
    """The five contracts for one model family ('dense' | 'moe')."""
    mod, dense, cfg, params, inputs = _setup(family)

    def ops(fn):
        def run():
            i = inputs()
            return record_ops(lambda: fn(i))
        return run

    whole_decode = ops(lambda i: mod.decode_step(
        cfg, params, i["token1"], i["cache"], i["posv"]))
    whole_chunk = ops(lambda i: mod.prefill_chunk(
        cfg, params, i["tokens"], i["cache"], i["posv"]))
    return [
        TwinPair(
            f"{family}:forward-collect vs resident_prefill_block",
            ops(lambda i: mod.forward(cfg, params, i["tokens"],
                                      collect_cache=True)),
            ops(lambda i: compose_prefill(mod, dense, cfg, params,
                                          i["tokens"])),
            mod.resident_prefill_block),
        TwinPair(
            f"{family}:decode_step vs resident_block (S=1)",
            whole_decode,
            ops(lambda i: compose_step(mod, dense, cfg, params, i["token1"],
                                       i["cache"], i["posv"])),
            mod.resident_block),
        TwinPair(
            f"{family}:prefill_chunk vs resident_block (S={S_CHUNK})",
            whole_chunk,
            ops(lambda i: compose_step(mod, dense, cfg, params, i["tokens"],
                                       i["cache"], i["posv"])),
            mod.resident_block),
        TwinPair(
            f"{family}:decode_step vs paged_decode_step (kv16)",
            whole_decode,
            ops(lambda i: mod.paged_decode_step(
                cfg, params, i["token1"], i["pool"], i["bt"], i["posv"])),
            mod.paged_decode_step),
        TwinPair(
            f"{family}:prefill_chunk vs paged_prefill_chunk (kv16)",
            whole_chunk,
            ops(lambda i: mod.paged_prefill_chunk(
                cfg, params, i["tokens"], i["pool"], i["bt"], i["posv"])),
            mod.paged_prefill_chunk),
    ]


def compare_pair(pair: TwinPair) -> str:
    """Empty string when the contract holds, else the divergence message."""
    return diff_ops(pair.ref_ops(), pair.twin_ops())


def _location(obj) -> Tuple[str, int]:
    try:
        file = Path(inspect.getsourcefile(obj)).resolve()
        line = inspect.getsourcelines(obj)[1]
        return str(file.relative_to(REPO_ROOT)), line
    except (TypeError, OSError, ValueError):
        return "<unknown>", 0


def check(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for family in ("dense", "moe"):
        try:
            pairs = twin_pairs(family)
        except Exception as e:                    # noqa: BLE001 — surface,
            findings.append(Finding(               # never silently skip
                file=f"src/repro_torch/models/{family}.py", line=1,
                rule="twin-consistency",
                message=f"checker could not stage {family} pairs: {e!r}",
                symbol=family))
            continue
        for pair in pairs:
            try:
                msg = compare_pair(pair)
            except Exception as e:                # noqa: BLE001
                file, line = _location(pair.twin_obj)
                findings.append(Finding(
                    file=file, line=line, rule="twin-consistency",
                    message=f"[{pair.name}] run failed: {e!r}",
                    symbol=pair.name))
                continue
            if msg:
                file, line = _location(pair.twin_obj)
                findings.append(Finding(
                    file=file, line=line, rule="twin-consistency",
                    message=f"[{pair.name}] {msg}", symbol=pair.name))
    return findings
