"""Uniform model API: ``build(cfg)`` returns the family module.  A ported
family exposes

    schema(cfg) -> {name: Spec}
    init(cfg, seed, device) -> params
    prefill(cfg, params, tokens, *, max_len) -> (logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)
    init_cache(cfg, batch, max_len) -> cache dict

for continuous batching, ``prefill_chunk`` (and per-slot ``decode_step``
positions), for the paged KV cache ``init_kv_pool`` and the block-table
twins ``paged_prefill_chunk`` / ``paged_decode_step``, and for
compressed-resident serving, the per-layer weight-slot twins
``embed_step`` / ``head_step`` / ``resident_prefill_block`` /
``resident_block``.  Every family is ported; as in the JAX package, only
dense and moe meet those three contracts, and the ssm, hybrid and encdec
families (recurrent states, cross-attention) serve lockstep.
"""
from __future__ import annotations

import types
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig


def build(cfg: ArchConfig) -> types.ModuleType:
    from . import dense, encdec, hybrid, mamba2, moe
    try:
        return {
            "dense": dense,
            "moe": moe,
            "ssm": mamba2,
            "hybrid": hybrid,
            "encdec": encdec,
        }[cfg.family]
    except KeyError:
        raise KeyError(f"unknown model family {cfg.family!r}") from None


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    return {n: s.shape for n, s in build(cfg).schema(cfg).items()}


def param_specs(cfg: ArchConfig) -> Dict[str, Tuple]:
    return {n: s.axes for n, s in build(cfg).schema(cfg).items()}


def cache_specs(cfg: ArchConfig, **kw) -> Dict[str, Tuple]:
    """The family's ``cache_specs`` with its options filtered: callers pass
    the full option set (``layout="slot"``, ``kv_bits=8``, ...) and a family
    that does not take an option does not see it."""
    import inspect
    fn = build(cfg).cache_specs
    accepted = inspect.signature(fn).parameters
    return fn(cfg, **{k: v for k, v in kw.items() if k in accepted})


def supports_continuous_batching(cfg: ArchConfig) -> bool:
    """True when the family implements the slot-batch cache contract
    (``prefill_chunk`` + per-slot ``decode_step`` positions); dense and
    moe."""
    return hasattr(build(cfg), "prefill_chunk")


def supports_paged_kv(cfg: ArchConfig) -> bool:
    """True when the family implements the paged block-pool cache contract
    (``init_kv_pool`` + ``paged_decode_step`` / ``paged_prefill_chunk``
    through a block table); dense and moe."""
    return hasattr(build(cfg), "paged_decode_step")


def supports_resident_serving(cfg: ArchConfig) -> bool:
    """True when the family implements the per-layer weight-slot contract
    of compressed-resident serving (``embed_step`` / ``head_step`` /
    ``resident_prefill_block`` / ``resident_block``); dense and moe."""
    return hasattr(build(cfg), "resident_block")


def supports_fused_resident(cfg: ArchConfig) -> bool:
    """True when the family's per-layer step loops can take fused payload
    handles (:class:`repro_torch.kernels.fused_decode_matmul.FusedQT`) in
    their weight-slot dicts: any family meeting the resident contract,
    since every weight goes through ``layers.matmul``."""
    return supports_resident_serving(cfg)
