"""Uniform model API: ``build(cfg)`` returns the family module.  A ported
family exposes

    schema(cfg) -> {name: Spec}
    init(cfg, seed, device) -> params
    prefill(cfg, params, tokens, *, max_len) -> (logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)
    init_cache(cfg, batch, max_len) -> cache dict

for continuous batching, ``prefill_chunk`` (and per-slot ``decode_step``
positions), and for compressed-resident serving, the per-layer weight-slot
twins ``embed_step`` / ``head_step`` / ``resident_prefill_block`` /
``resident_block``.  Only the dense family is ported so far; the others
raise.
"""
from __future__ import annotations

import types
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig

_NOT_PORTED = ("moe", "ssm", "hybrid", "encdec")


def build(cfg: ArchConfig) -> types.ModuleType:
    if cfg.family == "dense":
        from . import dense
        return dense
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet")
    raise KeyError(f"unknown model family {cfg.family!r}")


def param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    return {n: s.shape for n, s in build(cfg).schema(cfg).items()}


def param_specs(cfg: ArchConfig) -> Dict[str, Tuple]:
    return {n: s.axes for n, s in build(cfg).schema(cfg).items()}


def supports_continuous_batching(cfg: ArchConfig) -> bool:
    """True when the family implements the slot-batch cache contract
    (``prefill_chunk`` + per-slot ``decode_step`` positions); dense
    today."""
    try:
        return hasattr(build(cfg), "prefill_chunk")
    except NotImplementedError:
        return False


def supports_resident_serving(cfg: ArchConfig) -> bool:
    """True when the family implements the per-layer weight-slot contract
    of compressed-resident serving (``embed_step`` / ``head_step`` /
    ``resident_prefill_block`` / ``resident_block``); dense today."""
    try:
        return hasattr(build(cfg), "resident_block")
    except NotImplementedError:
        return False


def supports_fused_resident(cfg: ArchConfig) -> bool:
    """True when the family's per-layer step loops can take fused payload
    handles (:class:`repro_torch.kernels.fused_decode_matmul.FusedQT`) in
    their weight-slot dicts: any family meeting the resident contract,
    since every weight goes through ``layers.matmul``."""
    return supports_resident_serving(cfg)
