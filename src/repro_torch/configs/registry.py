"""Registry over the 10 assigned architectures (one module per arch, exact
configs from the assignment) + reduced smoke-test variants of the same family.

``get("--arch id")`` resolves CLI flags; ``reduced(cfg)`` derives the CPU smoke
variant (same structure, small shapes).
"""
from __future__ import annotations

from typing import Dict

from . import (chameleon_34b, command_r_plus_104b, dbrx_132b, glm4_9b,
               jamba_1_5_large_398b, mamba2_370m, qwen2_moe_a2_7b, qwen3_1_7b,
               seamless_m4t_medium, stablelm_12b)
from .base import ArchConfig, MoEConfig, SSMConfig

_MODULES = [
    chameleon_34b, seamless_m4t_medium, stablelm_12b, command_r_plus_104b,
    glm4_9b, qwen3_1_7b, jamba_1_5_large_398b, dbrx_132b, qwen2_moe_a2_7b,
    mamba2_370m,
]

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family variant for CPU smoke tests (shapes only, structure intact)."""
    kw = dict(
        name=cfg.name + "-reduced", family=cfg.family,
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 8),
        d_model=128, n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256 if cfg.d_ff else 0, vocab=512,
        head_dim=32 if cfg.n_heads else None,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings, attn_period=min(cfg.attn_period, 4),
        enc_layers=min(cfg.enc_layers, 2), frontend=cfg.frontend,
        subquadratic=cfg.subquadratic, source="reduced smoke variant",
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(
            num_experts=4, top_k=2, shared_experts=min(cfg.moe.shared_experts, 1),
            every_n=cfg.moe.every_n, capacity_factor=cfg.moe.capacity_factor)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32)
    return ArchConfig(**kw)
