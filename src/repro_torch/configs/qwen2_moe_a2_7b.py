"""qwen2-moe-a2.7b — shared+routed MoE (hf:Qwen/Qwen1.5-MoE-A2.7B).

[moe] 24L d_model=2048 16H (kv=16) d_ff=1408 vocab=151936, 60 routed top-4 + 4 shared.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936,
    moe=MoEConfig(num_experts=60, top_k=4, shared_experts=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B (4 shared + 60 routed top-4)",
)
