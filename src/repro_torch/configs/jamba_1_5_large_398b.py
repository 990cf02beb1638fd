"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 + MoE (arXiv:2403.19887).

[hybrid] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536,
MoE 16e top-2 every 2nd layer; 1 attention layer per period of 8.
Sub-quadratic: runs the long_500k decode shape.
"""
from .base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536, attn_period=8,
    moe=MoEConfig(num_experts=16, top_k=2, every_n=2),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    subquadratic=True,
    source="arXiv:2403.19887 (Mamba+attn 1:7 interleave, MoE every 2nd layer)",
)
