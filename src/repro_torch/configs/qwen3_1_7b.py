"""qwen3-1.7b — dense decoder with qk-norm (hf:Qwen/Qwen3-1.7B).

[dense] 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=6144, vocab=151936, qk_norm=True, head_dim=128,
    source="hf:Qwen/Qwen3-1.7B (qk_norm, GQA)",
)
