"""dbrx-132b — fine-grained MoE decoder (hf:databricks/dbrx-base).

[moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, 16 experts top-4.
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab=100352,
    moe=MoEConfig(num_experts=16, top_k=4),
    source="hf:databricks/dbrx-base (16 experts top-4, fine-grained)",
)
