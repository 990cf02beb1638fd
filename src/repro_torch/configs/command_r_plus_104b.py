"""command-r-plus-104b — dense GQA decoder, no-bias (hf:CohereForAI).

[dense] 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000,
    source="hf:CohereForAI/c4ai-command-r-plus (GQA, no-bias)",
)
