"""seamless-m4t-medium — enc-dec multimodal backbone (arXiv:2308.11596).

[audio] 12L(+12 enc) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
Speech frontend is a stub: batches carry precomputed frame embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, enc_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    frontend="audio",
    source="arXiv:2308.11596 (enc-dec backbone; speech frontend stubbed)",
)
