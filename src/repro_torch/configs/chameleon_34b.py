"""chameleon-34b — early-fusion VLM backbone (arXiv:2405.09818).

[vlm] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, qk_norm.
The VQ image frontend is a stub: image tokens share the text vocabulary.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="dense", n_layers=48, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True, frontend="vq_image",
    source="arXiv:2405.09818 (early-fusion, VQ image tokens share the text vocab)",
)
