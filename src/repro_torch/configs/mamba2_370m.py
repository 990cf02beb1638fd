"""mamba2-370m — attention-free SSD decoder (arXiv:2405.21060).

[ssm] 48L d_model=1024 vocab=50280, ssm_state=128; sub-quadratic (long_500k runs).
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    subquadratic=True, source="arXiv:2405.21060 (SSD state-space duality)",
)
