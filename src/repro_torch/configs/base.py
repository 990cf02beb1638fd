"""Architecture + input-shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; input shapes are
:class:`ShapeConfig` entries.  ``registry.get(name)`` resolves ``--arch`` flags;
``reduced(cfg)`` derives the CPU-smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    shared_experts: int = 0         # always-active experts (qwen2-moe)
    every_n: int = 1                # MoE layer every n-th block (jamba: 2)
    capacity_factor: float = 1.25   # GShard dispatch capacity

    def padded_experts(self, multiple: int) -> int:
        return _round_up(self.num_experts, multiple)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256                # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0            # hybrid: 1 attention layer per this many layers
    enc_layers: int = 0             # encdec: encoder depth (n_layers = decoder depth)
    frontend: Optional[str] = None  # 'vq_image' | 'audio' stub note
    subquadratic: bool = False      # eligible for long_500k decode
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def padded_vocab(self, multiple: int = 512) -> int:
        return _round_up(self.vocab, multiple)

    # -- parameter counting (for 6ND roofline + Table-I-style storage reports) ------
    def param_count(self) -> int:
        return sum(int_prod(s) for s in self.param_shapes().values())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of the routed experts)."""
        from repro_torch.models import api
        specs = api.param_specs(self)
        total = 0
        for name, shape in self.param_shapes().items():
            n = int_prod(shape)
            # expert FFN weights carry both axes; the router ("expert" only)
            # runs for every token and stays fully counted
            if self.moe and "expert" in specs[name] \
                    and "expert_mlp" in specs[name]:
                n = n * self.moe.top_k // max(self.moe.num_experts, 1)
            total += n
        return total

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Logical parameter shapes (mirrors models.* init exactly; asserted by tests)."""
        from repro_torch.models import api  # local import to avoid cycles
        return api.param_shapes(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    def applicable(self, cfg: ArchConfig) -> bool:
        if self.name == "long_500k":
            return cfg.subquadratic
        return True


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def int_prod(shape: Tuple[int, ...]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out
