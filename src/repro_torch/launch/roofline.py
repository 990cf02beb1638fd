"""Roofline terms of a dry-run cell on the H100 (PyTorch port of
``repro/launch/roofline.py``).

Three terms per (arch, shape, mesh), in seconds a step for one rank:

  compute    = FLOPs_per_rank / 989e12               (bf16 dense peak)
  memory     = HBM_bytes_per_rank / 3.35e12
  collective = wire bytes inside a node / 450e9  +  wire bytes across
               nodes / 50e9                          (NVLink, InfiniBand NDR)

The JAX package reads these off a compiled program.  The port has no
compiler to ask: ``launch/dryrun.py`` runs the port's own per-rank program
(rank 0 of the production mesh, every layer and every microbatch, on
``meta`` tensors) and counts what it does — FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, the operand and result bytes
of every op it ran (``raw_bytes_per_chip``), the bytes held (arguments and
peak), and every collective ``distributed/collectives.py`` issues, priced
with the reference's ring costs (:func:`wire_bytes`).  Because every layer
runs, nothing is extrapolated: the reference's ``analyze_extrapolated``
(three compiles and a linear fit over the unrolled layer count) has no
counterpart here.

The memory term is the reference's dtype-aware analytic estimate
(:func:`analytic_hbm_bytes`, the same formulas), which reads the same work
whatever implements it; :func:`model_flops` likewise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable

from repro_torch.configs.base import ArchConfig, ShapeConfig
from . import mesh as hw

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-rank wire bytes of one collective whose OUTPUT is ``nbytes``
    over a group of ``n`` ranks, by the reference's ring costs: all-gather
    and all-to-all (n-1)/n, all-reduce 2(n-1)/n, reduce-scatter (n-1)
    (its output is 1/n of its input), permute 1x."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (n - 1) / n
    if kind == "all-reduce":
        return nbytes * 2 * (n - 1) / n
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    if kind == "all-to-all":
        return nbytes * (n - 1) / n
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(kind)


def collective_detail(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Wire bytes by kind (the reference's ``collective_wire_bytes`` keys),
    ``counts`` by kind, and the bytes inside one node (``nvlink_bytes``)
    and across nodes (``ib_bytes``), from ``collectives.recording``'s
    records."""
    out: Dict[str, Any] = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    nvlink = ib = 0.0
    for r in records:
        w = wire_bytes(r["kind"], r["bytes"], r["group"])
        if r["group"] <= 1:
            continue
        out[r["kind"]] += w
        counts[r["kind"]] += 1
        if r["intra_node"]:
            nvlink += w
        else:
            ib += w
    out["counts"] = counts
    out["nvlink_bytes"] = nvlink
    out["ib_bytes"] = ib
    return out


# ------------------------------------------------------------- analytic bytes

def _param_bytes(cfg: ArchConfig, weights: str) -> float:
    per = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}[weights]
    return cfg.param_count() * per


def _active_param_bytes(cfg: ArchConfig, weights: str) -> float:
    per = {"bf16": 2.0, "int8": 1.0, "int4": 0.5}[weights]
    return cfg.active_param_count() * per


def _cache_bytes(cfg: ArchConfig, B: int, S: int, kv_bytes: float = 2.0
                 ) -> float:
    """KV/state cache bytes (whole fleet)."""
    if cfg.family == "ssm":
        ssm = cfg.ssm
        H = ssm.n_heads(cfg.d_model)
        conv = cfg.n_layers * B * (ssm.d_conv - 1) \
            * (ssm.d_inner(cfg.d_model) + 2 * ssm.d_state) * 2
        state = cfg.n_layers * B * H * ssm.head_dim * ssm.d_state * 4
        return conv + state
    kv = 2 * cfg.n_kv_heads * cfg.hd * B * S * kv_bytes
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
        ssm = cfg.ssm
        H = ssm.n_heads(cfg.d_model)
        state = (cfg.n_layers - n_attn) * B * H * ssm.head_dim * ssm.d_state * 4
        return kv * n_attn + state
    if cfg.family == "encdec":
        return kv * cfg.n_layers * 2          # self + cross caches
    return kv * cfg.n_layers


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeConfig, meta: Dict,
                       chips: int) -> float:
    """Per-chip HBM bytes per step (the reference's formulas)."""
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    L = cfg.n_layers
    weights = meta.get("weights", "bf16")
    if meta["kind"] == "train":
        mb = meta.get("microbatches", 1)
        # fwd + bwd weight reads per microbatch (gathered shard traffic lands
        # as HBM writes+reads on the receiving chip), grads rw, opt state rw
        p = cfg.param_count()
        wbytes = 2 * p * 2 * mb              # fwd+bwd reads, bf16
        gbytes = 2 * p * 4                   # grad accumulate rw (f32)
        q8 = meta.get("q8_opt", False)
        obytes = p * (2 * 2 if q8 else 2 * 8) + p * 2      # m+v rw + param write
        act = mb * L * (B // mb) * S * D * 2 * 2           # carry save + load
        logits = (B * S * cfg.padded_vocab() * 2) * 2      # lm head out + grad
        return (wbytes + gbytes + obytes + act + logits) / chips
    if meta["kind"] == "prefill":
        p = _param_bytes(cfg, weights)
        act = L * B * S * D * 2 * 2
        cache_w = _cache_bytes(cfg, B, S)
        return (p + act + cache_w) / chips
    # decode: weights once (active params only for MoE), cache read once
    p = _active_param_bytes(cfg, weights)
    kvb = 2.0 if meta.get("kv_bits", 16) == 16 else 1.0 + 2.0 / cfg.hd
    cache_r = _cache_bytes(cfg, B, S, kv_bytes=kvb)
    return (p + cache_r) / chips


def model_flops(cfg: ArchConfig, shape: ShapeConfig, kind: str) -> float:
    """6·N_active·tokens for train; 2·N_active·tokens for inference.

    N_active excludes the input embedding table: a gather does no matmul
    FLOPs (the LM head does and stays counted).
    """
    n = cfg.active_param_count() - cfg.padded_vocab() * cfg.d_model
    if kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch          # decode: 1 token/request


# ------------------------------------------------------------------- assembly

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    chips: int
    flops_per_chip: float
    raw_bytes_per_chip: float
    analytic_bytes_per_chip: float
    wire_bytes_per_chip: float
    collective_detail: Dict[str, Any]
    memory_analysis: Dict[str, float]
    meta: Dict[str, Any]
    model_flops: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.analytic_bytes_per_chip / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        cd = self.collective_detail
        return cd["nvlink_bytes"] / hw.NVLINK_BW + cd["ib_bytes"] / hw.IB_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap step-time estimate: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful_model_time / estimated_step_time.

        For compute-bound cells this is MFU; for memory/collective-bound cells
        it is the fraction of the step the bounding resource spends on model-
        essential traffic.
        """
        useful_compute = self.model_flops / self.chips / hw.PEAK_FLOPS_BF16
        return min(1.0, useful_compute / max(self.step_s, 1e-30))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "kind": self.kind, "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "raw_bytes_per_chip": self.raw_bytes_per_chip,
            "analytic_bytes_per_chip": self.analytic_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "collective_detail": self.collective_detail,
            "memory_analysis": self.memory_analysis,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_s": self.step_s,
            "model_flops": self.model_flops,
            "flops_ratio": self.model_flops
            / max(self.flops_per_chip * self.chips, 1e-30),
            "meta": {k: v for k, v in self.meta.items()
                     if isinstance(v, (str, int, float, bool))},
        }
