"""Encoder-decoder transformer backbone, seamless-m4t-medium (PyTorch port
of ``repro/models/encdec.py``, one device).

The modality frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``src_embeds`` (B, S_src, D) beside the
target ``tokens``.  The encoder attends bidirectionally with RoPE on the
source positions; each decoder layer attends causally over the target,
then across to the encoder output, whose K / V are computed once at
prefill and carried unchanged through decode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .layers import (Schema, Spec, checkpointed, gqa_attention,
                     init_params, layer_slice, matmul, rms_norm, rope,
                     softmax_xent, stacked_layers, swiglu, take_rows,
                     update_kv_cache)

f32 = torch.float32


def _attn_schema(p: str, L: int, D: int, H: int, KV: int, hd: int,
                 resid: float) -> Schema:
    return {
        f"{p}/norm": Spec((L, D), ("layers", None), "ones", f32),
        f"{p}/wq": Spec((L, D, H * hd), ("layers", "embed", "heads")),
        f"{p}/wk": Spec((L, D, KV * hd), ("layers", "embed", "kv")),
        f"{p}/wv": Spec((L, D, KV * hd), ("layers", "embed", "kv")),
        f"{p}/wo": Spec((L, H * hd, D), ("layers", "heads", "embed"), resid),
    }


def _mlp_schema(p: str, L: int, D: int, F: int, resid: float) -> Schema:
    return {
        f"{p}/norm": Spec((L, D), ("layers", None), "ones", f32),
        f"{p}/w_gate": Spec((L, D, F), ("layers", "embed", "mlp")),
        f"{p}/w_up": Spec((L, D, F), ("layers", "embed", "mlp")),
        f"{p}/w_down": Spec((L, F, D), ("layers", "mlp", "embed"), resid),
    }


def schema(cfg: ArchConfig) -> Schema:
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    Le, Ld = cfg.enc_layers, cfg.n_layers
    Vp = cfg.padded_vocab()
    resid = 0.02 / (2 * (Le + Ld)) ** 0.5
    s: Schema = {
        "embed": Spec((Vp, D), ("vocab", "embed"), 0.02),
        "enc_final_norm": Spec((D,), (None,), "ones", f32),
        "dec_final_norm": Spec((D,), (None,), "ones", f32),
        "lm_head": Spec((D, Vp), ("embed", "vocab"), 0.02),
    }
    s.update(_attn_schema("enc/self", Le, D, H, KV, hd, resid))
    s.update(_mlp_schema("enc/mlp", Le, D, F, resid))
    s.update(_attn_schema("dec/self", Ld, D, H, KV, hd, resid))
    s.update(_attn_schema("dec/cross", Ld, D, H, KV, hd, resid))
    s.update(_mlp_schema("dec/mlp", Ld, D, F, resid))
    return s


def init(cfg: ArchConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters on ``device`` (``cuda`` unless the caller
    names the CPU)."""
    from repro_torch import device as _device
    return init_params(schema(cfg), seed, _device.resolve(device))


def _layer(params: Dict[str, Any], prefix: str, l: int) -> Dict[str, Any]:
    """Layer ``l`` of the ``prefix/*`` stack (``enc/self``, ``dec/mlp``,
    ...)."""
    pre = prefix + "/"
    return {k[len(pre):]: layer_slice(v, l) for k, v in params.items()
            if k.startswith(pre)}


def _self_attn(cfg: ArchConfig, lp, x: torch.Tensor, *, positions,
               causal: bool, cache=None, pos=None, q_block: int = 0):
    """Self-attention with its residual: bidirectional (encoder) or causal
    (decoder prefill) over ``x``, returning the layer's (k, v); with a
    ``cache`` (a decode step) the step's (k, v) are written in place at
    ``pos`` and attended against the first ``pos + 1`` rows."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["norm"])
    q = matmul(h, lp["wq"]).reshape(B, S, H, hd)
    k = matmul(h, lp["wk"]).reshape(B, S, KV, hd)
    v = matmul(h, lp["wv"]).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        attn = gqa_attention(q, k, v, causal=causal, q_block=q_block)
        new_cache = (k, v)
    else:
        update_kv_cache(cache[0], cache[1], k, v, pos)
        attn = gqa_attention(q, cache[0], cache[1], causal=False,
                             kv_len=pos + 1)
        new_cache = cache
    return x + matmul(attn.reshape(B, S, H * hd), lp["wo"]), new_cache


def _cross_attn(cfg: ArchConfig, lp, x: torch.Tensor, enc_kv,
                q_block: int = 0) -> torch.Tensor:
    """Cross-attention with its residual; ``enc_kv``: the encoder output's
    (k, v), each (B, S_src, KV, hd), fixed through decode."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = rms_norm(x, lp["norm"])
    q = matmul(h, lp["wq"]).reshape(B, S, H, hd)
    attn = gqa_attention(q, enc_kv[0], enc_kv[1], causal=False,
                         q_block=q_block)
    return x + matmul(attn.reshape(B, S, H * hd), lp["wo"])


def _cross_kv(cfg: ArchConfig, lp, enc_out: torch.Tensor):
    B, T, D = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = matmul(enc_out, lp["wk"]).reshape(B, T, KV, hd)
    v = matmul(enc_out, lp["wv"]).reshape(B, T, KV, hd)
    return k, v


def _mlp(lp, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(rms_norm(x, lp["norm"]), lp["w_gate"], lp["w_up"],
                      lp["w_down"])


def encode(cfg: ArchConfig, params, src_embeds: torch.Tensor, *,
           remat: bool = False, q_block: int = 0) -> torch.Tensor:
    """The bidirectional encoder over precomputed frontend embeddings;
    ``remat`` recomputes each layer in the backward; ``q_block`` chunks
    attention's queries."""
    S = src_embeds.shape[1]
    positions = torch.arange(S, device=src_embeds.device)

    def body(lp_sa, lp_ml, x):
        x, _ = _self_attn(cfg, lp_sa, x, positions=positions, causal=False,
                          q_block=q_block)
        return _mlp(lp_ml, x)

    body = checkpointed(body, remat)
    x = src_embeds
    for lp_sa, lp_ml in zip(
            stacked_layers(params, "enc/self", cfg.enc_layers),
            stacked_layers(params, "enc/mlp", cfg.enc_layers)):
        x = body(lp_sa, lp_ml, x)
    return rms_norm(x, params["enc_final_norm"])


def decode_train(cfg: ArchConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = False,
                 q_block: int = 0) -> torch.Tensor:
    """The decoder over a whole target prefix (teacher forcing): causal
    self-attention, cross-attention to ``enc_out``, the MLP, each layer;
    returns the final-normed hidden state."""
    S = tokens.shape[1]
    x = take_rows(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)

    def body(lp_sa, lp_ca, lp_ml, x):
        x, _ = _self_attn(cfg, lp_sa, x, positions=positions, causal=True,
                          q_block=q_block)
        x = _cross_attn(cfg, lp_ca, x, _cross_kv(cfg, lp_ca, enc_out),
                        q_block=q_block)
        return _mlp(lp_ml, x)

    body = checkpointed(body, remat)
    L = cfg.n_layers
    for lps in zip(stacked_layers(params, "dec/self", L),
                   stacked_layers(params, "dec/cross", L),
                   stacked_layers(params, "dec/mlp", L)):
        x = body(*lps, x)
    return rms_norm(x, params["dec_final_norm"])


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    return matmul(x, params["lm_head"])


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0) -> torch.Tensor:
    """batch: {"src_embeds": (B, S_src, D), "tokens": (B, S_tgt)}; the
    next-token cross-entropy of the target."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(cfg, params, batch["src_embeds"], remat=remat,
                     q_block=q_block)
    x = decode_train(cfg, params, inp, enc_out, remat=remat, q_block=q_block)
    return softmax_xent(logits_fn(cfg, params, x), labels, cfg.vocab)


# ------------------------------------------------------------------------- serving

def cache_specs(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of the cache leaves (self- and cross-attention)."""
    return {
        "k": ("layers", "batch", "kv_seq", "kv", None),
        "v": ("layers", "batch", "kv_seq", "kv", None),
        "xk": ("layers", "batch", "kv_seq", "kv", None),
        "xv": ("layers", "batch", "kv_seq", "kv", None),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, src_len: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Decoder self-attention rows (``k``, ``v``, ``max_len`` each) and the
    cross-attention K / V of the source (``xk``, ``xv``, ``src_len``, by
    default ``max_len``)."""
    Ld, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    src_len = src_len or max_len
    z = lambda T: torch.zeros((Ld, batch, T, KV, hd), dtype=dtype,  # noqa: E731
                              device=device)
    return {"k": z(max_len), "v": z(max_len), "xk": z(src_len),
            "xv": z(src_len)}


def prefill(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            max_len: Optional[int] = None, q_block: int = 0):
    """batch: {"src_embeds", "tokens"}.  Runs the encoder and the target
    prefix; returns (last-position logits, the cache with self-attention
    rows padded to ``max_len`` and each layer's cross K / V)."""
    src_embeds, tokens = batch["src_embeds"], batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(cfg, params, src_embeds, q_block=q_block)
    x = take_rows(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    cache = init_cache(cfg, B, max_len or S, dtype=x.dtype,
                       src_len=src_embeds.shape[1], device=x.device)
    for l in range(cfg.n_layers):
        x, (k, v) = _self_attn(cfg, _layer(params, "dec/self", l), x,
                               positions=positions, causal=True,
                               q_block=q_block)
        lp_ca = _layer(params, "dec/cross", l)
        xk, xv = _cross_kv(cfg, lp_ca, enc_out)
        x = _cross_attn(cfg, lp_ca, x, (xk, xv), q_block=q_block)
        x = _mlp(_layer(params, "dec/mlp", l), x)
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
        cache["xk"][l] = xk
        cache["xv"][l] = xv
    x = rms_norm(x, params["dec_final_norm"])
    return logits_fn(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One target token at position ``pos`` (an int: lockstep); the
    self-attention rows are updated in place, the cross K / V read
    unchanged."""
    x = take_rows(params["embed"], token)
    positions = pos + torch.arange(1, device=token.device)
    for l in range(cfg.n_layers):
        x, _ = _self_attn(cfg, _layer(params, "dec/self", l), x,
                          positions=positions, causal=False,
                          cache=(cache["k"][l], cache["v"][l]), pos=pos)
        x = _cross_attn(cfg, _layer(params, "dec/cross", l), x,
                        (cache["xk"][l], cache["xv"][l]))
        x = _mlp(_layer(params, "dec/mlp", l), x)
    x = rms_norm(x, params["dec_final_norm"])
    return logits_fn(cfg, params, x), cache
