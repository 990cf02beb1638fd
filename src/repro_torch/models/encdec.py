"""Encoder-decoder transformer backbone, seamless-m4t-medium (PyTorch port
of ``repro/models/encdec.py``).

The modality frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``src_embeds`` (B, S_src, D) beside the
target ``tokens``.  The encoder attends bidirectionally with RoPE on the
source positions; each decoder layer attends causally over the target,
then across to the encoder output, whose K / V are computed once at
prefill and carried unchanged through decode.  Under sharded-compute
hints the attention blocks and MLPs compute as the dense family's (heads
over the model axis, the carries split along S, a norm's scale entering
that split compute through ``split=``); the cross K / V are a rank's KV
heads, and the train loss is the global batch's (:func:`dense.xent`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from . import dense
from .layers import (Schema, Spec, activation_block, attention_blocks,
                     cache_rows, cache_seq_block, carry_features, carry_seq,
                     carry_spec, checkpointed, constrain_carry,
                     gather_cache_rows, gqa_attention, init_params,
                     last_position, layer_slice, matmul, rms_norm, rope,
                     stacked_layers, swiglu, take_rows, update_kv_cache,
                     whole_activation)

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


def _heads(cfg: ArchConfig) -> Dict[str, int]:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)


def _self_attn(cfg: ArchConfig, lp, x: torch.Tensor, *, positions,
               causal: bool, cache=None, pos=None, q_block: int = 0,
               keep: Optional[Tuple[int, int]] = None,
               carry: Optional[tuple] = None):
    """Self-attention with its residual: bidirectional (encoder) or causal
    (decoder prefill) over ``x``, returning the layer's (k, v); with a
    ``cache`` (a decode step) the step's (k, v) are written in place at
    ``pos`` and attended against the first ``pos + 1`` rows.  Under
    sharded compute ``x`` is the carry of layout ``carry``, as in
    :func:`dense._attn` (its S gathered before the column-parallel
    projections, ``wo`` row-parallel); ``keep`` as there."""
    B, S = x.shape[0], positions.shape[-1]
    hd = cfg.hd
    fx = carry_features(carry)
    h = whole_activation(rms_norm(x, lp["norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    q = matmul(h, lp["wq"], x_axes=fx).unflatten(-1, (-1, hd))
    k = matmul(h, lp["wk"], x_axes=fx).unflatten(-1, (-1, hd))
    v = matmul(h, lp["wv"], x_axes=fx).unflatten(-1, (-1, hd))
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        qa, ka, va, kv_axes, h_axes = attention_blocks(q, k, v,
                                                       **_heads(cfg))
        attn = gqa_attention(qa, ka, va, causal=causal, q_block=q_block,
                             kv_axes=kv_axes)
        new_cache = (k, v) if keep is None else (k[:, keep[0]:keep[1]],
                                                 v[:, keep[0]:keep[1]])
    else:
        q, k, v, pos_r = (cache_rows(t) for t in (q, k, v, pos))
        update_kv_cache(cache[0], cache[1], k, v, pos_r)
        qa, ka, va, kv_axes, h_axes = attention_blocks(
            q, cache[0], cache[1], cache_side=True, **_heads(cfg))
        attn = gather_cache_rows(gqa_attention(
            qa, ka, va, causal=False, kv_len=pos_r + 1, kv_axes=kv_axes))
        new_cache = cache
    return x + matmul(attn.reshape(B, S, -1), lp["wo"], x_axes=h_axes,
                      carry=carry), new_cache


def _cross_attn(cfg: ArchConfig, lp, x: torch.Tensor, enc_kv,
                q_block: int = 0, *, cached: bool = False,
                carry: Optional[tuple] = None) -> torch.Tensor:
    """Cross-attention with its residual; ``enc_kv``: the encoder output's
    (k, v), each (B, S_src, KV, hd), fixed through decode — under sharded
    compute this rank's KV heads, and with ``cached`` (read from the
    cache) its block of the cache as placed (rows, T)."""
    hd = cfg.hd
    fx = carry_features(carry)
    h = whole_activation(rms_norm(x, lp["norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    B, S = h.shape[:2]
    q = matmul(h, lp["wq"], x_axes=fx).unflatten(-1, (-1, hd))
    if cached:
        q = cache_rows(q)
    qa, ka, va, kv_axes, h_axes = attention_blocks(
        q, enc_kv[0], enc_kv[1], cache_side=cached, **_heads(cfg))
    attn = gqa_attention(qa, ka, va, causal=False, q_block=q_block,
                         kv_axes=kv_axes)
    if cached:
        attn = gather_cache_rows(attn)
    return x + matmul(attn.reshape(B, S, -1), lp["wo"], x_axes=h_axes,
                      carry=carry)


def _cross_kv(cfg: ArchConfig, lp, enc_out: torch.Tensor):
    """The cross-attention (k, v) of ``enc_out`` (B, T, D) (this rank's KV
    heads under sharded compute)."""
    hd = cfg.hd
    return (matmul(enc_out, lp["wk"]).unflatten(-1, (-1, hd)),
            matmul(enc_out, lp["wv"]).unflatten(-1, (-1, hd)))


def _mlp(lp, x: torch.Tensor, carry: Optional[tuple] = None) -> torch.Tensor:
    fx = carry_features(carry)
    h = whole_activation(rms_norm(x, lp["norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], x_axes=fx,
                      carry=carry)


def encode(cfg: ArchConfig, params, src_embeds: torch.Tensor, *,
           remat: bool = False, q_block: int = 0) -> torch.Tensor:
    """The bidirectional encoder over precomputed frontend embeddings;
    ``remat`` recomputes each layer in the backward; ``q_block`` chunks
    attention's queries.  Under sharded-compute hints ``src_embeds`` is
    this rank's rows and the carry rests as the JAX package's
    ``constrain_activation`` decides (after each layer; the first layer
    takes the embeddings cut to the same layout); the output is handed
    back whole along S and D (every cross-attention reads all of it)."""
    S, D = src_embeds.shape[1], cfg.d_model
    positions = torch.arange(S, device=src_embeds.device)
    carry = carry_spec(src_embeds.shape[0], S, D)

    def body(lp_sa, lp_ml, x):
        x, _ = _self_attn(cfg, lp_sa, x, positions=positions, causal=False,
                          q_block=q_block, carry=carry)
        return _mlp(lp_ml, x, carry)

    body = checkpointed(body, remat)
    x = activation_block(src_embeds, carry)
    for lp_sa, lp_ml in zip(
            stacked_layers(params, "enc/self", cfg.enc_layers),
            stacked_layers(params, "enc/mlp", cfg.enc_layers)):
        x = constrain_carry(body(lp_sa, lp_ml, x), S, D)
    fx = carry_features(carry)
    return whole_activation(rms_norm(x, params["enc_final_norm"], x_axes=fx,
                                     split=carry_seq(carry)),
                            carry, features=True)


def decode_train(cfg: ArchConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, remat: bool = False,
                 q_block: int = 0) -> torch.Tensor:
    """The decoder over a whole target prefix (teacher forcing): causal
    self-attention, cross-attention to ``enc_out``, the MLP, each layer;
    returns the final-normed hidden state (the carry's layout under
    sharded compute; ``enc_out`` is :func:`encode`'s, whole)."""
    S, D = tokens.shape[1], cfg.d_model
    carry = carry_spec(tokens.shape[0], S, D)
    x = constrain_carry(take_rows(params["embed"], tokens, carry), S, D)
    positions = torch.arange(S, device=tokens.device)

    def body(lp_sa, lp_ca, lp_ml, x):
        x, _ = _self_attn(cfg, lp_sa, x, positions=positions, causal=True,
                          q_block=q_block, carry=carry)
        x = _cross_attn(cfg, lp_ca, x, _cross_kv(cfg, lp_ca, enc_out),
                        q_block=q_block, carry=carry)
        return _mlp(lp_ml, x, carry)

    body = checkpointed(body, remat)
    L = cfg.n_layers
    for lps in zip(stacked_layers(params, "dec/self", L),
                   stacked_layers(params, "dec/cross", L),
                   stacked_layers(params, "dec/mlp", L)):
        x = constrain_carry(body(*lps, x), S, D)
    return rms_norm(x, params["dec_final_norm"], x_axes=carry_features(carry),
                    split=carry_seq(carry))


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor, *,
              x_axes: Any = None) -> torch.Tensor:
    """Logits over the padded vocabulary, gathered under sharded compute
    (``x_axes``: the axes ``x``'s features are split over)."""
    return matmul(x, params["lm_head"], gather=True, x_axes=x_axes)


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0) -> torch.Tensor:
    """batch: {"src_embeds": (B, S_src, D), "tokens": (B, S_tgt)}; the
    next-token cross-entropy of the target.  Under sharded-compute hints
    ``batch`` is this rank's rows and the loss the mean over every token of
    the global batch (:func:`dense.xent`: the logits are never
    gathered)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    enc_out = encode(cfg, params, batch["src_embeds"], remat=remat,
                     q_block=q_block)
    x = decode_train(cfg, params, inp, enc_out, remat=remat, q_block=q_block)
    return dense.xent(cfg, params, x, labels)


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
    rows padded to ``max_len`` and each layer's cross K / V).  Under
    sharded compute each leaf is this rank's block (rows, KV heads, and
    the T block where the cache rests split along T)."""
    src_embeds, tokens = batch["src_embeds"], batch["tokens"]
    B, S = tokens.shape
    T, S_src, D = max_len or S, src_embeds.shape[1], cfg.d_model
    enc_out = encode(cfg, params, src_embeds, q_block=q_block)
    carry = carry_spec(B, S, D)
    x = constrain_carry(take_rows(params["embed"], tokens, carry), S, D)
    positions = torch.arange(S, device=tokens.device)
    keep, xkeep = dense._kept_rows(S, T), dense._kept_rows(S_src, S_src)
    kv, xkv = [], []
    for l in range(cfg.n_layers):
        x, (k, v) = _self_attn(cfg, _layer(params, "dec/self", l), x,
                               positions=positions, causal=True,
                               q_block=q_block, keep=keep, carry=carry)
        lp_ca = _layer(params, "dec/cross", l)
        xk, xv = _cross_kv(cfg, lp_ca, enc_out)
        x = _cross_attn(cfg, lp_ca, x, (xk, xv), q_block=q_block,
                        carry=carry)
        x = constrain_carry(_mlp(_layer(params, "dec/mlp", l), x, carry), S,
                            D)
        kv.append((k, v))
        xkv.append((xk, xv) if xkeep is None else
                   (xk[:, xkeep[0]:xkeep[1]], xv[:, xkeep[0]:xkeep[1]]))
    lo, hi, t0, Tl = cache_seq_block(S, T)
    cache = {}
    for i, key in enumerate(("k", "v")):
        rows = torch.stack([p[i] for p in kv])             # (L, B, *, KV, hd)
        cache[key] = rows.new_zeros(rows.shape[:2] + (Tl,) + rows.shape[3:])
        cache[key][:, :, lo - t0:hi - t0] = rows
    cache["xk"] = torch.stack([p[0] for p in xkv])
    cache["xv"] = torch.stack([p[1] for p in xkv])
    fx = carry_features(carry)
    x = rms_norm(x, params["dec_final_norm"], x_axes=fx)
    return logits_fn(cfg, params, last_position(x, carry), x_axes=fx), cache


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One target token at position ``pos`` (an int: lockstep); the
    self-attention rows are updated in place, the cross K / V read
    unchanged."""
    D = cfg.d_model
    carry = carry_spec(token.shape[0], 1, D)
    x = constrain_carry(take_rows(params["embed"], token, carry), 1, D)
    positions = pos + torch.arange(1, device=token.device)
    for l in range(cfg.n_layers):
        x, _ = _self_attn(cfg, _layer(params, "dec/self", l), x,
                          positions=positions, causal=False,
                          cache=(cache["k"][l], cache["v"][l]), pos=pos,
                          carry=carry)
        x = _cross_attn(cfg, _layer(params, "dec/cross", l), x,
                        (cache["xk"][l], cache["xv"][l]), cached=True,
                        carry=carry)
        x = constrain_carry(_mlp(_layer(params, "dec/mlp", l), x, carry), 1,
                            D)
    fx = carry_features(carry)
    x = rms_norm(x, params["dec_final_norm"], x_axes=fx)
    return logits_fn(cfg, params, whole_activation(x, carry),
                     x_axes=fx), cache
