"""Dense decoder-only transformer (PyTorch port of ``repro/models/dense.py``).

Layers are stacked on a leading axis, as in the JAX package; where it runs
``lax.scan`` over the stack, the port loops over the leading axis in Python
(:func:`layers.layer_slice` hands each iteration its layer).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from .layers import (Schema, Spec, deq, gqa_attention, init_params,
                     layer_slice, matmul, rms_norm, rope, swiglu, take_rows,
                     update_kv_cache)


def schema(cfg: ArchConfig) -> Schema:
    L, D, H, KV, hd, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, cfg.d_ff)
    Vp = cfg.padded_vocab()
    resid = 0.02 / (2 * L) ** 0.5    # residual-branch init scaling
    f32 = torch.float32
    s: Schema = {
        "embed": Spec((Vp, D), ("vocab", "embed"), 0.02),
        "final_norm": Spec((D,), (None,), "ones", f32),
        "layers/attn_norm": Spec((L, D), ("layers", None), "ones", f32),
        "layers/wq": Spec((L, D, H * hd), ("layers", "embed", "heads")),
        "layers/wk": Spec((L, D, KV * hd), ("layers", "embed", "kv")),
        "layers/wv": Spec((L, D, KV * hd), ("layers", "embed", "kv")),
        "layers/wo": Spec((L, H * hd, D), ("layers", "heads", "embed"), resid),
        "layers/mlp_norm": Spec((L, D), ("layers", None), "ones", f32),
        "layers/w_gate": Spec((L, D, F), ("layers", "embed", "mlp")),
        "layers/w_up": Spec((L, D, F), ("layers", "embed", "mlp")),
        "layers/w_down": Spec((L, F, D), ("layers", "mlp", "embed"), resid),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((D, Vp), ("embed", "vocab"), 0.02)
    if cfg.qk_norm:
        s["layers/q_norm"] = Spec((L, hd), ("layers", None), "ones", f32)
        s["layers/k_norm"] = Spec((L, hd), ("layers", None), "ones", f32)
    return s


def init(cfg: ArchConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters on ``device`` (``cuda`` unless the caller
    names the CPU)."""
    from repro_torch import device as _device
    return init_params(schema(cfg), seed, _device.resolve(device))


def _layer(params: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k.split("/", 1)[1]: layer_slice(v, l)
            for k, v in params.items() if k.startswith("layers/")}


def _attn(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor, *, positions,
          cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          pos: Any = 0):
    """Attention sub-block; returns (out, (k, v)).

    Without ``cache`` the block attends causally over ``x`` and returns the
    layer's (k, v); with one, the step's (k, v) are written in place at
    ``[pos, pos + S)`` and attended against the whole cache (S > 1 is a
    chunked prefill).  ``pos`` is an int (lockstep batch) or a ``(B,)``
    tensor (slot batch, one independent position a row).
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rms_norm(x, lp["attn_norm"])
    q = matmul(h, lp["wq"]).reshape(B, S, H, hd)
    k = matmul(h, lp["wk"]).reshape(B, S, KV, hd)
    v = matmul(h, lp["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        attn = gqa_attention(q, k, v, causal=True)
        kv = (k, v)
    else:
        update_kv_cache(cache[0], cache[1], k, v, pos)
        attn = gqa_attention(q, cache[0], cache[1], causal=S > 1,
                             q_offset=pos, kv_len=pos + S)
        kv = cache
    out = matmul(attn.reshape(B, S, H * hd), lp["wo"])
    return out, kv


def _block(cfg: ArchConfig, lp, x, *, positions, cache=None, pos=0):
    attn_out, kv = _attn(cfg, lp, x, positions=positions, cache=cache, pos=pos)
    x = x + attn_out
    h = rms_norm(x, lp["mlp_norm"])
    x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return x, kv


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            collect_cache: bool = False):
    """Full-sequence forward.  Returns (hidden, [(k, v) per layer] | None)."""
    S = tokens.shape[1]
    x = take_rows(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)
    caches = []
    for l in range(cfg.n_layers):
        x, kv = _block(cfg, _layer(params, l), x, positions=positions)
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["final_norm"])
    return x, (caches if collect_cache else None)


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return matmul(x, deq(params["embed"]).T)
    return matmul(x, params["lm_head"])


# ------------------------------------------------------------------------- serving

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype,
                         device=device),
    }


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None):
    """Run the prompt; return (last-position logits, cache padded to max_len)."""
    B, S = tokens.shape
    max_len = max_len or S
    x, caches = forward(cfg, params, tokens, collect_cache=True)
    cache = init_cache(cfg, B, max_len, dtype=caches[0][0].dtype,
                       device=tokens.device)
    for l, (k, v) in enumerate(caches):
        cache["k"][l, :, :S] = k
        cache["v"][l, :, :S] = v
    logits = logits_fn(cfg, params, x[:, -1:, :])
    return logits, cache


def _positions(pos: Any, S: int, device) -> torch.Tensor:
    """Positions of an S-token step written at ``pos``: (S,) for an int
    (lockstep), (B, S) for a (B,) tensor of per-slot positions."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1, 1) + torch.arange(S, device=device)
    return pos + torch.arange(S, device=device)


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One generation step: a one-token :func:`prefill_chunk`.  token:
    (B, 1) int; pos: an int shared by the whole batch (lockstep) or a (B,)
    tensor of per-slot positions (continuous batch).  ``cache`` is updated
    in place and returned."""
    return prefill_chunk(cfg, params, token, cache, pos)


def prefill_chunk(cfg: ArchConfig, params, tokens: torch.Tensor, cache, pos):
    """Write a (B, S) chunk of tokens into an existing cache and attend it
    against the whole cache.

    cache: ``init_cache`` layout (bf16); pos: an int (lockstep) or a (B,)
    tensor of per-row write offsets (the chunk occupies cache rows
    ``[pos, pos + S)``; the caller keeps ``pos + S <= max_len``).  Returns
    (logits for every chunk position (B, S, V), cache updated in place).
    With S > 1 this is the admission path of continuous batching: the
    caller picks the logit at the request's true last prompt position, so
    ragged prompts ride in fixed-size chunks (pad tokens land in the cache
    but stay masked, because ``kv_len`` never reaches them).
    """
    x = take_rows(params["embed"], tokens)
    positions = _positions(pos, tokens.shape[1], tokens.device)
    for l in range(cfg.n_layers):
        x, _ = _block(cfg, _layer(params, l), x, positions=positions,
                      cache=(cache["k"][l], cache["v"][l]), pos=pos)
    x = rms_norm(x, params["final_norm"])
    return logits_fn(cfg, params, x), cache


# ------------------------------------------------- compressed-resident serving
#
# Per-layer weight-slot entry points: the same math as `prefill` /
# `decode_step`, one layer at a time, with the layer's weights passed as a
# slot dict (the keys `_layer` would produce) instead of sliced from the
# stacked params.  `serving.engine.ServeSteps` loops the layers in execution
# order so the entropy decode of layer l+1 can run beside layer l.  Each
# function mirrors one iteration of its whole-tree twin op for op, so greedy
# decode matches the dense-resident engine bit for bit.


def embed_step(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding against the resident globals (the pre-loop line of
    `forward` / `decode_step`).  tokens: (B, S) int."""
    return take_rows(params["embed"], tokens)


def head_step(cfg: ArchConfig, params, x: torch.Tensor, *,
              last_only: bool = False) -> torch.Tensor:
    """Final norm + logits (the post-loop lines of the step functions).
    ``last_only`` reproduces `prefill`'s last-position slice."""
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:, :]
    return logits_fn(cfg, params, x)


def resident_prefill_block(cfg: ArchConfig, lp, x: torch.Tensor, *,
                           positions: torch.Tensor):
    """One `forward`-collect-cache iteration: full causal attention over the
    prompt, returning the layer's (k, v) for the caller to write into the
    cache at its layer row."""
    return _block(cfg, lp, x, positions=positions)


def resident_block(cfg: ArchConfig, lp, x: torch.Tensor, cache, l: int,
                   pos):
    """One `decode_step` / `prefill_chunk` iteration against the
    layer-stacked cache: layer ``l``'s rows of ``cache`` are updated in
    place.  ``pos`` follows the step functions' contract (an int for a
    lockstep batch, a (B,) tensor per slot); S comes from ``x``, so the same
    call serves decode (S = 1) and chunked prefill.  ``lp`` values may be
    tensors, QT / QT4 triples or FusedQT handles: every weight goes through
    ``layers.matmul``, which decodes fused handles inside the matmul."""
    positions = _positions(pos, x.shape[1], x.device)
    x, _ = _block(cfg, lp, x, positions=positions,
                  cache=(cache["k"][l], cache["v"][l]), pos=pos)
    return x, cache
