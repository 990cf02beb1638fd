"""Dense decoder-only transformer (PyTorch port of ``repro/models/dense.py``).

Layers are stacked on a leading axis, as in the JAX package; where it runs
``lax.scan`` over the stack, the port loops over the leading axis in Python
(:func:`layers.layer_slice` hands each iteration its layer; the
full-sequence forward takes every layer's views at once with
:func:`layers.stacked_layers`, so that its backward stacks the gradients
once).

Under sharded-compute hints the layer carry rests as the JAX package's
``constrain_activation`` decides (:func:`layers.carry_spec`, None on one
device and under exact TP): each step takes that layout once and passes it
with the carry.  A block gathers the carry's S before its column-parallel
projections (:func:`layers.whole_activation`) and its row-parallel ones
hand the carry back in its layout (``layers.matmul``'s ``carry``);
:func:`layers.constrain_carry` asserts it at the JAX package's places.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.ctx import sharded_compute
from .layers import (Schema, Spec, attention_blocks, cache_rows,
                     cache_seq_block, carry_features, carry_seq, carry_spec,
                     checkpointed, constrain_carry, gather_blocks,
                     gather_cache_rows, gather_heads, gqa_attention,
                     head_block, init_params, kv_dequantize, kv_quantize,
                     last_position, layer_slice, matmul, rms_norm, rope,
                     scatter_blocks, sharded_xent, softmax_xent,
                     stacked_layers, swiglu,
                     take_rows, tied_logits, update_kv_cache,
                     whole_activation)


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


def quantize_kv(k: torch.Tensor):
    """int8 KV quantization: a symmetric scale per (token, head) over
    head_dim, ``max(max|k| / 127, 1e-8)``, codes clipped to +-127 (the JAX
    package's ``quantize_kv``)."""
    kf = k.float()
    s = torch.amax(torch.abs(kf), dim=-1, keepdim=True) / 127.0
    s = torch.maximum(s, torch.tensor(1e-8, dtype=torch.float32,
                                      device=s.device))
    q = torch.clamp(torch.round(kf / s), -127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.bfloat16) * s.to(torch.bfloat16)


def _embed(cfg: ArchConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The carry's first value, this rank's block of the tokens' embedding
    rows (the JAX package's ``constrain_activation(take_rows(...))``)."""
    B, S = tokens.shape
    rows = take_rows(params["embed"], tokens,
                     carry_spec(B, S, cfg.d_model))
    return constrain_carry(rows, S, cfg.d_model)


def _qkv(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor, positions,
         carry: Optional[tuple] = None):
    """The attention block's q, k, v: projections, qk-norm and RoPE (under
    sharded compute, of the carry ``x`` of layout ``carry``, its S
    gathered, with the heads each projection's weight holds here)."""
    hd = cfg.hd
    fx = carry_features(carry)
    h = whole_activation(rms_norm(x, lp["attn_norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    q = matmul(h, lp["wq"], x_axes=fx).unflatten(-1, (-1, hd))
    k = matmul(h, lp["wk"], x_axes=fx).unflatten(-1, (-1, hd))
    v = matmul(h, lp["wv"], x_axes=fx).unflatten(-1, (-1, hd))
    if cfg.qk_norm:
        # inside the block's split compute (a rank's heads)
        split = sharded_compute() is not None
        q = rms_norm(q, lp["q_norm"], split=split)
        k = rms_norm(k, lp["k_norm"], split=split)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _attn(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor, *, positions,
          cache: Optional[Tuple[torch.Tensor, ...]] = None, pos: Any = 0,
          q_block: int = 0, keep: Optional[Tuple[int, int]] = None,
          carry: Optional[tuple] = None):
    """Attention sub-block; returns (out, (k, v) or the cache).

    Without ``cache`` the block attends causally over ``x`` and returns the
    layer's (k, v); with one, the step's (k, v) are written in place at
    ``[pos, pos + S)`` and attended against the whole cache (S > 1 is a
    chunked prefill).  ``cache`` is (k, v) bf16 or (k, v, k_scale, v_scale)
    for the int8 cache, which quantizes the step's rows before the write
    and dequantizes the whole cache for the attention.  ``pos`` is an int
    (lockstep batch) or a ``(B,)`` tensor (slot batch, one independent
    position a row).  ``q_block`` chunks the queries of the cache-less
    path (:func:`layers.gqa_attention`); ``keep`` = ``(lo, hi)`` returns
    only those positions' (k, v) (the rows of a cache split along T that
    this rank holds); ``carry`` is the layout of the carry ``x``
    (:func:`layers.carry_spec`), which ``out`` takes.
    """
    B, S = x.shape[0], positions.shape[-1]
    # on a mesh whose heads split: this rank's heads (the cache holds them)
    q, k, v = head_block(*_qkv(cfg, lp, x, positions, carry))
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    if cache is None:
        qa, ka, va, kv_axes, h_axes = attention_blocks(q, k, v, **heads)
        attn = gqa_attention(qa, ka, va, causal=True, q_block=q_block,
                             kv_axes=kv_axes)
        kv = (k, v) if keep is None else (k[:, keep[0]:keep[1]],
                                          v[:, keep[0]:keep[1]])
    else:
        # the weight-stationary decode: every rank's rows here, the cache
        # holding a block of them
        q, k, v, pos_r = (cache_rows(t) for t in (q, k, v, pos))
        if len(cache) == 4:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            update_kv_cache(cache[0], cache[1], kq, vq, pos_r)
            update_kv_cache(cache[2], cache[3], ks, vs, pos_r)
            ck = dequantize_kv(cache[0], cache[2])
            cv = dequantize_kv(cache[1], cache[3])
        else:
            update_kv_cache(cache[0], cache[1], k, v, pos_r)
            ck, cv = cache[0], cache[1]
        qa, ka, va, kv_axes, h_axes = attention_blocks(
            q, ck, cv, cache_side=True, **heads)
        attn = gather_cache_rows(gqa_attention(
            qa, ka, va, causal=S > 1, q_offset=pos_r, kv_len=pos_r + S,
            kv_axes=kv_axes))
        kv = cache
    out = matmul(gather_heads(attn).reshape(B, S, -1), lp["wo"],
                 x_axes=h_axes, carry=carry)
    return out, kv


def _block(cfg: ArchConfig, lp, x, *, positions, cache=None, pos=0,
           q_block: int = 0, keep: Optional[Tuple[int, int]] = None):
    carry = carry_spec(x.shape[0], positions.shape[-1], cfg.d_model)
    attn_out, kv = _attn(cfg, lp, x, positions=positions, cache=cache, pos=pos,
                         q_block=q_block, keep=keep, carry=carry)
    x = x + attn_out
    fx = carry_features(carry)
    h = whole_activation(rms_norm(x, lp["mlp_norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], x_axes=fx,
                   carry=carry)
    return x, kv


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            remat: bool = False, collect_cache: bool = False,
            q_block: int = 0, cache_len: Optional[int] = None):
    """Full-sequence forward.  Returns (hidden, [(k, v) per layer] | None).

    ``remat`` recomputes each layer in the backward (the JAX package's
    ``jax.checkpoint`` of the scan body); ``q_block`` chunks attention's
    queries.  Under sharded-compute hints whose cache rests split along T,
    each layer's collected (k, v) keeps only the prompt positions this
    rank's block of a ``cache_len``-row cache holds
    (:func:`layers.cache_seq_block`)."""
    S = tokens.shape[1]
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    keep = _kept_rows(S, cache_len) if collect_cache else None
    block = checkpointed(
        lambda lp, x: _block(cfg, lp, x, positions=positions,
                             q_block=q_block, keep=keep), remat)
    caches = []
    for lp in stacked_layers(params, "layers", cfg.n_layers):
        x, kv = block(lp, x)
        x = constrain_carry(x, S, cfg.d_model)
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["final_norm"], x_axes=carry_features(carry),
                 split=carry_seq(carry))
    return x, (caches if collect_cache else None)


def _kept_rows(S: int, cache_len: Optional[int]) -> Optional[Tuple[int, int]]:
    """The prompt positions ``(lo, hi)`` this rank's block of a cache split
    along T holds (``layers.cache_seq_block``); None when the cache's T
    rests whole."""
    h = sharded_compute()
    if h is None or not h.cache_seq_axes:
        return None
    lo, hi, _, _ = cache_seq_block(S, cache_len or S)
    return lo, hi


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor, *,
              x_axes: Any = None) -> torch.Tensor:
    """Logits over the padded vocabulary; under sharded compute ``lm_head``
    is column-parallel over the vocabulary and the logits leave it
    gathered (``x_axes``: the axes ``x``'s features are split over)."""
    if cfg.tie_embeddings:
        return tied_logits(x, params["embed"], x_axes=x_axes)
    return matmul(x, params["lm_head"], gather=True, x_axes=x_axes)


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["tokens"]`` (B, S): the first
    S - 1 tokens predict the last S - 1.  The JAX package's ``unroll`` is a
    scan knob with no eager counterpart; ``q_block`` chunks attention's
    queries.  Under sharded-compute hints ``batch`` is this rank's rows and
    the loss the mean over every token of the global batch
    (:func:`xent`)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    x, _ = forward(cfg, params, inp, remat=remat, q_block=q_block)
    return xent(cfg, params, x, labels)


def xent(cfg: ArchConfig, params, x: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """The cross-entropy of the final carry ``x`` against ``labels``: on
    one device (or under exact TP) of the whole logits, under
    sharded-compute hints of the carry's block without gathering the
    logits (:func:`layers.sharded_xent`)."""
    if sharded_compute() is None:
        return softmax_xent(logits_fn(cfg, params, x), labels, cfg.vocab)
    carry = carry_spec(x.shape[0], labels.shape[1], cfg.d_model)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return sharded_xent(x, head, labels, cfg.vocab, carry,
                        tied=cfg.tie_embeddings)


# ------------------------------------------------------------------------- serving

def cache_specs(cfg: ArchConfig, kv_bits: int = 16, layout: str = "batch"
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of the cache leaves.  ``layout="slot"`` names axis 1
    "slot" instead of "batch": the slot pool of continuous batching is the
    same memory, but its rows are resident slots rather than one lockstep
    batch, and the sharding rules resolve the two independently."""
    b = "slot" if layout == "slot" else "batch"
    s = {
        "k": ("layers", b, "kv_seq", "kv", None),
        "v": ("layers", b, "kv_seq", "kv", None),
    }
    if kv_bits == 8:
        s["k_scale"] = ("layers", b, "kv_seq", "kv", None)
        s["v_scale"] = ("layers", b, "kv_seq", "kv", None)
    return s


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               kv_bits: int = 16,
               kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The slot cache: bf16 ``k`` / ``v``, or with ``kv_bits=8`` int8 codes
    and a bf16 scale per (token, head) (four leaves).  ``kv_heads`` sizes
    it for a rank's block of the KV heads (all of them by default)."""
    L, KV, hd = cfg.n_layers, kv_heads or cfg.n_kv_heads, cfg.hd
    if kv_bits == 8:
        shape = (L, batch, max_len, KV, hd)
        sshape = shape[:-1] + (1,)
        bf = torch.bfloat16
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=bf, device=device),
            "v_scale": torch.zeros(sshape, dtype=bf, device=device),
        }
    return {
        "k": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, KV, hd), dtype=dtype,
                         device=device),
    }


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, q_block: int = 0):
    """Run the prompt; return (last-position logits, cache padded to max_len)."""
    S = tokens.shape[1]
    x, caches = forward(cfg, params, tokens, collect_cache=True,
                        q_block=q_block, cache_len=max_len or S)
    cache = _prefill_cache(cfg, caches, max_len or S, S)
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    logits = logits_fn(cfg, params, last_position(x, carry),
                       x_axes=carry_features(carry))
    return logits, cache


def _prefill_cache(cfg: ArchConfig, caches, max_len: int, S: int):
    """A slot cache of ``max_len`` rows holding each layer's prompt (k, v)
    (B, S, KV, hd) in its first ``S`` rows, zeros after (the JAX package's
    padded stack); KV is the heads the layers gave (a rank's block of them
    when the heads split over a mesh).  A cache whose T rests split holds
    this rank's block of the rows, and ``caches`` the prompt positions
    that land in it (:func:`layers.cache_seq_block`)."""
    k0 = caches[0][0]
    B, KV = k0.shape[0], k0.shape[2]
    lo, hi, t0, Tl = cache_seq_block(S, max_len)
    cache = init_cache(cfg, B, Tl, dtype=k0.dtype, device=k0.device,
                       kv_heads=KV)
    for l, (k, v) in enumerate(caches):
        cache["k"][l, :, lo - t0:hi - t0] = k
        cache["v"][l, :, lo - t0:hi - t0] = v
    return cache


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

    cache: ``init_cache`` layout (bf16, or the four int8 leaves); pos: an
    int (lockstep) or a (B,) tensor of per-row write offsets (the chunk
    occupies cache rows ``[pos, pos + S)``; the caller keeps
    ``pos + S <= max_len``).  Returns
    (logits for every chunk position (B, S, V), cache updated in place).
    With S > 1 this is the admission path of continuous batching: the
    caller picks the logit at the request's true last prompt position, so
    ragged prompts ride in fixed-size chunks (pad tokens land in the cache
    but stay masked, because ``kv_len`` never reaches them).
    """
    S = tokens.shape[1]
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    x = _embed(cfg, params, tokens)
    positions = _positions(pos, S, tokens.device)
    for l in range(cfg.n_layers):
        x, _ = _block(cfg, _layer(params, l), x, positions=positions,
                      cache=_cache_layer(cache, l), pos=pos)
        x = constrain_carry(x, S, cfg.d_model)
    fx = carry_features(carry)
    x = rms_norm(x, params["final_norm"], x_axes=fx)
    return logits_fn(cfg, params, whole_activation(x, carry),
                     x_axes=fx), cache


def _cache_layer(cache: Dict[str, torch.Tensor], l: int) -> Tuple:
    """Layer ``l``'s leaves of a slot cache, in ``_attn``'s order (views:
    writes to them land in the cache)."""
    keys = ("k", "v", "k_scale", "v_scale") if "k_scale" in cache \
        else ("k", "v")
    return tuple(cache[k][l] for k in keys)


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
    return _embed(cfg, params, tokens)


def head_step(cfg: ArchConfig, params, x: torch.Tensor, *,
              last_only: bool = False) -> torch.Tensor:
    """Final norm + logits (the post-loop lines of the step functions).
    ``last_only`` reproduces `prefill`'s last-position slice."""
    x = rms_norm(x, params["final_norm"])
    if last_only:
        x = x[:, -1:, :]
    return logits_fn(cfg, params, x)


def resident_prefill_block(cfg: ArchConfig, lp, x: torch.Tensor, *,
                           positions: torch.Tensor, q_block: int = 0):
    """One `forward`-collect-cache iteration: full causal attention over the
    prompt, returning the layer's (k, v) for the caller to write into the
    cache at its layer row."""
    x, kv = _block(cfg, lp, x, positions=positions, q_block=q_block)
    return constrain_carry(x, positions.shape[-1], cfg.d_model), kv


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
                  cache=_cache_layer(cache, l), pos=pos)
    return constrain_carry(x, positions.shape[-1], cfg.d_model), cache


# ------------------------------------------------------------- paged KV cache
#
# Block-pool twins of the slot-batch step functions.  The cache is a pool of
# fixed-size blocks, (L, n_blocks, block_size, KV, .) a leaf, and every
# request's sequence is routed through a (B, max_blocks) block table:
# attention scatters the step's K/V into the table's blocks (in place) and
# gathers the logical sequence back out (``layers.gather_blocks`` /
# ``scatter_blocks``).  With dense bf16 blocks the gathered sequence holds
# bitwise the same live rows as the slot cache, so greedy decode equals
# ``decode_step`` / ``prefill_chunk`` when ``max_len`` is a multiple of the
# block size (one attention shape); quantized pools (``kv_bits`` 8 / 4)
# trade bounded greedy drift for more tokens a byte.  ``pos`` is always the
# (B,) per-slot tensor: paged serving is a continuous-batching feature.


def init_kv_pool(cfg: ArchConfig, n_blocks: int, block_size: int,
                 kv_bits: int = 16, device=None) -> Dict[str, torch.Tensor]:
    """Preallocate a paged KV block pool (block id 0 is the trash block)."""
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if kv_bits == 16:
        shape = (L, n_blocks, block_size, KV, hd)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    assert kv_bits in (8, 4), kv_bits
    if kv_bits == 4 and hd % 2:
        raise ValueError(f"kv_bits=4 nibble-packs head_dim pairs; "
                         f"hd={hd} is odd")
    hs = hd if kv_bits == 8 else hd // 2
    pool = {}
    for side in ("k", "v"):
        pool[side] = torch.zeros((L, n_blocks, block_size, KV, hs),
                                 dtype=torch.uint8, device=device)
    for side in ("k", "v"):
        for part in ("scale", "zero"):
            pool[f"{side}_{part}"] = torch.zeros(
                (L, n_blocks, block_size, KV, 1), dtype=torch.bfloat16,
                device=device)
    return pool


def _pool_meta(cfg: ArchConfig, pool) -> Tuple[Tuple[str, ...], int]:
    """(leaf order, kv_bits), read from the pool's leaves and shapes."""
    if "k_scale" not in pool:
        return ("k", "v"), 16
    bits = 8 if pool["k"].shape[-1] == cfg.hd else 4
    return ("k", "k_scale", "k_zero", "v", "v_scale", "v_zero"), bits


def _paged_attn(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor, *,
                pc: Dict[str, torch.Tensor], bt: torch.Tensor,
                pos: torch.Tensor):
    """Attention against one layer's block-pool slice ``pc``: the cached
    path of :func:`_attn` op for op, with ``scatter_blocks`` in place of
    ``update_kv_cache`` (first) and ``gather_blocks`` materializing the
    (B, MB*BS) sequence that ``gqa_attention`` masks by ``kv_len`` (then).
    Quantized pools quantize the step's K/V per (token, head) before the
    scatter and dequantize the gathered sequence."""
    if sharded_compute() is not None:
        raise NotImplementedError("the paged KV cache under sharded "
                                  "compute (the pool rests whole)")
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    positions = _positions(pos, S, x.device)                   # (B, S)
    q, k, v = _qkv(cfg, lp, x, positions)
    _, bits = _pool_meta(cfg, pc)
    if bits == 16:
        ck = gather_blocks(scatter_blocks(pc["k"], bt, positions, k), bt)
        cv = gather_blocks(scatter_blocks(pc["v"], bt, positions, v), bt)
    else:
        seq = {}
        for side, step_val in (("k", k), ("v", v)):
            parts = kv_quantize(step_val, bits)
            for name, part in zip((side, f"{side}_scale", f"{side}_zero"),
                                  parts):
                seq[name] = gather_blocks(
                    scatter_blocks(pc[name], bt, positions, part), bt)
        ck, cv = (kv_dequantize(seq[s], seq[f"{s}_scale"], seq[f"{s}_zero"],
                                bits) for s in ("k", "v"))
    attn = gqa_attention(q, ck, cv, causal=S > 1, q_offset=pos,
                         kv_len=pos + S)
    return matmul(attn.reshape(B, S, H * hd), lp["wo"])


def _paged_block(cfg: ArchConfig, lp, x, *, pc, bt, pos):
    x = x + _paged_attn(cfg, lp, x, pc=pc, bt=bt, pos=pos)
    h = rms_norm(x, lp["mlp_norm"])
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def paged_prefill_chunk(cfg: ArchConfig, params, tokens: torch.Tensor, pool,
                        bt: torch.Tensor, pos: torch.Tensor):
    """Chunked prefill through the block table (paged ``prefill_chunk``).

    tokens: (B, S) chunk; pool: ``init_kv_pool`` dict (written in place);
    bt: (B, MB) block table; pos: (B,) chunk start offsets.  The chunk's
    rows land in the blocks ``bt`` names for positions [pos, pos + S); the
    caller keeps those entries allocated (admission allocates the whole
    request: ``serving/kvcache/blocks.py``).  Returns (logits (B, S, V),
    pool).
    """
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    keys, _ = _pool_meta(cfg, pool)
    for l in range(cfg.n_layers):
        x = _paged_block(cfg, _layer(params, l), x,
                         pc={k: pool[k][l] for k in keys}, bt=bt, pos=pos)
        x = constrain_carry(x, S, cfg.d_model)
    x = rms_norm(x, params["final_norm"])
    return logits_fn(cfg, params, x), pool


def paged_decode_step(cfg: ArchConfig, params, token: torch.Tensor, pool,
                      bt: torch.Tensor, pos: torch.Tensor):
    """One generation step over a paged slot batch: a one-token
    :func:`paged_prefill_chunk`.  token: (B, 1); bt: (B, MB) block table
    (all-trash rows for inactive lanes); pos: (B,) per-slot kv_len."""
    return paged_prefill_chunk(cfg, params, token, pool, bt, pos)
