"""Jamba-style hybrid decoder: Mamba-2 and attention interleaved, with MoE
feed-forwards (PyTorch port of ``repro/models/hybrid.py``).

Layers are grouped into *periods* of ``attn_period`` blocks (arXiv:
2403.19887): each period holds ONE attention block, at its middle
position, and ``attn_period - 1`` Mamba-2 blocks.  Every block carries a
feed-forward: MoE at every ``every_n``-th position, a dense SwiGLU
elsewhere.  Parameters are stacked over periods (``periods/pos{j}/...``),
as in the JAX package; where it runs ``lax.scan`` over the periods, the
port loops over them in Python.

The attention blocks are the dense family's and hold a KV cache, the Mamba
blocks an O(1) conv and SSM state; the MoE dispatch is
:func:`repro_torch.models.moe.moe_mlp`.  Under sharded-compute hints each
block computes its rank's share as its family does; the carry is not
sequence-parallel (the JAX package's hints for this family), so it rests
split by batch rows only, and the train loss is the global batch's
(:func:`dense.xent`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from . import dense, mamba2
from .layers import (Schema, Spec, cache_seq_block, carry_features,
                     carry_spec, checkpointed, constrain_carry, init_params,
                     last_position, layer_slice, matmul, rms_norm,
                     stacked_layers, swiglu, take_rows, whole_activation)
from .moe import _padded_experts, moe_block_schema, moe_mlp

f32 = torch.float32


def _layout(cfg: ArchConfig) -> List[Tuple[str, str]]:
    """Per-period position layout: a list of (mixer, ffn) strings."""
    period = cfg.attn_period
    assert cfg.n_layers % period == 0, (cfg.n_layers, period)
    every = cfg.moe.every_n if cfg.moe else 0
    if every:
        assert period % every == 0, (period, every)
    attn_idx = period // 2
    out = []
    for j in range(period):
        mixer = "attn" if j == attn_idx else "mamba"
        ffn = "moe" if (every and j % every == every - 1) else "mlp"
        out.append((mixer, ffn))
    return out


def schema(cfg: ArchConfig) -> Schema:
    D, F = cfg.d_model, cfg.d_ff
    nP = cfg.n_layers // cfg.attn_period
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Vp = cfg.padded_vocab()
    resid = 0.02 / (2 * cfg.n_layers) ** 0.5
    s: Schema = {
        "embed": Spec((Vp, D), ("vocab", "embed"), 0.02),
        "final_norm": Spec((D,), (None,), "ones", f32),
        "lm_head": Spec((D, Vp), ("embed", "vocab"), 0.02),
    }
    for j, (mixer, ffn) in enumerate(_layout(cfg)):
        p = f"periods/pos{j}"
        if mixer == "attn":
            s[f"{p}/attn_norm"] = Spec((nP, D), ("layers", None), "ones", f32)
            s[f"{p}/wq"] = Spec((nP, D, H * hd), ("layers", "embed", "heads"))
            s[f"{p}/wk"] = Spec((nP, D, KV * hd), ("layers", "embed", "kv"))
            s[f"{p}/wv"] = Spec((nP, D, KV * hd), ("layers", "embed", "kv"))
            s[f"{p}/wo"] = Spec((nP, H * hd, D), ("layers", "heads", "embed"),
                                resid)
        else:
            s.update(mamba2.mamba_schema(p, nP, D, cfg.ssm, resid))
        s[f"{p}/mlp_norm"] = Spec((nP, D), ("layers", None), "ones", f32)
        if ffn == "moe":
            s.update(moe_block_schema(f"{p}/moe", nP, D, F, cfg.moe,
                                      _padded_experts(cfg), resid))
        else:
            s[f"{p}/w_gate"] = Spec((nP, D, F), ("layers", "embed", "mlp"))
            s[f"{p}/w_up"] = Spec((nP, D, F), ("layers", "embed", "mlp"))
            s[f"{p}/w_down"] = Spec((nP, F, D), ("layers", "mlp", "embed"),
                                    resid)
    return s


def init(cfg: ArchConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters on ``device`` (``cuda`` unless the caller
    names the CPU)."""
    from repro_torch import device as _device
    return init_params(schema(cfg), seed, _device.resolve(device))


def _period(params: Dict[str, Any], p: int) -> Dict[str, Any]:
    """Period ``p`` of the stacked ``periods/*`` parameters."""
    return {k.split("/", 1)[1]: layer_slice(v, p)
            for k, v in params.items() if k.startswith("periods/")}


def _pos_params(pp: Dict[str, Any], j: int) -> Dict[str, Any]:
    pre = f"pos{j}/"
    return {k[len(pre):]: v for k, v in pp.items() if k.startswith(pre)}


def _ffn(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor,
         ffn_kind: str, carry: Optional[tuple] = None):
    """The feed-forward with its residual, and the MoE aux (0 for a dense
    SwiGLU); under sharded compute on the carry of layout ``carry``, as the
    dense and MoE families' blocks run it."""
    fx = carry_features(carry)
    h = rms_norm(x, lp["mlp_norm"], x_axes=fx)
    if ffn_kind == "moe":
        wts = {k.split("/", 1)[1]: v for k, v in lp.items()
               if k.startswith("moe/")}
        y, aux = moe_mlp(whole_activation(h, carry, features=True), wts,
                         cfg.moe, _padded_experts(cfg), carry)
        return x + y, aux
    y = swiglu(whole_activation(h, carry), lp["w_gate"], lp["w_up"],
               lp["w_down"], x_axes=fx, carry=carry)
    return x + y, torch.zeros((), dtype=f32, device=x.device)


def _period_body(cfg: ArchConfig, pp: Dict[str, Any], x: torch.Tensor, *,
                 positions, caches: Optional[Dict[str, torch.Tensor]] = None,
                 pos=None, chunk: Optional[int] = None,
                 collect: bool = False, q_block: int = 0,
                 keep: Optional[Tuple[int, int]] = None,
                 carry: Optional[tuple] = None, remat_inner: bool = False):
    """Apply one period's blocks.  ``caches``: the period's {"k", "v",
    "conv_x", "conv_bc", "ssm"} (a decode step updates them in place).
    Returns (x, the period's new caches | None, the summed MoE aux).
    ``keep`` and ``carry`` as in :func:`dense._attn`: under sharded compute
    every block takes and hands back the carry of layout ``carry``.

    ``remat_inner`` checkpoints every sub-block (each mixer, each
    feed-forward) inside the checkpointed period, as the JAX package does:
    with the period's checkpoint alone its backward replay holds every
    sub-block's FSDP weight gathers live at once; nested, one sub-block's.
    The values are the same."""
    new_kv = None
    new_conv_x, new_conv_bc, new_ssm = [], [], []
    aux_total = torch.zeros((), dtype=f32, device=x.device)
    mamba_i = 0
    decode = caches is not None and x.shape[1] == 1 and pos is not None
    for j, (mixer, ffn_kind) in enumerate(_layout(cfg)):
        lp = _pos_params(pp, j)
        if mixer == "attn":
            # the dense family's attention (no qk-norm on these configs):
            # a decode step writes its (k, v) in place at ``pos``
            cache = (caches["k"], caches["v"]) if decode else None
            out, new_kv = checkpointed(dense._attn, remat_inner)(
                cfg, lp, x, positions=positions, cache=cache, pos=pos,
                q_block=q_block, keep=keep, carry=carry)
            x = x + out
        else:
            cs = ((caches["conv_x"][mamba_i], caches["conv_bc"][mamba_i])
                  if decode else None)
            hs = caches["ssm"][mamba_i] if decode else None
            out, ((cx2, cbc2), hs2) = checkpointed(
                mamba2._mamba_block, remat_inner)(
                cfg, lp, x, conv_state=cs, ssm_state=hs, chunk=chunk,
                carry=carry)
            x = x + out
            if decode or collect:
                new_conv_x.append(cx2)
                new_conv_bc.append(cbc2)
                new_ssm.append(hs2)
            mamba_i += 1
        x, aux = checkpointed(_ffn, remat_inner)(cfg, lp, x, ffn_kind,
                                                 carry)
        aux_total = aux_total + aux
    out_caches = None
    if decode or collect:
        out_caches = {"k": new_kv[0], "v": new_kv[1],
                      "conv_x": torch.stack(new_conv_x),
                      "conv_bc": torch.stack(new_conv_bc),
                      "ssm": torch.stack(new_ssm)}
    return x, out_caches, aux_total


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            remat: bool = False, collect_cache: bool = False,
            chunk: Optional[int] = None, q_block: int = 0,
            cache_len: Optional[int] = None):
    """Full-sequence forward.  Returns (hidden, [period caches] | None, the
    MoE aux averaged over the layers).  ``remat`` recomputes each period in
    the backward and, inside it, each sub-block (:func:`_period_body`'s
    ``remat_inner``), as the JAX package does.  Under sharded-compute hints
    the carry rests as the JAX package's ``constrain_activation`` decides
    (batch rows only: the family's carries are not sequence-parallel), at
    its places; ``cache_len`` as in :func:`dense.forward`."""
    S, D = tokens.shape[1], cfg.d_model
    carry = carry_spec(tokens.shape[0], S, D)
    x = constrain_carry(take_rows(params["embed"], tokens, carry), S, D)
    positions = torch.arange(S, device=tokens.device)
    keep = dense._kept_rows(S, cache_len) if collect_cache else None
    aux_sum = torch.zeros((), dtype=f32, device=tokens.device)
    body = checkpointed(
        lambda pp, x: _period_body(cfg, pp, x, positions=positions,
                                   chunk=chunk, collect=collect_cache,
                                   q_block=q_block, keep=keep, carry=carry,
                                   remat_inner=remat),
        remat)
    caches = []
    for pp in stacked_layers(params, "periods",
                             cfg.n_layers // cfg.attn_period):
        x, c, aux = body(pp, x)
        x = constrain_carry(x, S, D)
        aux_sum = aux_sum + aux
        if collect_cache:
            caches.append(c)
    x = rms_norm(x, params["final_norm"], x_axes=carry_features(carry))
    return x, (caches if collect_cache else None), aux_sum / cfg.n_layers


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor, *,
              x_axes: Any = None) -> torch.Tensor:
    """Logits over the padded vocabulary, gathered under sharded compute
    (``x_axes``: the axes ``x``'s features are split over)."""
    return matmul(x, params["lm_head"], gather=True, x_axes=x_axes)


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0, aux_coef: float = 0.01,
            chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy plus ``aux_coef`` times the MoE aux (under
    sharded-compute hints ``batch`` is this rank's rows, and both are the
    global batch's: :func:`dense.xent`, ``moe._routed``'s summed
    statistics)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    x, _, aux = forward(cfg, params, inp, remat=remat, chunk=chunk,
                        q_block=q_block)
    return dense.xent(cfg, params, x, labels) + aux_coef * aux


# ------------------------------------------------------------------------- serving

def cache_specs(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of the cache leaves (KV rows of the attention blocks,
    conv and SSM states of the Mamba blocks)."""
    return {
        "k": ("layers", "batch", "kv_seq", "kv", None),
        "v": ("layers", "batch", "kv_seq", "kv", None),
        "conv_x": ("layers", None, "batch", None, "mlp"),
        "conv_bc": ("layers", None, "batch", None, None),
        "ssm": ("layers", None, "batch", "heads", None, None),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """KV rows for the attention blocks, conv and SSM states for the Mamba
    blocks, stacked over periods (and over a period's Mamba positions)."""
    ssm = cfg.ssm
    nP = cfg.n_layers // cfg.attn_period
    KV, hd = cfg.n_kv_heads, cfg.hd
    Din = ssm.d_inner(cfg.d_model)
    Hs, N, G = ssm.n_heads(cfg.d_model), ssm.d_state, 1
    n_mamba = cfg.attn_period - 1
    z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt,  # noqa: E731
                                            device=device)
    return {
        "k": z((nP, batch, max_len, KV, hd)),
        "v": z((nP, batch, max_len, KV, hd)),
        "conv_x": z((nP, n_mamba, batch, ssm.d_conv - 1, Din)),
        "conv_bc": z((nP, n_mamba, batch, ssm.d_conv - 1, 2 * G * N)),
        "ssm": z((nP, n_mamba, batch, Hs, ssm.head_dim, N), f32),
    }


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, chunk: Optional[int] = None,
            q_block: int = 0):
    """Run the prompt; return (last-position logits, the cache with KV rows
    padded to ``max_len``).  Under sharded compute each leaf is this
    rank's block (its rows, KV heads or T block, inner channels, SSD
    heads)."""
    B, S = tokens.shape
    T = max_len or S
    x, caches, _ = forward(cfg, params, tokens, collect_cache=True,
                           chunk=chunk, q_block=q_block, cache_len=T)
    lo, hi, t0, Tl = cache_seq_block(S, T)
    cache = {key: torch.stack([c[key] for c in caches])
             for key in ("conv_x", "conv_bc", "ssm")}
    for key in ("k", "v"):
        kv = torch.stack([c[key] for c in caches])        # (nP, B, *, KV, hd)
        cache[key] = kv.new_zeros(kv.shape[:2] + (Tl,) + kv.shape[3:])
        cache[key][:, :, lo - t0:hi - t0] = kv
    carry = carry_spec(B, S, cfg.d_model)
    return logits_fn(cfg, params, last_position(x, carry),
                     x_axes=carry_features(carry)), cache


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One generation step at position ``pos`` (an int: lockstep); the
    cache is updated in place."""
    D = cfg.d_model
    carry = carry_spec(token.shape[0], 1, D)
    x = constrain_carry(take_rows(params["embed"], token, carry), 1, D)
    positions = pos + torch.arange(1, device=token.device)
    for p in range(cfg.n_layers // cfg.attn_period):
        period = {k: v[p] for k, v in cache.items()}
        x, nc, _ = _period_body(cfg, _period(params, p), x,
                                positions=positions, caches=period, pos=pos,
                                carry=carry)
        x = constrain_carry(x, 1, D)
        for key in ("conv_x", "conv_bc", "ssm"):
            cache[key][p] = nc[key]
    fx = carry_features(carry)
    x = rms_norm(x, params["final_norm"], x_axes=fx)
    return logits_fn(cfg, params, whole_activation(x, carry),
                     x_axes=fx), cache
