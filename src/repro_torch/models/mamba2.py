"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) decoder (PyTorch
port of ``repro/models/mamba2.py``).

Chunked SSD, as in the JAX package:

  * split the sequence into chunks of length ``Q``;
  * intra-chunk: a quadratic attention-like term with the decay mask
    ``L[i, j] = exp(segsum(a))``;
  * inter-chunk: a per-chunk state ``(H, P, N)`` carried by the recurrence
    ``h_c = decay_c * h_{c-1} + states_c``.  The JAX package runs it as
    ``jax.lax.associative_scan`` (a tree of combines); the port loops over
    the chunks in order, so its float32 sums associate differently.

The decode step is the O(1) recurrence ``h = exp(a dt) h + dt B x`` with
output ``C^T h``: the SSM state takes the KV cache's place and does not
grow with the sequence.  The conv and the SSD run in float32 and round to
bf16 where the JAX package casts; their float32 products never run in
TF32, whatever the caller set (:func:`ieee_f32`).

``A_log``, ``dt_bias``, ``D_skip`` and the conv weights stay float32; a
compression spec must carve them out ahead of any catch-all rule
(``core.spec``: a matching rule overrides the keep-fp32 predicate).

Under sharded-compute hints each rank of the model axis computes a block
of the SSD heads (:func:`_mamba_block`); the layer carry rests as the JAX
package's ``constrain_activation`` decides, as in ``dense``, a norm's scale
on a carry split along S enters through ``split=``, and the train loss is
the global batch's (:func:`dense.xent`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.distributed.ctx import block_index, sharded_compute
from . import dense
from .layers import (Schema, Spec, _matmul, cache_rows, carry_features,
                     carry_seq, carry_spec, checkpointed, constrain_carry,
                     gather_cache_rows, gather_weight, init_params,
                     last_position, layer_slice, local_weight, matmul,
                     rms_norm, silu, softplus, split_use, stacked_layers,
                     take_rows, tied_logits, whole_activation)

f32 = torch.float32


@contextlib.contextmanager
def ieee_f32() -> Iterator[None]:
    """Float32 products in full precision inside the block: TF32 would round
    the SSD's operands to 10 mantissa bits on the card.  Restores the
    caller's setting on exit."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def mamba_schema(prefix: str, L: int, D: int, ssm: SSMConfig,
                 resid: float) -> Schema:
    """One stacked Mamba-2 block's parameters: the projection split into a
    ``[z | x]`` tensor and a small ``[B | C | dt]`` one, and the depthwise
    conv split the same way (the JAX package's layout, name for name)."""
    Din = ssm.d_inner(D)
    H = ssm.n_heads(D)
    N = ssm.d_state
    G = 1                            # n_groups = 1 for B / C
    K = ssm.d_conv
    return {
        f"{prefix}/norm": Spec((L, D), ("layers", None), "ones", f32),
        f"{prefix}/in_zx": Spec((L, D, 2 * Din), ("layers", "embed", "mlp")),
        f"{prefix}/in_bcdt": Spec((L, D, 2 * G * N + H),
                                  ("layers", "embed", None)),
        f"{prefix}/conv_x_w": Spec((L, K, Din), ("layers", None, "mlp"), 0.02,
                                   f32),
        f"{prefix}/conv_x_b": Spec((L, Din), ("layers", "mlp"), "zeros", f32),
        f"{prefix}/conv_bc_w": Spec((L, K, 2 * G * N), ("layers", None, None),
                                    0.02, f32),
        f"{prefix}/conv_bc_b": Spec((L, 2 * G * N), ("layers", None), "zeros",
                                    f32),
        f"{prefix}/A_log": Spec((L, H), ("layers", "heads"), "a_log", f32),
        f"{prefix}/dt_bias": Spec((L, H), ("layers", "heads"), "dt_bias",
                                  f32),
        f"{prefix}/D_skip": Spec((L, H), ("layers", "heads"), "ones", f32),
        f"{prefix}/ssm_norm": Spec((L, Din), ("layers", "mlp"), "ones", f32),
        f"{prefix}/out_proj": Spec((L, Din, D), ("layers", "mlp", "embed"),
                                   resid),
    }


def schema(cfg: ArchConfig) -> Schema:
    L, D = cfg.n_layers, cfg.d_model
    Vp = cfg.padded_vocab()
    resid = 0.02 / (2 * L) ** 0.5
    s: Schema = {
        "embed": Spec((Vp, D), ("vocab", "embed"), 0.02),
        "final_norm": Spec((D,), (None,), "ones", f32),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = Spec((D, Vp), ("embed", "vocab"), 0.02)
    s.update(mamba_schema("layers", L, D, cfg.ssm, resid))
    return s


def init(cfg: ArchConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters on ``device`` (``cuda`` unless the caller
    names the CPU)."""
    from repro_torch import device as _device
    return init_params(schema(cfg), seed, _device.resolve(device))


def _layer(params: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l`` of the stacked ``layers/*`` parameters (the slice the
    JAX package's ``lax.scan`` hands each iteration)."""
    return {k.split("/", 1)[1]: layer_slice(v, l)
            for k, v in params.items() if k.startswith("layers/")}


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  xBC: (B, S, C); w: (K, C); returns (y,
    new_state): ``K`` shifted adds in float32, SiLU, rounded to xBC's
    dtype; ``new_state`` is the last K-1 inputs (B, K-1, C), the
    streaming state of the next call."""
    B, S, C = xBC.shape
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((B, K - 1, C), dtype=xBC.dtype, device=xBC.device)
    else:
        pad = state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                   # (B, S+K-1, C)
    y = torch.zeros((B, S, C), dtype=f32, device=xBC.device)
    for k in range(K):
        y = y + xp[:, k: k + S, :].float() * w[k].float()
    y = silu(y + b.float())
    return y.to(xBC.dtype), xp[:, S:, :]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: ``out[..., i, j] = sum a[..., j+1..i]``, -inf for
    j > i (so that ``exp`` gives 0 there)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, d, torch.tensor(float("-inf"), dtype=d.dtype,
                                             device=a.device))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P) value-like input; dt: (B, S, H) softplus'd step (> 0);
    A: (H,) negative decay rate; Bm, Cm: (B, S, N) input and output
    projections (one group, broadcast over heads); h0: (B, H, P, N)
    initial state, None for zeros.

    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) float32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        # pad with dt = 0 positions: decay exp(0) = 1 and input x * dt = 0,
        # so the padded tail perturbs neither the carried state nor the
        # first S outputs
        pad = chunk - S % chunk
        y, h = ssd_chunked(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(dt, (0, 0, 0, pad)), A,
            torch.nn.functional.pad(Bm, (0, 0, 0, pad)),
            torch.nn.functional.pad(Cm, (0, 0, 0, pad)), chunk, h0=h0)
        return y[:, :S], h
    nc = S // chunk
    with ieee_f32():
        xb = x.reshape(B, nc, chunk, H, P).float()
        dtb = dt.reshape(B, nc, chunk, H).float()
        Bb = Bm.reshape(B, nc, chunk, N).float()
        Cb = Cm.reshape(B, nc, chunk, N).float()

        a = dtb * A[None, None, None, :]                 # (B,nc,Q,H) log-decay
        a_hq = torch.movedim(a, -1, -2)                  # (B,nc,H,Q)

        # intra-chunk (quadratic)
        Lmat = torch.exp(_segsum(a_hq))                  # (B,nc,H,Q,Q)
        scores = torch.einsum("bcin,bcjn->bcij", Cb, Bb)  # (B,nc,Q,Q)
        M = scores[:, :, None] * Lmat                    # (B,nc,H,Q,Q)
        xdt = xb * dtb[..., None]                        # (B,nc,Q,H,P)
        y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xdt)

        # chunk states
        a_cum = torch.cumsum(a_hq, dim=-1)               # (B,nc,H,Q)
        a_tot = a_cum[..., -1]                           # (B,nc,H)
        decay_in = torch.exp(a_tot[..., None] - a_cum)   # decay from t to end
        states = torch.einsum("bcjn,bchj,bcjhp->bchpn", Bb, decay_in, xdt)

        # inter-chunk recurrence, chunk by chunk: the state after chunk c
        # from zeros, and the decay accumulated since the start (h0's share
        # is added after, as the JAX package adds it to its scan)
        decay_chunk = torch.exp(a_tot)                   # (B,nc,H)
        h_after, d_all = [states[:, 0]], [decay_chunk[:, 0]]
        for c in range(1, nc):
            dc = decay_chunk[:, c]
            h_after.append(states[:, c] + h_after[-1] * dc[..., None, None])
            d_all.append(d_all[-1] * dc)
        h_after = torch.stack(h_after, dim=1)            # (B,nc,H,P,N)
        d_all = torch.stack(d_all, dim=1)                # (B,nc,H)
        if h0 is not None:
            h_after = h_after + d_all[..., None, None] * h0[:, None].float()
        # the state entering chunk c
        first = (h0[:, None].float() if h0 is not None
                 else torch.zeros_like(h_after[:, :1]))
        h_in = torch.cat([first, h_after[:, :-1]], dim=1)

        # inter-chunk output: y_off[t] = C_t . exp(a_cum[t]) h_in
        decay_out = torch.exp(a_cum)                     # (B,nc,H,Q)
        y_off = torch.einsum("bcin,bchpn,bchi->bcihp", Cb, h_in, decay_out)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), h_after[:, -1]


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor):
    """The O(1) decode recurrence.  x: (B, H, P); dt: (B, H); Bm, Cm:
    (B, N); h: (B, H, P, N).  Returns (y (B, H, P) in x's dtype, the new
    float32 state)."""
    xf, dtf, Bf, Cf, hf = (t.float() for t in (x, dt, Bm, Cm, h))
    with ieee_f32():
        da = torch.exp(dtf * A[None])                    # (B,H)
        h_new = hf * da[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xf * dtf[..., None], Bf)
        y = torch.einsum("bhpn,bn->bhp", h_new, Cf)
    return y.to(x.dtype), h_new


_DIRECT = ("conv_x_w", "conv_x_b", "conv_bc_w", "conv_bc_b", "dt_bias",
           "A_log", "D_skip")


def _direct(w: Any) -> torch.Tensor:
    """A parameter the block reads as a tensor: whole (gathered at use on
    an exact-TP mesh), or this rank's block under sharded compute (the
    depthwise conv's and the heads' parameters rest split with the inner
    channels).  One whole over the model axis (``conv_bc``, shared by
    every head) enters the rank's heads through :func:`layers.split_use`:
    in training its gradient is summed over that axis."""
    if sharded_compute() is None:
        return gather_weight(w)
    return local_weight(split_use(w))[0]


def _head_offset(A_log: Any) -> int:
    """The first SSD head of this rank's block (0 unless sharded compute
    splits the heads over the model axis)."""
    h = sharded_compute()
    if h is None:
        return 0
    wl, spec = local_weight(A_log)
    return block_index(h.mesh, spec[-1])[1] * wl.shape[-1]


def zx_blocks(w: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """``in_zx`` (..., 2 Din) with its columns reordered so that each of
    ``n_blocks`` contiguous blocks is ``[z_r | x_r]``: block ``r`` of z's
    and of x's inner channels, the heads a rank of the model axis computes
    (the plain cut of ``[z | x]`` would give the first ranks z only).  Any
    last-dim packing works: both halves are cut alike."""
    if n_blocks == 1:
        return w
    n = w.shape[-1] // (2 * n_blocks)
    return w.unflatten(-1, (2, n_blocks, n)).transpose(-3, -2).flatten(-3)


def zx_unblocks(w: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The inverse of :func:`zx_blocks`: ``in_zx`` in one device's column
    order ``[z | x]`` from its ``n_blocks`` blocks ``[z_r | x_r]``."""
    if n_blocks == 1:
        return w
    n = w.shape[-1] // (2 * n_blocks)
    return w.unflatten(-1, (n_blocks, 2, n)).transpose(-3, -2).flatten(-3)


def _mamba_block(cfg: ArchConfig, lp: Dict[str, Any], x: torch.Tensor, *,
                 conv_state=None, ssm_state=None, chunk: Optional[int] = None,
                 carry: Optional[tuple] = None):
    """One mamba2 block.  Returns (out, ((new_conv_x, new_conv_bc),
    new_ssm_state)); ``conv_state`` is the pair of the split projections'
    conv states.

    Under sharded-compute hints ``x`` is the layer carry of layout
    ``carry`` (:func:`layers.carry_spec`): the block gathers its S (the
    scan needs the whole sequence), and each rank computes its block of
    the SSD heads — its ``[z_r | x_r]`` columns of ``in_zx`` (re-blocked at
    placement, :func:`zx_blocks`), its channels of the depthwise ``conv_x``,
    its heads' columns of ``dt`` (``in_bcdt`` and ``conv_bc`` stay whole:
    B and C are shared by every head, so their gradients sum over the
    model axis) — and its block of the states.  The pre-block norm takes
    ``split=`` the carry's S axes; the gated norm sums its squares over
    the ranks of the inner channels;
    ``out_proj`` is row-parallel, handing back the carry's layout.  In the
    weight-stationary decode the states hold a block of the rows
    (:func:`layers.cache_rows`)."""
    ssm = cfg.ssm
    H, P, N, G = ssm.n_heads(cfg.d_model), ssm.head_dim, ssm.d_state, 1
    chunk = chunk or ssm.chunk

    fx = carry_features(carry)
    h0 = _head_offset(lp["A_log"])
    lp = dict(lp, **{k: _direct(lp[k]) for k in _DIRECT})
    Hl = lp["A_log"].shape[-1]
    h = whole_activation(rms_norm(x, lp["norm"], x_axes=fx,
                                  split=carry_seq(carry)), carry)
    zx, zx_axes = _matmul(h, lp["in_zx"], x_axes=fx)
    Din = zx.shape[-1] // 2
    assert Din == Hl * P, (tuple(zx.shape), Hl, P)
    z, xs = torch.split(zx, [Din, Din], dim=-1)
    BC, dt = torch.split(matmul(h, lp["in_bcdt"], x_axes=fx),
                         [2 * G * N, H], dim=-1)
    if Hl != H:
        dt = dt[..., h0:h0 + Hl]
    z, xs, BC, dt = (cache_rows(t) for t in (z, xs, BC, dt))
    B, S = xs.shape[:2]
    cs_x, cs_bc = conv_state if conv_state is not None else (None, None)
    xs, new_conv_x = _causal_conv(xs, lp["conv_x_w"], lp["conv_x_b"], cs_x)
    BC, new_conv_bc = _causal_conv(BC, lp["conv_bc_w"], lp["conv_bc_b"],
                                   cs_bc)
    Bm, Cm = torch.split(BC, [G * N, G * N], dim=-1)
    dt = softplus(dt.float() + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())                  # (H,) negative

    xh = xs.reshape(B, S, Hl, P)
    if S == 1 and ssm_state is not None:
        y, h_new = ssd_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0],
                            ssm_state)
        y = y[:, None]
    else:
        y, h_new = ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0=ssm_state)
    y = y + xh * lp["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, Din)
    y = rms_norm(y * silu(z.float()).to(y.dtype), lp["ssm_norm"],
                 x_axes=zx_axes or None)
    out = matmul(gather_cache_rows(y), lp["out_proj"],
                 x_axes=zx_axes or None, carry=carry)
    return out, ((new_conv_x, new_conv_bc), h_new)


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            remat: bool = False, collect_cache: bool = False,
            chunk: Optional[int] = None):
    """Full-sequence forward.  Returns (hidden, [((conv_x, conv_bc), ssm)
    per layer] | None).  ``remat`` recomputes each layer in the backward.
    Under sharded-compute hints the carry rests as the JAX package's
    ``constrain_activation`` decides, at its places (after the embedding,
    after each layer)."""
    S = tokens.shape[1]
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    x = constrain_carry(take_rows(params["embed"], tokens, carry), S,
                        cfg.d_model)
    block = checkpointed(
        lambda lp, x: _mamba_block(cfg, lp, x, chunk=chunk, carry=carry),
        remat)
    caches = []
    for lp in stacked_layers(params, "layers", cfg.n_layers):
        out, st = block(lp, x)
        x = constrain_carry(x + out, S, cfg.d_model)
        if collect_cache:
            caches.append(st)
    x = rms_norm(x, params["final_norm"], x_axes=carry_features(carry),
                 split=carry_seq(carry))
    return x, (caches if collect_cache else None)


def logits_fn(cfg: ArchConfig, params, x: torch.Tensor, *,
              x_axes: Any = None) -> torch.Tensor:
    """Logits over the padded vocabulary, gathered under sharded compute
    (``x_axes``: the axes ``x``'s features are split over)."""
    if cfg.tie_embeddings:
        return tied_logits(x, params["embed"], x_axes=x_axes)
    return matmul(x, params["lm_head"], gather=True, x_axes=x_axes)


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0, chunk: Optional[int] = None) -> torch.Tensor:
    """Next-token cross-entropy (``q_block`` is accepted, as in the JAX
    package, and unused: the family has no attention).  Under
    sharded-compute hints ``batch`` is this rank's rows and the loss the
    mean over every token of the global batch (:func:`dense.xent`)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    x, _ = forward(cfg, params, inp, remat=remat, chunk=chunk)
    return dense.xent(cfg, params, x, labels)


# ------------------------------------------------------------------------- serving

def cache_specs(cfg: ArchConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of the state-cache leaves."""
    return {
        "conv_x": ("layers", "batch", None, "mlp"),
        "conv_bc": ("layers", "batch", None, None),
        "ssm": ("layers", "batch", "heads", None, None),
    }


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """The state cache: bf16 conv states (the last K-1 inputs of each split
    projection) and the float32 SSM state, a layer and row each.  O(1) in
    sequence length: ``max_len`` is taken for the API's sake."""
    ssm = cfg.ssm
    L, D = cfg.n_layers, cfg.d_model
    Din = ssm.d_inner(D)
    H, P, N, G = ssm.n_heads(D), ssm.head_dim, ssm.d_state, 1
    return {
        "conv_x": torch.zeros((L, batch, ssm.d_conv - 1, Din), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((L, batch, ssm.d_conv - 1, 2 * G * N),
                               dtype=dtype, device=device),
        "ssm": torch.zeros((L, batch, H, P, N), dtype=f32, device=device),
    }


def _write_state(cache: Dict[str, torch.Tensor], l: int, st) -> None:
    """Layer ``l``'s new ((conv_x, conv_bc), ssm) into the stacked cache,
    in place."""
    (cx, cbc), hs = st
    cache["conv_x"][l] = cx
    cache["conv_bc"][l] = cbc
    cache["ssm"][l] = hs


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, chunk: Optional[int] = None,
            q_block: int = 0):
    """Run the prompt; return (last-position logits, the state cache, each
    leaf this rank's block under sharded compute); ``max_len`` and
    ``q_block`` are accepted, as in the JAX package, and unused."""
    x, caches = forward(cfg, params, tokens, collect_cache=True, chunk=chunk)
    cache = {"conv_x": torch.stack([cx for (cx, _), _ in caches]),
             "conv_bc": torch.stack([cbc for (_, cbc), _ in caches]),
             "ssm": torch.stack([hs for _, hs in caches])}
    carry = carry_spec(tokens.shape[0], tokens.shape[1], cfg.d_model)
    return logits_fn(cfg, params, last_position(x, carry),
                     x_axes=carry_features(carry)), cache


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One generation step: each layer's conv and SSM state advance by one
    token, in place (each rank its block under sharded compute).  ``pos``
    is taken for the API's sake (the state carries the position)."""
    D = cfg.d_model
    carry = carry_spec(token.shape[0], 1, D)
    x = constrain_carry(take_rows(params["embed"], token, carry), 1, D)
    for l in range(cfg.n_layers):
        out, st = _mamba_block(
            cfg, _layer(params, l), x,
            conv_state=(cache["conv_x"][l], cache["conv_bc"][l]),
            ssm_state=cache["ssm"][l], carry=carry)
        x = constrain_carry(x + out, 1, D)
        _write_state(cache, l, st)
    fx = carry_features(carry)
    x = rms_norm(x, params["final_norm"], x_axes=fx)
    return logits_fn(cfg, params, whole_activation(x, carry),
                     x_axes=fx), cache
