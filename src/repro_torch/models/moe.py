"""Mixture-of-Experts feed-forward and the dbrx / qwen2-moe decoder family
(PyTorch port of ``repro/models/moe.py``).

Dispatch is GShard's, sort-free, as in the JAX package: the router picks
each token's top-k experts, every (token, choice) pair gets a slot in an
``(E, C, D)`` capacity buffer from a one-hot running count of earlier
choices of the same expert, the tokens are gathered into their slots, the
experts run as three batched products, and the outputs are gathered back
and summed one choice at a time.  A choice past its expert's capacity ``C``
is dropped (``capacity_factor`` sets the drop rate).

Expert parallelism (the JAX package's ``shard_map`` branch): with an
:class:`EPContext` installed, every rank of the mesh's model axis holds
``E_loc = E / |model|`` experts (this rank's block of each expert stack)
and its own tokens, runs the dispatch for its experts only, and the
partial outputs are summed over the model axis (and over the data axes in
the weight-stationary layout, whose expert FFN hidden dim shards over
them).  The sum is a float reduction: EP agrees with one device to a
tolerance, not bit for bit.  Without a context the whole expert set is
local.

Under exact-TP serving hints (``ServeSteps`` on a mesh) whose batch rows
are split over data axes, the feed-forward gathers the rows of the whole
batch first: the capacity is shared across the batch, so only the whole
batch routes and drops tokens exactly as one device does.  Under
sharded-compute hints (the production cells) it is the JAX package's EP
``shard_map`` body: each data rank routes its own rows and sizes the
capacity by them (``_capacity(B_loc * S, ...)``), so a choice one device
keeps may be dropped there, as in the JAX package; the rank runs its
experts under the installed :class:`EPContext` and hands back its block of
the carry.  The load-balance aux sums its statistics over the data axes:
it is the whole batch's, as under GSPMD.  The shared experts are column- /
row-parallel matmuls on the carry as the dense family's feed-forward is.

Attention, caches, the per-layer weight slots of compressed-resident
serving and the paged block pool are the dense family's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import (block_index, get_hints,
                                         local_block, set_hints,
                                         sharded_compute)
from . import dense
from .layers import (Schema, Spec, activation_block, carry_features,
                     carry_seq, carry_spec, checkpointed, constrain_carry,
                     deq, init_params, last_position, local_weight, matmul,
                     rms_norm, silu, softmax, stacked_layers, summed_axes,
                     swiglu, top_k, whole_activation)

# ----------------------------------------------------------------- EP mesh context


@dataclasses.dataclass(frozen=True)
class EPContext:
    """Installed by the distribution layer; models stay mesh-agnostic
    without it.  ``mesh`` is this rank's
    :class:`~repro_torch.launch.mesh.Mesh`; ``batch_sharded=False`` is the
    weight-stationary layout (every rank of the data axes holds the same
    tokens and a block of each expert's hidden dim)."""
    mesh: Any
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)
    batch_sharded: bool = True


_EP_CTX: list = [None]


def set_ep_context(ctx: Optional[EPContext]) -> None:
    _EP_CTX[0] = ctx


def get_ep_context() -> Optional[EPContext]:
    return _EP_CTX[0]


def ep_weight_specs(ctx: EPContext) -> Dict[str, Tuple]:
    """The specs this rank's expert stacks ``(E, D, F)`` / ``(E, F, D)``
    are cut by under ``ctx``: experts over the model axis and, in the
    weight-stationary layout, the hidden dim over the data axes."""
    f = tuple(ctx.data_axes) if not ctx.batch_sharded and ctx.data_axes \
        else None
    return {"w_gate": (ctx.model_axis, None, f),
            "w_up": (ctx.model_axis, None, f),
            "w_down": (ctx.model_axis, f, None)}

# ------------------------------------------------------------------------ dispatch


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(-(-n_tokens * top_k * cf // n_experts))  # ceil
    return max(4, -(-c // 4) * 4)                    # multiple of 4, >= 4


def _assign_slots(eid: torch.Tensor, e0: int, E_loc: int,
                  C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity slots of the (N*K,) flattened expert choices, all K choices
    at once so capacity is shared: a choice of local expert ``e`` takes
    slot ``e * C + (its earlier choices of e)``.  Returns (keep, slot): a
    choice routed elsewhere or past capacity gets the trash slot
    ``E_loc * C``."""
    local = (eid >= e0) & (eid < e0 + E_loc)
    el = torch.where(local, eid - e0, E_loc)                # E_loc = overflow
    oh = torch.nn.functional.one_hot(el, E_loc + 1)         # (N*K, E_loc+1)
    # the exclusive running count in the choice's own column (the
    # reference's max over ``where=oh > 0``: one column is set a row)
    pos = (torch.cumsum(oh, 0) - oh).gather(1, el[:, None])[:, 0]
    pos = torch.where(local, pos, C)
    keep = local & (pos < C)
    return keep, torch.where(keep, el * C + pos, E_loc * C)


def _dispatch_compute(x2d: torch.Tensor, gates: torch.Tensor,
                      idx: torch.Tensor, w_gate: Any, w_up: Any, w_down: Any,
                      e0: int, E_loc: int, C: int) -> torch.Tensor:
    """Local-expert dispatch + compute.  x2d: (N, D); gates / idx: (N, K).

    Returns the (N, D) output of the experts ``[e0, e0 + E_loc)``: zeros for
    tokens routed elsewhere or past their expert's capacity.
    """
    N, D = x2d.shape
    K = idx.shape[-1]
    dev = x2d.device
    keep, slot = _assign_slots(idx.reshape(-1), e0, E_loc, C)

    # several dropped choices write the trash slot (index_put_ keeps any one
    # of them; the row is discarded); a live slot is written once
    n_slots = E_loc * C + 1
    writes = torch.zeros(n_slots, dtype=torch.int64, device=dev).index_add_(
        0, slot, torch.ones_like(slot))
    torch._assert_async((writes[:-1] <= 1).all())
    tok = torch.arange(N * K, device=dev) // K
    tok_for_slot = torch.zeros(n_slots, dtype=torch.int64, device=dev)
    tok_for_slot[slot] = tok
    valid = torch.zeros(n_slots, dtype=x2d.dtype, device=dev)
    valid[slot] = 1.0

    buf = x2d[tok_for_slot[:-1]]                            # (E_loc*C, D)
    buf = (buf * valid[:-1, None]).reshape(E_loc, C, D)

    h = torch.einsum("ecd,edf->ecf", buf, deq(w_gate, x2d.dtype))
    u = torch.einsum("ecd,edf->ecf", buf, deq(w_up, x2d.dtype))
    y = torch.einsum("ecf,efd->ecd", silu(h) * u, deq(w_down, x2d.dtype))
    y_flat = torch.cat([y.reshape(E_loc * C, D),
                        torch.zeros((1, D), dtype=y.dtype, device=dev)])

    # combine one top-k choice at a time, in the activation dtype (one
    # weighted sum over k would round differently)
    slot_nk = slot.reshape(N, K)
    keep_nk = keep.reshape(N, K)
    out = torch.zeros((N, D), dtype=x2d.dtype, device=dev)
    for k in range(K):
        contrib = y_flat[slot_nk[:, k]]
        g = (gates[:, k] * keep_nk[:, k]).to(x2d.dtype)
        out = out + contrib * g[:, None]
    return out


def route(x: torch.Tensor, router: Any,
          K: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: float32 probabilities over the experts, and each token's
    top-``K`` choices with their gates renormalised to sum to one.
    Returns (probs, gates, idx)."""
    logits = matmul(x, router, gather=True).float()         # (B, S, E)
    probs = softmax(logits)
    gates, idx = top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _ep_body(x: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
             w_gate, w_up, w_down, *, mesh, model_axis: str, E_loc: int,
             C: int, psum_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """This rank's experts ``[e0, e0 + E_loc)`` on its tokens, summed over
    the model axis and ``psum_axes``."""
    B, S, D = x.shape
    e0 = mesh.coord[model_axis] * E_loc
    out = _dispatch_compute(x.reshape(B * S, D), gates.reshape(B * S, -1),
                            idx.reshape(B * S, -1), w_gate, w_up, w_down,
                            e0, E_loc, C)
    axes = (model_axis,) + tuple(psum_axes)
    return collectives.all_reduce_sum(mesh, out.reshape(B, S, D), axes,
                                      grad_axes=summed_axes(axes))


def _whole_batch(x: torch.Tensor, wts: Dict[str, Any], mcfg: MoEConfig,
                 E: int, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_mlp` of a batch whose rows are split over ``h``'s batch
    axes: gather the rows (exact), run the whole batch, keep this rank's
    block of the output."""
    full = collectives.all_gather(h.mesh, x, 0, h.batch_axes, grad="cut")
    set_hints(dataclasses.replace(h, batch_axes=()))
    try:
        y, aux = moe_mlp(full, wts, mcfg, E)
    finally:
        set_hints(h)
    entry = h.batch_axes if len(h.batch_axes) > 1 else h.batch_axes[0]
    return local_block(y, (entry,), h.mesh), aux


def _sharded_moe(x: torch.Tensor, wts: Dict[str, Any], mcfg: MoEConfig,
                 E: int, h, carry: Optional[tuple]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_mlp` under sharded-compute hints, the JAX package's EP
    ``shard_map`` body.  ``x`` is this rank's rows with every position and
    feature (the caller gathers them).  The rank routes only its rows and
    sizes the capacity by them, as each data rank of the JAX package does
    (in the weight-stationary decode every data rank holds the whole
    batch, so that is the whole batch); it runs its experts under the
    installed EP context, summed over the model axis, and keeps its block
    of the carry's layout ``carry``.  The aux's statistics are summed over
    the batch axes (:func:`_routed`).  The shared experts compute on ``x``
    and hand back that block themselves (row-parallel
    ``shared_w_down``)."""
    assert get_ep_context() is not None, \
        "sharded compute of the MoE family needs an EPContext installed"
    y, aux = _routed(x, wts, mcfg, E, stat_axes=h.batch_axes)
    y = activation_block(y, carry)
    if mcfg.shared_experts:
        y = y + swiglu(x, wts["shared_w_gate"], wts["shared_w_up"],
                       wts["shared_w_down"], carry=carry)
    return y, aux


def moe_mlp(x: torch.Tensor, wts: Dict[str, Any], mcfg: MoEConfig,
            n_experts_padded: int, carry: Optional[tuple] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward.  Returns (y, load_balance_aux).  Under
    sharded-compute hints ``y`` takes the layer carry's layout ``carry``
    (``layers.carry_spec``)."""
    E = n_experts_padded
    h = get_hints()
    if h is not None and h.exact_tp and h.batch_axes:
        return _whole_batch(x, wts, mcfg, E, h)
    if h is not None and not h.exact_tp:
        return _sharded_moe(x, wts, mcfg, E, h, carry)
    y, aux = _routed(x, wts, mcfg, E)
    if mcfg.shared_experts:
        y = y + swiglu(x, wts["shared_w_gate"], wts["shared_w_up"],
                       wts["shared_w_down"])
    return y, aux


def _routed(x: torch.Tensor, wts: Dict[str, Any], mcfg: MoEConfig,
            E: int, stat_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output and the load-balance aux.  With
    ``stat_axes`` (sharded compute: the axes this rank's rows are one block
    of) the aux's mean probabilities and choice counts are summed over
    them, so it is the whole batch's."""
    B, S, D = x.shape
    K = mcfg.top_k
    probs, gates, idx = route(x, wts["router"], K)

    # Switch-style load-balance aux: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))                             # (E,)
    flat = idx.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x.device))
    n = 1
    if stat_axes:
        mesh = get_hints().mesh
        n = block_index(mesh, stat_axes)[0]
        # equal blocks of rows: the whole batch's mean is the sum of theirs
        # over n (the rank losses are summed over these axes: so is the
        # gradient)
        me, counts = collectives.all_reduce_sum(
            mesh, torch.stack([me / n, counts]), stat_axes,
            grad_axes=stat_axes)
    ce = counts / (B * S * K * n)
    aux = E * torch.sum(me * ce)

    ctx = get_ep_context()
    C = _capacity(B * S, K, E, mcfg.capacity_factor)
    if ctx is None:
        y = _dispatch_compute(
            x.reshape(B * S, D), gates.reshape(-1, K), idx.reshape(-1, K),
            wts["w_gate"], wts["w_up"], wts["w_down"], 0, E,
            C).reshape(B, S, D)
    else:
        # x holds this rank's tokens already: with batch_sharded its block
        # of the batch (the reference's B // |data|), else the whole batch,
        # whose experts' hidden dim then rides the data axes
        mesh = ctx.mesh
        msize = mesh.shape[ctx.model_axis]
        assert E % msize == 0, (E, msize)
        f_axes = tuple(ctx.data_axes) if not ctx.batch_sharded else ()
        # every model rank routes alike, then runs its own experts: the
        # gates' gradient is summed over the model axis as they enter
        gates = collectives.enter_split(mesh, gates, (ctx.model_axis,))
        y = _ep_body(x, gates, idx,
                     *(_hidden_block(wts[k], f_dim, f_axes, mesh, x.dtype)
                       for k, f_dim in (("w_gate", 2), ("w_up", 2),
                                        ("w_down", 1))),
                     mesh=mesh, model_axis=ctx.model_axis, E_loc=E // msize,
                     C=C, psum_axes=f_axes)
    return y, aux


def _hidden_block(w: Any, f_dim: int, f_axes: Tuple[str, ...], mesh,
                  dtype) -> Any:
    """This rank's block of an expert stack for :func:`_ep_body`: ``w`` as
    it rests, or, when the partial outputs are summed over ``f_axes`` (the
    rows whole on every data rank), dequantized with its hidden dim
    ``f_dim`` cut to this rank's block over them where it rests whole (the
    JAX package's ``shard_map`` in-spec reshards it so)."""
    if not f_axes or sharded_compute() is None:
        return w            # an EP context alone: cut by ep_weight_specs
    wl, spec = local_weight(w)
    wd = deq(wl, dtype)
    if spec[f_dim] is None:
        wd = collectives.cut(mesh, wd, f_dim, f_axes)
    return wd


# ------------------------------------------------------- decoder family (dbrx/qwen2)

def _padded_experts(cfg: ArchConfig, multiple: int = 16) -> int:
    return cfg.moe.padded_experts(multiple)


def moe_block_schema(prefix: str, L: int, D: int, F: int, mcfg: MoEConfig,
                     Ep: int, resid: float) -> Schema:
    s: Schema = {
        f"{prefix}/router": Spec((L, D, Ep), ("layers", "embed", "expert"),
                                 0.02, torch.float32),
        f"{prefix}/w_gate": Spec((L, Ep, D, F), ("layers", "expert",
                                                 "expert_embed",
                                                 "expert_mlp")),
        f"{prefix}/w_up": Spec((L, Ep, D, F), ("layers", "expert",
                                               "expert_embed", "expert_mlp")),
        f"{prefix}/w_down": Spec((L, Ep, F, D), ("layers", "expert",
                                                 "expert_mlp",
                                                 "expert_embed"), resid),
    }
    if mcfg.shared_experts:
        Fs = F * mcfg.shared_experts
        s[f"{prefix}/shared_w_gate"] = Spec((L, D, Fs),
                                            ("layers", "embed", "mlp"))
        s[f"{prefix}/shared_w_up"] = Spec((L, D, Fs),
                                          ("layers", "embed", "mlp"))
        s[f"{prefix}/shared_w_down"] = Spec((L, Fs, D),
                                            ("layers", "mlp", "embed"), resid)
    return s


def schema(cfg: ArchConfig) -> Schema:
    """dbrx / qwen2-moe: dense attention + MoE feed-forward every layer."""
    L, D = cfg.n_layers, cfg.d_model
    Ep = _padded_experts(cfg)
    resid = 0.02 / (2 * L) ** 0.5
    s = dense.schema(cfg)
    for k in ["layers/w_gate", "layers/w_up", "layers/w_down"]:
        del s[k]
    s.update(moe_block_schema("layers/moe", L, D, cfg.d_ff, cfg.moe, Ep,
                              resid))
    return s


def init(cfg: ArchConfig, seed: int = 0,
         device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    """Seeded random parameters on ``device`` (``cuda`` unless the caller
    names the CPU)."""
    from repro_torch import device as _device
    return init_params(schema(cfg), seed, _device.resolve(device))


def _moe_wts(lp: Dict[str, Any]) -> Dict[str, Any]:
    return {k.split("/", 1)[1]: v for k, v in lp.items()
            if k.startswith("moe/")}


def _block(cfg: ArchConfig, lp, x, *, positions, cache=None, pos=0,
           q_block: int = 0, keep: Optional[Tuple[int, int]] = None):
    carry = carry_spec(x.shape[0], positions.shape[-1], cfg.d_model)
    attn_out, kv = dense._attn(cfg, lp, x, positions=positions, cache=cache,
                               pos=pos, q_block=q_block, keep=keep,
                               carry=carry)
    x = x + attn_out
    h = whole_activation(rms_norm(x, lp["mlp_norm"],
                                  x_axes=carry_features(carry),
                                  split=carry_seq(carry)),
                         carry, features=True)
    y, aux = moe_mlp(h, _moe_wts(lp), cfg.moe, _padded_experts(cfg), carry)
    return x + y, kv, aux


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            remat: bool = False, collect_cache: bool = False,
            q_block: int = 0, cache_len: Optional[int] = None):
    """Full-sequence forward.  Returns (hidden, [(k, v) per layer] | None,
    the load-balance aux averaged over the layers).  ``remat`` recomputes
    each layer in the backward; the replay routes the same tokens to the
    same slots, since it sees the same inputs.  ``cache_len`` as in
    :func:`dense.forward`."""
    S = tokens.shape[1]
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    x = dense._embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    aux_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
    keep = dense._kept_rows(S, cache_len) if collect_cache else None
    block = checkpointed(
        lambda lp, x: _block(cfg, lp, x, positions=positions,
                             q_block=q_block, keep=keep), remat)
    caches = []
    for lp in stacked_layers(params, "layers", cfg.n_layers):
        x, kv, aux = block(lp, x)
        x = constrain_carry(x, S, cfg.d_model)
        aux_sum = aux_sum + aux
        if collect_cache:
            caches.append(kv)
    x = rms_norm(x, params["final_norm"], x_axes=carry_features(carry),
                 split=carry_seq(carry))
    return x, (caches if collect_cache else None), aux_sum / cfg.n_layers


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            q_block: int = 0, aux_coef: float = 0.01) -> torch.Tensor:
    """Next-token cross-entropy plus ``aux_coef`` times the load-balance
    aux (under sharded-compute hints both the global batch's:
    :func:`dense.xent`)."""
    tokens = batch["tokens"]
    inp, labels = tokens[:, :-1], tokens[:, 1:]
    x, _, aux = forward(cfg, params, inp, remat=remat, q_block=q_block)
    return dense.xent(cfg, params, x, labels) + aux_coef * aux


init_cache = dense.init_cache
cache_specs = dense.cache_specs


def prefill(cfg: ArchConfig, params, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, q_block: int = 0):
    """Run the prompt; return (last-position logits, cache padded to
    max_len)."""
    S = tokens.shape[1]
    x, caches, _ = forward(cfg, params, tokens, collect_cache=True,
                           q_block=q_block, cache_len=max_len or S)
    cache = dense._prefill_cache(cfg, caches, max_len or S, S)
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    return dense.logits_fn(cfg, params, last_position(x, carry),
                           x_axes=carry_features(carry)), cache


def _kv(cache: Dict[str, torch.Tensor], l: int) -> Tuple:
    """Layer ``l``'s bf16 (k, v) of a slot cache (views: writes land in
    the cache).  The MoE family has no int8 cache, as in the JAX package."""
    return cache["k"][l], cache["v"][l]


def decode_step(cfg: ArchConfig, params, token: torch.Tensor, cache, pos):
    """One generation step: a one-token :func:`prefill_chunk` (``pos`` an
    int for a lockstep batch or a (B,) tensor a slot)."""
    return prefill_chunk(cfg, params, token, cache, pos)


def prefill_chunk(cfg: ArchConfig, params, tokens: torch.Tensor, cache, pos):
    """Chunked prefill into a slot cache; see :func:`dense.prefill_chunk`.

    The GShard capacity ``C`` follows the number of tokens in flight, so a
    chunk and a full-prompt prefill route identically only while no expert
    overflows: serve with ``capacity_factor >= E / top_k`` where outputs
    must not depend on the batch packing.
    """
    S = tokens.shape[1]
    carry = carry_spec(tokens.shape[0], S, cfg.d_model)
    x = dense._embed(cfg, params, tokens)
    positions = dense._positions(pos, S, tokens.device)
    for l in range(cfg.n_layers):
        x, _, _ = _block(cfg, dense._layer(params, l), x, positions=positions,
                         cache=_kv(cache, l), pos=pos)
        x = constrain_carry(x, S, cfg.d_model)
    fx = carry_features(carry)
    x = rms_norm(x, params["final_norm"], x_axes=fx)
    return dense.logits_fn(cfg, params, whole_activation(x, carry),
                           x_axes=fx), cache


# ------------------------------------------------- compressed-resident serving
#
# Per-layer weight-slot twins of the step functions (see dense.resident_block).
# The slot dict carries the `moe/*`-prefixed expert weights as `_layer`
# slices them, so `_moe_wts` resolves them unchanged.  Under fused residency
# the 2-D-a-layer matrices (attention, router, shared experts) may arrive as
# FusedQT handles; the (L, E, D, F) expert stacks are no stacked matrix and
# stay on the per-layer decode path.

embed_step = dense.embed_step
head_step = dense.head_step


def resident_prefill_block(cfg: ArchConfig, lp, x: torch.Tensor, *,
                           positions: torch.Tensor, q_block: int = 0):
    """One `forward`-collect-cache iteration; the load-balance aux is
    dropped (serving never reads it, matching `prefill`)."""
    x, kv, _ = _block(cfg, lp, x, positions=positions, q_block=q_block)
    return constrain_carry(x, positions.shape[-1], cfg.d_model), kv


def resident_block(cfg: ArchConfig, lp, x: torch.Tensor, cache, l: int, pos):
    """One `decode_step` / `prefill_chunk` iteration against the
    layer-stacked cache (layer ``l``'s rows updated in place)."""
    positions = dense._positions(pos, x.shape[1], x.device)
    x, _, _ = _block(cfg, lp, x, positions=positions, cache=_kv(cache, l),
                     pos=pos)
    return constrain_carry(x, positions.shape[-1], cfg.d_model), cache


# ------------------------------------------------------------- paged KV cache
#
# Paged twins: attention is the dense family's (`dense._paged_attn` scatters
# into and gathers from the block pool through the table); the MLP is the
# MoE dispatch with the aux dropped.

init_kv_pool = dense.init_kv_pool


def _paged_block(cfg: ArchConfig, lp, x, *, pc, bt, pos):
    x = x + dense._paged_attn(cfg, lp, x, pc=pc, bt=bt, pos=pos)
    h = rms_norm(x, lp["mlp_norm"])
    y, _ = moe_mlp(h, _moe_wts(lp), cfg.moe, _padded_experts(cfg))
    return x + y


def paged_prefill_chunk(cfg: ArchConfig, params, tokens: torch.Tensor, pool,
                        bt: torch.Tensor, pos: torch.Tensor):
    """Chunked prefill through the block table (see
    :func:`dense.paged_prefill_chunk`).  Returns (logits (B, S, V), pool)."""
    S = tokens.shape[1]
    x = dense._embed(cfg, params, tokens)
    keys, _ = dense._pool_meta(cfg, pool)
    for l in range(cfg.n_layers):
        x = _paged_block(cfg, dense._layer(params, l), x,
                         pc={k: pool[k][l] for k in keys}, bt=bt, pos=pos)
        x = constrain_carry(x, S, cfg.d_model)
    x = rms_norm(x, params["final_norm"])
    return dense.logits_fn(cfg, params, x), pool


def paged_decode_step(cfg: ArchConfig, params, token: torch.Tensor, pool,
                      bt: torch.Tensor, pos: torch.Tensor):
    """One generation step over a paged slot batch: a one-token
    :func:`paged_prefill_chunk`."""
    return paged_prefill_chunk(cfg, params, token, pool, bt, pos)
