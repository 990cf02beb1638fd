"""Rank programs of the sharded-compute training tests: each runs on every
rank of a world that ``repro_torch.launch.mesh.spawn`` starts and returns
what the test in the parent asserts.  Imports only numpy, torch and the
port, so the card's tests (``test_torch_sharded_cuda.py``) share them
with the CPU ones (``test_torch_sharded_train.py``).

Every job builds the train cell's step as ``launch/specs.py`` builds it
for every family (the reference's train-cell hints, the MoE and hybrid
families' EP context), from the whole weights,
which each rank cuts into its ZeRO blocks, and this rank's rows of each
batch leaf (the tokens and, for the encoder-decoder, ``src_embeds``).
"""
import contextlib
import dataclasses

import torch


def train_config(q8_gather: int = 0, grad_compress: bool = False,
                 microbatches: int = 1):
    """The tests' train config: f32 moments, remat, a schedule whose first
    steps move the weights (warm-up of one step)."""
    from repro_torch.training import optimizer as opt, train_loop
    return train_loop.TrainConfig(
        opt=opt.AdamWConfig(schedule=opt.Schedule(
            base_lr=1e-3, warmup_steps=1, total_steps=4)),
        microbatches=microbatches, remat=True, q8_gather=q8_gather,
        grad_compress=grad_compress)


def cell_contexts(cfg, mesh, seq_sp=None):
    """The train cell's hints and EP context on ``mesh``
    (``specs.train_contexts``), ``seq_sp`` replaced when given."""
    from repro_torch.launch import specs
    hints, ep = specs.train_contexts(cfg, mesh)
    if seq_sp is not None:
        hints = dataclasses.replace(hints, seq_sp=seq_sp)
    return hints, ep


@contextlib.contextmanager
def replayed_routes(routes, rows):
    """Feed one device's router choices ``routes`` (its calls' (float32
    probabilities, top-k indices), in call order, the whole batch) to this
    rank's calls, each its rows ``rows(t)``: the rank routes to one
    device's experts, with gates from its own probabilities over them,
    renormalised as ``moe.route`` does.  The sharded layout rounds the
    router's input otherwise than one device, which can flip a near-tie
    choice, and a flipped expert moves a token's gradient by far more than
    rounding.  Yields a list, a call each, of the tokens whose own top-k
    differs from the one fed and the largest probability gap of such a
    flip (both asserted by the parent: near-ties only)."""
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(x, router, K):
        probs, _, idx = real(x, router, K)
        want_p, want_i = (rows(torch.as_tensor(a, device=x.device))
                          for a in routes[len(seen)])
        flips = (torch.sort(idx, -1)[0] != torch.sort(want_i, -1)[0]).any(-1)
        gap = 0.0
        if bool(flips.any()):
            p = want_p[flips]
            gap = float((p.gather(-1, idx[flips]).sum(-1)
                         - p.gather(-1, want_i[flips]).sum(-1)).abs().max())
        seen.append((int(flips.sum()), gap))
        gates = probs.gather(-1, want_i)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                          min=1e-9), want_i
    moe.route = real if routes is None else route
    try:
        yield seen
    finally:
        moe.route = real


@contextlib.contextmanager
def recording_routes():
    """Record every router call inside the block (one device): a list of
    (float32 probabilities, top-k indices) numpy pairs, in call order."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(x, router, K):
        probs, gates, idx = real(x, router, K)
        calls.append((probs.detach().float().cpu().numpy(),
                      idx.cpu().numpy()))
        return probs, gates, idx
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


@contextlib.contextmanager
def aux_weighted(aux_coef=None):
    """The hybrid's loss with the MoE aux weighted ``aux_coef`` (its
    ``loss_fn`` default, 0.01, when None) for the block: at 1.0 the aux's
    gradient is most of the router's, which the cross-entropy's gates'
    gradient otherwise outweighs."""
    from repro_torch.models import hybrid
    real = hybrid.loss_fn
    if aux_coef is not None:
        def loss_fn(*args, **kw):
            return real(*args, **dict(kw, aux_coef=aux_coef))
        hybrid.loss_fn = loss_fn
    try:
        yield
    finally:
        hybrid.loss_fn = real


@contextlib.contextmanager
def planted(fault):
    """Patch a wrong backward into this process for the block (the faults
    the gradient comparison must catch):

    * ``column_input_unsummed``: a carry whole over the model axis enters
      the column-parallel products without the model all-reduce of its
      gradient (``layers.whole_activation`` without its ``enter_split``);
    * ``whole_norm_summed``: a norm's scale on a whole carry summed over
      the model axis (``rms_norm(split=)`` always on);
    * ``rs_keeps_own``: an all-gather's reduce-scatter backward that keeps
      its own partial (no sum over the ranks);
    * ``encdec_norm_unsplit``: the encoder-decoder's norms on carries split
      along S without ``split=`` (each scale's gradient left this rank's
      share, not summed over the model axis);
    * ``ssm_zx_plain``: the SSM's ``in_zx`` placed (and read back) by the
      plain cut of ``[z | x]``, not re-blocked (``train_loop.zx_split``
      1): the first model ranks' x columns are z's;
    * ``ssm_conv_bc_unsummed``: the SSM's ``conv_bc``, whole over the model
      axis, enters each rank's heads without ``split_use`` (its gradient
      this rank's heads' share only);
    * ``ssm_norm_unsplit``: the SSM's pre-block and final norms on carries
      split along S without ``split=``;
    * ``hybrid_aux_local``: the MoE aux's statistics (mean probabilities,
      choice counts) this rank's rows', not summed over the data axes;
    * ``hybrid_loss_gathered``: the hybrid's loss as one device computes
      it, on the logits gathered whole (each rank its rows' mean), not
      :func:`dense.xent`'s global mean."""
    from repro_torch.distributed import collectives
    from repro_torch.models import dense, encdec, hybrid, layers, mamba2, moe
    from repro_torch.training import train_loop
    saved = [(dense, "whole_activation", dense.whole_activation),
             (dense, "xent", dense.xent),
             (moe, "_routed", moe._routed),
             (moe, "whole_activation", moe.whole_activation),
             (dense, "rms_norm", dense.rms_norm),
             (moe, "rms_norm", moe.rms_norm),
             (encdec, "rms_norm", encdec.rms_norm),
             (mamba2, "rms_norm", mamba2.rms_norm),
             (mamba2, "split_use", mamba2.split_use),
             (train_loop, "zx_split", train_loop.zx_split),
             (collectives._AllGather, "backward",
              collectives._AllGather.__dict__["backward"])]
    if fault == "column_input_unsummed":
        def whole(x, spec, *, features=False):
            if spec is None or spec[1] is None:
                return x
            return layers.whole_activation(x, spec, features=features)
        dense.whole_activation = moe.whole_activation = whole
    elif fault == "whole_norm_summed":
        def norm(x, scale, eps=1e-6, *, x_axes=None, split=None):
            return layers.rms_norm(x, scale, eps, x_axes=x_axes, split=True)
        dense.rms_norm = moe.rms_norm = norm
    elif fault == "rs_keeps_own":
        real = collectives._AllGather.backward

        def backward(ctx, g):
            ctx.grad = "cut"
            return real(ctx, g)
        collectives._AllGather.backward = staticmethod(backward)
    elif fault in ("encdec_norm_unsplit", "ssm_norm_unsplit"):
        def unsplit(x, scale, eps=1e-6, *, x_axes=None, split=None):
            return layers.rms_norm(x, scale, eps, x_axes=x_axes)
        mod = encdec if fault == "encdec_norm_unsplit" else mamba2
        mod.rms_norm = unsplit
    elif fault == "ssm_zx_plain":
        train_loop.zx_split = lambda cfg, name, spec, mesh: 1
    elif fault == "ssm_conv_bc_unsummed":
        mamba2.split_use = lambda w: w
    elif fault == "hybrid_aux_local":
        real_routed = moe._routed

        def routed(x, wts, mcfg, E, stat_axes=()):
            return real_routed(x, wts, mcfg, E)
        moe._routed = routed
    elif fault == "hybrid_loss_gathered":
        def xent(cfg, params, x, labels):
            return layers.softmax_xent(hybrid.logits_fn(cfg, params, x),
                                       labels, cfg.vocab)
        dense.xent = xent
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for mod, name, v in saved:
            setattr(mod, name, v)


def _whole(tree, mesh, cfg):
    """One device's tensors of a train tree of ``cfg`` (float32 numpy)."""
    from repro_torch.training import train_loop
    return {n: p.float().cpu().numpy() for n, p in
            train_loop.gather_params(tree, mesh, cfg).items()}


def _spec_tree(placed, grads):
    from repro_torch.distributed.ctx import Sharded
    return {n: Sharded(g, placed[n].spec) if isinstance(placed[n], Sharded)
            else g for n, g in grads.items()}


def grads_job(mesh, cfg, params, batch, *, seq_sp=None, q8_gather=0,
              fault=None, routes=None, record=False, aux_coef=None):
    """The loss and the whole gradients of one batch, from this rank's
    blocks (``train_loop.make_mesh_grad_fn`` under the train cell's
    contexts; the hybrid's aux weighted ``aux_coef``,
    :func:`aux_weighted`); with ``record`` also the collectives it issued
    (``collectives.recording``)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import local_block
    from repro_torch.training import train_loop
    tc = train_config(q8_gather)
    hints, ep = cell_contexts(cfg, mesh, seq_sp)
    with aux_weighted(aux_coef):
        fn = train_loop.make_mesh_grad_fn(cfg, tc, mesh, hints, ep)
    b = train_loop.shard_batch({k: v.to(mesh.device)
                                for k, v in batch.items()}, mesh)
    rows = lambda t: local_block(t, ("data",), mesh)  # noqa: E731
    with planted(fault):
        placed, _ = train_loop.shard_train_state(
            cfg, tc, {n: p.to(mesh.device) for n, p in params.items()},
            mesh)
        with replayed_routes(routes, rows) as seen, \
                collectives.recording() as recs:
            loss, grads = fn(placed, b)
        out = dict(loss=float(loss), routes=seen,
                   grads=_whole(_spec_tree(placed, grads), mesh, cfg))
    if record:
        out["records"] = list(recs)
    return out


def steps_job(mesh, cfg, params, batches, *, q8_gather=0,
              grad_compress=False, routes=None, cell_shape=None,
              states=False):
    """``len(batches)`` steps of the train cell's step from the whole
    ``params``: each step's loss and grad norm and the whole params and
    first moments after the last (with ``states``, the whole params and
    both moments after each step too).  With ``cell_shape`` ((B, S)) the
    step is ``specs.build_train_cell``'s own, with its own config."""
    from repro_torch.distributed.ctx import local_block
    from repro_torch.training import train_loop
    tc = train_config(q8_gather, grad_compress)
    if cell_shape is None:
        hints, ep = cell_contexts(cfg, mesh)
        step = train_loop.make_train_step(cfg, tc, mesh, hints=hints, ep=ep)
    else:
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import specs
        from repro_torch.training import optimizer as opt
        B, S = cell_shape
        cell = specs.build_train_cell(
            cfg, ShapeConfig("train_4k", S, B, "train"), mesh)
        assert cell.meta["compute"] == "sharded", cell.meta
        step = cell.fn
        tc = train_loop.TrainConfig(opt=opt.AdamWConfig())
    placed, state = train_loop.shard_train_state(
        cfg, tc, {n: p.to(mesh.device) for n, p in params.items()}, mesh)
    rows = lambda t: local_block(t, ("data",), mesh)  # noqa: E731
    losses, norms, after = [], [], []
    with replayed_routes(routes, rows) as seen:
        for b in batches:
            b = train_loop.shard_batch(
                {k: v.to(mesh.device) for k, v in b.items()}, mesh)
            placed, state, m = step(placed, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if states:
                after.append(dict(
                    params=_whole(placed, mesh, cfg),
                    moments=_whole(_spec_tree(placed, state.m), mesh, cfg),
                    second=_whole(_spec_tree(placed, state.v), mesh, cfg)))
    return dict(losses=losses, grad_norms=norms,
                params=_whole(placed, mesh, cfg),
                moments=_whole(_spec_tree(placed, state.m), mesh, cfg),
                routes=seen, states=after)


def q8_job(mesh, cfg, params, bits_list):
    """``ste_quantize_params`` of this rank's blocks at each bit width, its
    symbols, scales and zeros gathered whole (numpy, native dtypes; the
    symbols in one device's order)."""
    from repro_torch.distributed.ctx import Sharded
    from repro_torch.models.layers import QTG
    from repro_torch.training import train_loop
    tc = train_config()
    placed, _ = train_loop.shard_train_state(
        cfg, tc, {n: p.to(mesh.device) for n, p in params.items()}, mesh)
    out = []
    for bits in bits_list:
        qt = train_loop.ste_quantize_params(placed, bits, mesh)
        got = {}
        for n, w in qt.items():
            if not isinstance(w, QTG):
                continue
            parts = {}
            for k in ("q", "scale", "zero"):
                p = getattr(w, k)
                whole = train_loop.gather_params({n: p}, mesh, cfg)[n] \
                    if isinstance(p, Sharded) else p
                parts[k] = whole.cpu().numpy()
            got[n] = parts
        out.append(got)
    return out


def compress_job(mesh, leaves):
    """``grad_compress.compress_decompress_block`` of each ``(full, spec)``
    leaf's block on this rank, gathered whole, with the count of
    all-gathers it issued (none: nothing is gathered)."""
    from repro_torch.distributed import collectives, grad_compress
    from repro_torch.distributed.ctx import Sharded, local_block
    from repro_torch.training import train_loop
    out = []
    for full, spec in leaves:
        t = torch.as_tensor(full, device=mesh.device)
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        collectives.reset_counts()
        got = grad_compress.compress_decompress_block(
            local_block(t, spec, mesh).clone(), tuple(t.shape), spec, mesh)
        gathers = collectives.counts["all_gather"]
        whole = train_loop.gather_params({"g": Sharded(got, spec)},
                                         mesh)["g"]
        out.append((whole.cpu().numpy(), gathers))
    return out


def roundtrip_job(mesh, cfg, params):
    """``train_loop.gather_params`` of ``shard_train_state``'s blocks of the
    whole ``params`` (numpy, native dtypes: bf16 as its int16 bits)."""
    from repro_torch.training import train_loop
    placed, _ = train_loop.shard_train_state(
        cfg, train_config(), {n: p.to(mesh.device) for n, p in params.items()},
        mesh)
    return {n: (p.view(torch.int16) if p.dtype == torch.bfloat16 else p)
            .cpu().numpy()
            for n, p in train_loop.gather_params(placed, mesh, cfg).items()}


def compress_tree_job(mesh, cfg, grads):
    """``train_loop.compress_blocks`` of the blocks of one device's whole
    gradients ``grads`` (numpy float32), placed as the train state is,
    gathered whole, with the count of all-gathers the compression issued
    (none)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import Sharded
    from repro_torch.training import train_loop
    placed, _ = train_loop.shard_train_state(
        cfg, train_config(), {n: torch.as_tensor(g, device=mesh.device)
                              for n, g in grads.items()}, mesh)
    collectives.reset_counts()
    got = train_loop.compress_blocks(
        cfg, {n: p.local if isinstance(p, Sharded) else p
              for n, p in placed.items()}, placed, mesh)
    gathers = collectives.counts["all_gather"]
    return _whole(_spec_tree(placed, got), mesh, cfg), gathers


def run_jobs(mesh, jobs):
    """Each job ``(name, kwargs)`` of this module in turn, in one world:
    ``grads``, ``steps``, ``q8``, ``compress``, ``roundtrip``,
    ``compress_tree`` (the ``*_job`` functions)."""
    fns = {"grads": grads_job, "steps": steps_job, "q8": q8_job,
           "compress": compress_job, "roundtrip": roundtrip_job,
           "compress_tree": compress_tree_job}
    return [fns[name](mesh, **kw) for name, kw in jobs]


def single_grads(cfg, params, batch, q8_gather=0, aux_coef=None):
    """One device's loss and gradients of ``batch`` (float32 numpy), and
    its router calls (the hybrid's aux weighted ``aux_coef``)."""
    from repro_torch.training import train_loop
    with recording_routes() as routes, aux_weighted(aux_coef):
        loss, grads = train_loop.make_grad_fn(cfg, train_config(q8_gather))(
            params, batch)
    return float(loss), {n: g.float().cpu().numpy()
                         for n, g in grads.items()}, routes


def single_steps(cfg, params, batches, q8_gather=0, grad_compress=False,
                 tc=None, state=None, routes=None):
    """One device's steps of the same config: losses, grad norms, the
    params and first moments after the last (float32 numpy), its router
    calls.  From the optimizer ``state`` given (zero moments by default);
    fed the router choices ``routes`` when given (:func:`replayed_routes`)."""
    from repro_torch.training import optimizer as opt, train_loop
    tc = tc or train_config(q8_gather, grad_compress)
    step = train_loop.make_train_step(cfg, tc)
    state = state or opt.init_state(tc.opt, params)
    losses, norms = [], []
    fed = replayed_routes(routes, lambda t: t)
    with recording_routes() as routes, fed:
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=norms,
                params={n: p.float().cpu().numpy()
                        for n, p in params.items()},
                moments={n: m.float().cpu().numpy()
                         for n, m in state.m.items()},
                routes=routes)
