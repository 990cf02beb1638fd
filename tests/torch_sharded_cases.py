"""Rank programs of the sharded-compute tests: each runs on every rank of a
world that ``repro_torch.launch.mesh.spawn`` starts and returns what the
test in the parent asserts.  Imports only numpy, torch and the port, so the
card's tests (``test_torch_sharded_cuda.py``) and ``chip_smoke.py`` share
them with the CPU ones.
"""
import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def recording_routes():
    """Record every MoE router call inside the block: a list of
    (float32 probabilities, top-k indices) numpy pairs, in call order."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(x, router, K):
        probs, gates, idx = real(x, router, K)
        calls.append((probs.float().cpu().numpy(), idx.cpu().numpy()))
        return probs, gates, idx
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


def whole_routes(ranks):
    """The router calls of the whole batch from the ranks' results of
    :func:`serve_cells`: each data rank routes its own rows, so a call's
    rows are those of the ranks at model coordinate 0, in data order; a
    call whose rows every rank holds alike (the weight-stationary decode,
    one row) is rank 0's."""
    first = [r for r in ranks if r["coord"][1] == 0]
    out = []
    for calls in zip(*(r["routes"] for r in first)):
        if all(np.array_equal(calls[0][0], c[0]) for c in calls[1:]):
            out.append(calls[0])
        else:
            out.append(tuple(np.concatenate(x) for x in zip(*calls)))
    return out


def compared_rows(got, want, rows, steps, near_tie_steps):
    """For each of ``steps`` steps, the rows held to one device: every row
    but, from the step on which a router choice of the sharded calls
    ``got`` first differed from one device's ``want`` (each call's
    (probabilities, top-k indices); asserted a near-tie of the
    probabilities, within ``near_tie_steps`` bf16 steps), that row: a
    flipped expert moves the token's output by far more than rounding."""
    start = {}
    assert len(got) == len(want), (len(got), len(want))
    per_step = max(len(want) // steps, 1)   # a step routes every MoE layer
    for c, ((probs, tidx), (_, sidx)) in enumerate(zip(got, want)):
        diff = (np.sort(tidx, -1) != np.sort(sidx, -1)).any(-1)
        for b, pos in zip(*np.nonzero(diff)):
            p = probs[b, pos]
            lo = float(p[np.setdiff1d(tidx[b, pos], sidx[b, pos])].min())
            hi = float(p[np.setdiff1d(sidx[b, pos], tidx[b, pos])].max())
            step = 2.0 ** (np.frexp(abs(lo))[1] - 8)
            assert abs(lo - hi) <= near_tie_steps * step, (c, b, pos, lo, hi)
            start[int(b)] = min(start.get(int(b), steps), c // per_step)
    return [[b for b in range(rows) if start.get(b, steps) > i]
            for i in range(steps)]


def serve_cells(mesh, cfg, params, prompt, fed, src=None, *,
                serve_mode="fsdp", max_len=None, decode_shape="decode_32k",
                fault=None):
    """Prefill ``prompt`` (B, P) through the port's sharded prefill cell
    into a cache of ``max_len`` rows (P + len(fed) by default), then one
    decode step a column of ``fed`` (B, N) through the decode cell of
    ``serve_mode`` and shape ``decode_shape`` (``long_500k``: the cache's
    T over the data axes; the prefill's cache is resharded to it), each
    cell's weights cut from the whole ``params`` by its own specs.  ``src``
    (B, P, D) is an encdec config's source embeddings; ``fault`` plants a
    wrong layout for the call (:func:`planted`).  Returns the float32
    logits of every row (the prefill's last position, then each step's),
    gathered over the data axes, as a list of numpy arrays, and the
    per-rank weight and cache bytes."""
    with planted(fault):
        return _serve_cells(mesh, cfg, params, prompt, fed,
                            serve_mode=serve_mode, max_len=max_len, src=src,
                            decode_shape=decode_shape)


def _serve_cells(mesh, cfg, params, prompt, fed, *, serve_mode, max_len,
                 src, decode_shape):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives
    from repro_torch.launch import specs
    from repro_torch.serving import engine
    dev = mesh.device
    B, P = prompt.shape
    T = max_len or P + fed.shape[1]
    pcell = specs.build_prefill_cell(
        cfg, ShapeConfig("prefill_32k", P, B, "prefill"), mesh,
        weights="bf16", max_len=T)
    dcell = specs.build_decode_cell(
        cfg, ShapeConfig(decode_shape, T, B, "decode"), mesh,
        weights="bf16", serve_mode=serve_mode)

    def whole(logits, cell):
        out = logits.float()
        if cell.row_axes:
            out = collectives.all_gather(mesh, out, 0, cell.row_axes)
        return out[:, -1].cpu().numpy()

    full = {k: v.to(dev) for k, v in params.items()}
    pp = pcell.place(full)
    toks = pcell.local_rows(torch.as_tensor(prompt, dtype=torch.int64,
                                            device=dev))
    if src is not None:
        toks = {"tokens": toks, "src_embeds": pcell.local_rows(
            torch.as_tensor(src, device=dev).to(torch.bfloat16))}
    with torch.inference_mode(), recording_routes() as routes:
        logits, cache = pcell.fn(pp, toks)
        out = [whole(logits, pcell)]
        cache = reshard(mesh, cache, pcell.cache_specs, dcell.cache_specs)
        dp = dcell.place(full)
        del full
        for i in range(fed.shape[1]):
            tok = torch.as_tensor(fed[:, i:i + 1], dtype=torch.int64,
                                  device=dev)
            logits, cache = dcell.fn(dp, dcell.local_rows(tok), cache, P + i)
            out.append(whole(logits, dcell))
    return {"logits": out, "routes": routes,
            "weight_bytes": engine.local_bytes(dp),
            "cache_bytes": engine.local_bytes(cache),
            "cache_shape": tuple(cache["k"].shape) if "k" in cache else None,
            "cache_shapes": {k: tuple(v.shape) for k, v in cache.items()},
            "collectives": dict(collectives.counts), "coord": mesh.key(),
            "sharded_compute": (pcell.meta["sharded_compute"]
                                and dcell.meta["sharded_compute"])}


def reshard(mesh, cache, src_specs, dst_specs):
    """``cache`` (this rank's blocks under ``src_specs``) as this rank
    holds it under ``dst_specs``: gathered whole along each dim whose
    placement differs, then cut; ``cache`` itself when they agree."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import local_block
    if src_specs == dst_specs:
        return cache
    out = {}
    for k, t in cache.items():
        src = src_specs[k].padded(t.dim())
        dst = dst_specs[k].padded(t.dim())
        for d, (a, b) in enumerate(zip(src, dst)):
            if a != b and a is not None:
                t = collectives.all_gather(mesh, t, d, a)
        cut = tuple(b if a != b else None for a, b in zip(src, dst))
        out[k] = local_block(t, cut, mesh).clone()
    return out


@contextlib.contextmanager
def planted(fault):
    """Patch a wrong sharded layout of the SSM block into this process
    for the block (the unit cases that the comparisons must catch):

    * ``ssm_norm_local``: the gated RMS norm over this rank's block of the
      inner channels only (no cross-rank sum of squares);
    * ``zx_unblocked``: ``in_zx`` placed without its re-blocking, so a
      rank's ``[z | x]`` halves come from the wrong half of the matrix;
    * ``zx_swapped``: the rank's z and x blocks swapped."""
    from repro_torch.models import layers, mamba2
    saved = {"rms_norm": mamba2.rms_norm, "zx_blocks": mamba2.zx_blocks}
    if fault == "ssm_norm_local":
        def rms_norm(x, scale, eps=1e-6, *, x_axes=None, split=None):
            if x_axes is None:
                return saved["rms_norm"](x, scale, eps, split=split)
            return saved["rms_norm"](x, layers.local_weight(scale)[0], eps)
        mamba2.rms_norm = rms_norm
    elif fault == "zx_unblocked":
        mamba2.zx_blocks = lambda w, n: w
    elif fault == "zx_swapped":
        def zx_blocks(w, n):
            half = w.shape[-1] // 2
            return saved["zx_blocks"](
                torch.cat([w[..., half:], w[..., :half]], -1), n)
        mamba2.zx_blocks = zx_blocks
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mamba2, k, v)


def load_params(cfg, path: str, device="cpu"):
    """The whole weights of ``cfg`` from an npz of float32 arrays (the JAX
    package's parameter dict, saved by name), in the port's dtypes."""
    from repro_torch import convert
    with np.load(path) as f:
        host = {k: f[k] for k in f.files}
    return convert.params_from_numpy(cfg, host, device)


def run_jobs(mesh, jobs):
    """Each job ``(name, kwargs)`` of this module in turn, in one world:
    ``serve`` (:func:`serve_cells`, ``params`` an npz path), ``combine``
    (:func:`combine_cases`), ``matmuls`` (:func:`parallel_matmuls`)."""
    out = []
    for name, kw in jobs:
        if name == "serve":
            kw = dict(kw, params=load_params(kw["cfg"], kw["params"],
                                             mesh.device))
            out.append(serve_cells(mesh=mesh, **kw))
        elif name == "combine":
            out.append(combine_cases(mesh, **kw))
        elif name == "matmuls":
            out.append(parallel_matmuls(mesh, **kw))
        else:
            raise ValueError(name)
    return out


def _prompt(prompt, src, device):
    """The prefill's input: tokens, or with ``src`` an encdec batch."""
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)
    if src is None:
        return toks
    return {"tokens": toks, "src_embeds": torch.as_tensor(
        src, device=device).to(torch.bfloat16)}


def one_device(cfg, params, prompt, fed, device="cpu", src=None):
    """The single-device logits of the same prefill and teacher-forced
    decode steps (the family's own step functions, no mesh), and the MoE
    router calls (:func:`recording_routes`)."""
    from repro_torch.models import api
    mod = api.build(cfg)
    P = prompt.shape[1]
    T = P + fed.shape[1]
    with torch.inference_mode(), recording_routes() as routes:
        p = {k: v.to(device) for k, v in params.items()}
        logits, cache = mod.prefill(cfg, p, _prompt(prompt, src, device),
                                    max_len=T)
        out = [logits.float()[:, -1].cpu().numpy()]
        for i in range(fed.shape[1]):
            logits, cache = mod.decode_step(
                cfg, p, torch.as_tensor(fed[:, i:i + 1], dtype=torch.int64,
                                        device=device), cache, P + i)
            out.append(logits.float()[:, -1].cpu().numpy())
    return out, routes


def greedy(cfg, params, prompt, steps, device="cpu", src=None):
    """The single device's greedy continuation (B, steps) of ``prompt``:
    the tokens every variant is then fed."""
    from repro_torch.models import api
    mod = api.build(cfg)
    P = prompt.shape[1]
    with torch.inference_mode():
        p = {k: v.to(device) for k, v in params.items()}
        logits, cache = mod.prefill(cfg, p, _prompt(prompt, src, device),
                                    max_len=P + steps)
        toks = []
        for i in range(steps):
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok)
            if i + 1 < steps:
                logits, cache = mod.decode_step(cfg, p, tok, cache, P + i)
    return torch.cat(toks, 1).cpu().numpy()


def combine_cases(mesh, cases, mutant: bool = False):
    """The split-T attention of each case ``(q, k, v, kv_len, causal,
    q_offset)`` (numpy, k / v whole): every rank of the model axis takes
    its block of T, attends it under sharded-compute hints whose cache
    rests split along T over model, and the combine makes the result
    whole.  ``mutant`` drops the cross-rank max (each block's exps taken
    against its own row maxima), the rescale the combine depends on.
    Returns each case's float32 output."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import ShardingHints, set_hints
    from repro_torch.models import layers
    dev = mesh.device
    hints = ShardingHints(mesh=mesh, batch_axes=(), model_axis="model",
                          kv_seq_axes=("model",), seq_sp=False,
                          cache_seq_axes=("model",))
    real = collectives.all_reduce
    if mutant:
        def all_reduce(m, t, axes, op):
            return t if op == "max" else real(m, t, axes, op)
        collectives.all_reduce = all_reduce
    set_hints(hints)
    out = []
    try:
        n = mesh.shape["model"]
        r = mesh.coord["model"]
        for q, k, v, kv_len, causal, q_offset in cases:
            t = lambda a: (  # noqa: E731
                torch.from_numpy(a).to(torch.bfloat16).to(dev))
            Tl = k.shape[1] // n
            kb, vb = (t(a[:, r * Tl:(r + 1) * Tl]) for a in (k, v))
            H, KV = q.shape[2], k.shape[2]
            qa, ka, va, axes, _ = layers.attention_blocks(
                t(q), kb, vb, n_heads=H, n_kv_heads=KV, cache_side=True)
            kl = kv_len if not isinstance(kv_len, np.ndarray) \
                else torch.from_numpy(kv_len).to(dev)
            qo = q_offset if not isinstance(q_offset, np.ndarray) \
                else torch.from_numpy(q_offset).to(dev)
            o = layers.gqa_attention(qa, ka, va, causal=causal, q_offset=qo,
                                     kv_len=kl, kv_axes=axes)
            out.append(o.float().cpu().numpy())
    finally:
        set_hints(None)
        collectives.all_reduce = real
    return out


def parallel_matmuls(mesh, x, w_col, w_row, seq_split: bool):
    """A column-parallel (``w_col``'s output channels over model) then a
    row-parallel (``w_row``'s input channels over model) product of the
    whole ``x`` (B, S, D) under sharded-compute hints, each rank holding
    its blocks: the MLP pair of a layer.  With ``seq_split`` the result
    rests split along S (a reduce-scatter) and is gathered back here.
    Returns the whole float32 result and the collective counts."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import ShardingHints, Sharded, set_hints
    from repro_torch.distributed.ctx import local_block
    from repro_torch.models import layers
    dev = mesh.device
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(dev)  # noqa: E731
    wc = Sharded(local_block(t(w_col), (None, "model"), mesh).clone(),
                 (None, "model"))
    wr = Sharded(local_block(t(w_row), ("model", None), mesh).clone(),
                 ("model", None))
    set_hints(ShardingHints(mesh=mesh, batch_axes=(), model_axis="model",
                            seq_sp=seq_split))
    collectives.reset_counts()
    try:
        carry = layers.carry_spec(*x.shape)
        h = layers.matmul(t(x), wc)
        y = layers.matmul(layers.silu(h), wr, x_axes="model", carry=carry)
        y = layers.whole_activation(y, carry)
    finally:
        set_hints(None)
    return y.float().cpu().numpy(), dict(collectives.counts)
