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


def serve_cells(mesh, cfg, params, prompt, fed, *, serve_mode="fsdp",
                max_len=None):
    """Prefill ``prompt`` (B, P) through the port's sharded prefill cell
    into a cache of ``max_len`` rows (P + len(fed) by default), then one
    decode step a column of ``fed`` (B, N) through the decode cell of
    ``serve_mode``, each cell's weights cut from the whole ``params`` by
    its own specs.  Returns the float32 logits of every row (the prefill's
    last position, then each step's), gathered over the data axes, as a
    list of numpy arrays, and the per-rank weight and cache bytes."""
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
        cfg, ShapeConfig("decode_32k", T, B, "decode"), mesh,
        weights="bf16", serve_mode=serve_mode)

    def whole(logits, cell):
        out = logits.float()
        if cell.row_axes:
            out = collectives.all_gather(mesh, out, 0, cell.row_axes)
        return out[:, -1].cpu().numpy()

    full = {k: v.to(dev) for k, v in params.items()}
    pp = pcell.place(full)
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    with torch.inference_mode(), recording_routes() as routes:
        logits, cache = pcell.fn(pp, pcell.local_rows(toks))
        out = [whole(logits, pcell)]
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
            "cache_shape": tuple(cache["k"].shape),
            "collectives": dict(collectives.counts), "coord": mesh.key()}


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


def one_device(cfg, params, prompt, fed, device="cpu"):
    """The single-device logits of the same prefill and teacher-forced
    decode steps (the family's own step functions, no mesh), and the MoE
    router calls (:func:`recording_routes`)."""
    from repro_torch.models import api
    mod = api.build(cfg)
    P = prompt.shape[1]
    T = P + fed.shape[1]
    with torch.inference_mode(), recording_routes() as routes:
        p = {k: v.to(device) for k, v in params.items()}
        logits, cache = mod.prefill(cfg, p, torch.as_tensor(
            prompt, dtype=torch.int64, device=device), max_len=T)
        out = [logits.float()[:, -1].cpu().numpy()]
        for i in range(fed.shape[1]):
            logits, cache = mod.decode_step(
                cfg, p, torch.as_tensor(fed[:, i:i + 1], dtype=torch.int64,
                                        device=device), cache, P + i)
            out.append(logits.float()[:, -1].cpu().numpy())
    return out, routes


def greedy(cfg, params, prompt, steps, device="cpu"):
    """The single device's greedy continuation (B, steps) of ``prompt``:
    the tokens every variant is then fed."""
    from repro_torch.models import api
    mod = api.build(cfg)
    P = prompt.shape[1]
    with torch.inference_mode():
        p = {k: v.to(device) for k, v in params.items()}
        logits, cache = mod.prefill(cfg, p, torch.as_tensor(
            prompt, dtype=torch.int64, device=device), max_len=P + steps)
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
