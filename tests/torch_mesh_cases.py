"""Rank programs of the port's multi-device tests: each runs on every rank
of a world that ``repro_torch.launch.mesh.spawn`` starts, and returns what
the test in the parent asserts.  Imports only numpy, torch and the port, so
the card's tests (``test_torch_mesh_cuda.py``) share them with the CPU ones.
"""
import numpy as np
import torch


def narrow(registry, arch: str):
    """The reduced config of ``arch`` cut to 2 layers (and, for MoE, an
    expert hidden dim of 64), so that eight ranks decode it in seconds."""
    import dataclasses
    cfg = registry.reduced(registry.get(arch))
    kw = dict(n_layers=2)
    if cfg.moe is not None:
        kw["d_ff"] = 64
    return dataclasses.replace(cfg, **kw)


def _spec_of(part):
    from repro_torch.distributed.ctx import Sharded
    if isinstance(part, Sharded):
        return part.spec
    return (None,) * part.dim()


def placement(params) -> dict:
    """Each QT / QT4 leaf's (q, scale, zero) specs and shapes, padded to
    each part's rank: what the parent checks for consistency."""
    from repro_torch.models.layers import QT, QT4
    out = {}
    for name, v in params.items():
        if isinstance(v, (QT, QT4)):
            out[name] = [(_spec_of(p), tuple(
                (p.local if hasattr(p, "local") else p).shape)) for p in v]
    return out


def serve_world(mesh, cfg, path: str, prompt, gen: int, max_len: int,
                prompts=None, slot_gen: int = 0, backend: str = "numpy"):
    """Load the container at ``path`` with the mesh's placer, serve the
    lockstep ``prompt`` for ``gen`` tokens and, with ``prompts``, the
    requests through a 4-slot continuous engine.  Returns tokens, per-rank
    bytes, the placement and the slot pool's rows."""
    from repro_torch.core.store import CompressedModel
    from repro_torch.serving import engine
    from repro_torch.serving.batching import ContinuousEngine
    cm = CompressedModel.load(path)
    params = engine.load_params_from_compressed(
        cm, backend=backend, placer=engine.make_param_placer(cfg, mesh),
        device=mesh.device)
    sc = engine.ServeConfig(max_len=max_len)
    eng = engine.Engine(cfg, params, sc, mesh=mesh)
    out = {"tokens": eng.generate(prompt, gen).cpu().numpy(),
           "weight_bytes": engine.per_device_bytes(params, mesh),
           "cache_bytes": eng.cache_bytes,
           "placement": placement(params), "coord": mesh.key()}
    if prompts is not None:
        ce = ContinuousEngine(cfg, params, sc, n_slots=4, prefill_chunk=8,
                              mesh=mesh)
        out["slot_rows"] = (ce.slots.rows.start, ce.slots.rows.stop)
        out["slot_cache"] = {k: tuple(v.shape)
                             for k, v in ce.slots.cache.items()}
        out["slot_specs"] = ce.steps.cache_shardings(4, layout="slot")
        reqs = [ce.submit(p, slot_gen) for p in prompts]
        ce.run()
        out["slot_tokens"] = [list(map(int, r.output)) for r in reqs]
    return out


def serve_worlds(mesh, jobs):
    """:func:`serve_world` for each job (its keyword arguments) in turn,
    in one world."""
    return [serve_world(mesh, **job) for job in jobs]


def ep_world(mesh, weights: dict, x, top_k: int, cf: float,
             batch_sharded: bool):
    """The MoE feed-forward under an :class:`EPContext` on ``mesh``: each
    rank cuts its expert block of the whole ``weights`` (and, with
    ``batch_sharded``, its rows of ``x``), and returns its (y, aux)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed.ctx import local_block
    from repro_torch.models import moe
    ctx = moe.EPContext(mesh, batch_sharded=batch_sharded)
    specs = moe.ep_weight_specs(ctx)
    wts = {k: (local_block(torch.from_numpy(v), specs[k], mesh).clone()
               if k in specs else torch.from_numpy(v))
           for k, v in weights.items()}
    wts = {k: v.to(torch.bfloat16) if k != "router" else v
           for k, v in wts.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if batch_sharded:
        xt = local_block(xt, ("data",), mesh)
    E = weights["w_gate"].shape[0]
    mcfg = MoEConfig(num_experts=E, top_k=top_k, capacity_factor=cf)
    moe.set_ep_context(ctx)
    try:
        y, aux = moe.moe_mlp(xt, wts, mcfg, E)
    finally:
        moe.set_ep_context(None)
    return y.float().numpy(), float(aux)


def ep_worlds(mesh, weights: dict, x, top_k: int, cf: float, layouts):
    """:func:`ep_world` in each layout (``batch_sharded`` values) in turn."""
    return [ep_world(mesh, weights, x, top_k, cf, bs) for bs in layouts]


def restore_world(mesh, root: str, like, specs):
    """Restore the checkpoint under ``root`` onto ``mesh`` by ``specs``
    (``fault_tolerance.reshard_restore``); returns each leaf's local block
    and spec, in the tree's flatten order."""
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer,
                                                     flatten_with_path)
    from repro_torch.distributed.ctx import Sharded
    from repro_torch.distributed.fault_tolerance import reshard_restore
    ck = Checkpointer(CheckpointConfig(root=root))
    step, tree = reshard_restore(ck, like, specs, mesh)
    out = []
    for path, leaf in flatten_with_path(tree):
        if isinstance(leaf, Sharded):
            out.append(("/".join(path), leaf.local.float().numpy(),
                        leaf.spec))
        else:
            out.append(("/".join(path), leaf.float().numpy(), None))
    return step, mesh.key(), out


def collectives_world(mesh):
    """One call of each collective the path uses, on ``mesh.device``:
    returns the gathered / summed and picked values and the call counts."""
    from repro_torch.distributed import collectives
    collectives.reset_counts()
    dev = mesh.device
    r = float(mesh.rank)
    t = torch.full((2, 3), r, device=dev, dtype=torch.bfloat16)
    g = collectives.all_gather(mesh, t, 0, ("data", "model"))
    s = collectives.all_reduce_sum(mesh, t.float(), ("model",))
    p = collectives.pick(mesh, torch.tensor([mesh.rank], device=dev),
                         "data", 0)
    return (g.float().cpu().numpy(), s.cpu().numpy(), int(p[0]),
            dict(collectives.counts))


def lockstep_tokens(cfg, path: str, prompt, gen: int, max_len: int,
                    device, backend: str = "numpy"):
    """The single-device reference: the same container, no mesh."""
    from repro_torch.core.store import CompressedModel
    from repro_torch.serving import engine
    params = engine.load_params_from_compressed(
        CompressedModel.load(path), backend=backend, device=device)
    eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=max_len),
                        device=device)
    return eng.generate(prompt, gen).cpu().numpy(), params


def slot_tokens(cfg, params, prompts, gen: int, max_len: int, device):
    """The single-device 4-slot continuous engine's tokens a request."""
    from repro_torch.serving import engine
    from repro_torch.serving.batching import ContinuousEngine
    ce = ContinuousEngine(cfg, params, engine.ServeConfig(max_len=max_len),
                          n_slots=4, prefill_chunk=8, device=device)
    reqs = [ce.submit(p, gen) for p in prompts]
    ce.run()
    return [list(map(int, r.output)) for r in reqs]


def random_prompts(vocab: int, lens, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (int(n),)).astype(np.int32) for n in lens]


def fail_on_rank(mesh, rank: int):
    """Raise on ``rank``; the others return."""
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return mesh.rank


def hang_on_rank(mesh, rank: int):
    """Never return on ``rank``; the others return."""
    import time
    while mesh.rank == rank:
        time.sleep(1.0)
    return mesh.rank


def train_steps(cfg, params, batches, run: dict, mesh=None):
    """``len(batches)`` train steps of ``run``'s config (``mb``
    microbatches, ``q8`` moments) from the whole ``params`` on one device
    (``mesh`` None) or on this rank's blocks and rows; returns the
    per-step loss and grad norm, the whole params after the last step and
    the quantized moments' per-row scales (``{name: (m, v)}``), gathered on
    a mesh, as float32 numpy."""
    from repro_torch.training import optimizer as opt, train_loop
    tc = train_loop.TrainConfig(
        opt=opt.AdamWConfig(
            schedule=opt.Schedule(base_lr=1e-3, warmup_steps=1,
                                  total_steps=4),
            quantized_state=run["q8"]),
        microbatches=run["mb"], remat=True)
    step = train_loop.make_train_step(cfg, tc, mesh)
    if mesh is None:
        state = opt.init_state(tc.opt, params)
    else:
        params, state = train_loop.shard_train_state(
            cfg, tc, {n: p.to(mesh.device) for n, p in params.items()}, mesh)
    losses, norms = [], []
    for b in batches:
        if mesh is not None:
            b = train_loop.shard_batch(
                {k: v.to(mesh.device) for k, v in b.items()}, mesh)
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    scales = {}
    for n, m in state.m.items():
        if isinstance(m, opt.Q8Moment):
            scales[n] = (m.scale, state.v[n].scale)
    if mesh is not None:
        from repro_torch.distributed.ctx import Sharded
        for n in scales:
            spec = params[n].spec[:-1] + (None,) \
                if isinstance(params[n], Sharded) else None
            scales[n] = tuple(train_loop.gather_params(
                {n: Sharded(s, spec) if spec else s}, mesh)[n]
                for s in scales[n])
        params = train_loop.gather_params(params, mesh)
    return losses, norms, \
        {n: p.float().cpu().numpy() for n, p in params.items()}, \
        {n: tuple(s.cpu().numpy() for s in v) for n, v in scales.items()}


def train_world(mesh, cfg, params, batches, runs):
    """:func:`train_steps` of each run on this rank of ``mesh``."""
    return [train_steps(cfg, params, batches, run, mesh) for run in runs]
