"""Sharded compute of the ssm, hybrid and encdec families (the production
serving cells' layouts) on the CPU, against the JAX package's sharded
cells and one device.

One spawned ``gloo`` world of 2 x 2 ranks (``repro_torch.launch.mesh.spawn``,
one process a rank, one intra-op thread each) runs every case of the
module, each config cut to 2 layers (jamba: one period of its reduced
config, 4 layers):

* reduced mamba2-370m: each rank computes its block of the SSD heads
  (``in_zx`` re-blocked at placement, ``conv_x`` and the state split with
  the inner channels, the gated norm summed across ranks, ``out_proj``
  row-parallel), the prompt's carry split along S; then its decode cell in
  the weight-stationary layout (rows whole, D over data, the state's rows
  split over data);
* reduced seamless-m4t-medium: encoder and decoder carries split along S,
  self- and cross-attention over a rank's heads, the cross K / V cached
  by heads;
* reduced jamba-1.5-large-398b: a batch-only carry (no sequence
  parallelism), its attention and MoE FFN the dense and MoE families',
  then a one-row decode of ``long_500k``'s shape, the cache's T over the
  data axis (attended block by block and combined);
* the planted layouts the comparisons must catch: the SSM's gated norm
  over a rank's block of the inner channels only, and ``in_zx`` placed
  without its re-blocking (a rank's z / x halves from the wrong half of
  the matrix).

Each config's prefill cell (4 x 8 prompt into a 12-row cache) and then its
decode cell, fed 4 tokens (the single device's greedy continuation,
teacher-forced), are held against (a) the reference's cells of the same
shapes — ``repro.launch.specs.build_prefill_cell`` / ``build_decode_cell``
on a JAX mesh of 2 x 2 host devices, each jitted once for the module (the
one-row prefill, which the reference's EP body cannot split over data,
runs unsharded) — and (b) the port on one device.  Both take the weights
the reference made (bf16), carried to the ranks as an npz.

Tolerances, as in ``test_torch_sharded_compute.py``: logits within
``ATOL`` of both; greedy tokens equal one device's up to a near-tie (two
candidates within ``NEAR_TIE_STEPS`` bf16 steps).  jamba's MoE admits
every routed choice (``capacity_factor`` = E / top_k): the sharded
dispatch sizes the capacity by each data rank's rows and one device by
the whole batch's, which route alike only while nothing is dropped.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh

import torch_sharded_cases as cases

ATOL = 2e-2
NEAR_TIE_STEPS = 2
B, P, N = 4, 8, 4
T = P + N
MESH = (2, 2)
WORLD_TIMEOUT_S = 240
ARCHS = {"mamba2": "mamba2-370m", "seamless": "seamless-m4t-medium",
         "jamba": "jamba-1.5-large-398b"}
# (config, serve_mode, decode shape, rows)
CELLS = {"mamba2": ("mamba2", "fsdp", "decode_32k", B),
         "mamba2-stationary": ("mamba2", "stationary", "decode_32k", B),
         "seamless": ("seamless", "fsdp", "decode_32k", B),
         "jamba": ("jamba", "fsdp", "decode_32k", B),
         "jamba-long": ("jamba", "fsdp", "long_500k", 1)}
FAULTS = ("ssm_norm_local", "zx_unblocked")


def _cfgs(arch):
    """Both packages' reduced config of ``arch`` cut to 2 layers (the
    hybrid to one period); an MoE config admits every choice."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.reduced(reg.get(arch))
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.attn_period if cfg.family == "hybrid" else 2)
        if cfg.moe:
            cf = float(cfg.moe.padded_experts(16) // cfg.moe.top_k)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def few_threads_module():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, few_threads_module):
    """Each config's reference weights (npz) and, for each cell, its
    prompt (and source embeddings), the single device's greedy
    continuation and its teacher-forced logits."""
    tmp = tmp_path_factory.mktemp("families")
    configs = {}
    for key, arch in ARCHS.items():
        jcfg, tcfg = _cfgs(arch)
        jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
        path = str(tmp / f"{key}.npz")
        np.savez(path, **{k: np.asarray(v, np.float32)
                          for k, v in jp.items()})
        configs[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jp, path=path,
                            params=cases.load_params(tcfg, path))
    cells = {}
    for name, (key, mode, shape, rows) in CELLS.items():
        c = configs[key]
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, c["tcfg"].vocab, (rows, P))
        src = rng.normal(0, 1, (rows, P, c["tcfg"].d_model)).astype(
            np.float32) if c["tcfg"].family == "encdec" else None
        fed = cases.greedy(c["tcfg"], c["params"], prompt, N, src=src)
        single, routes = cases.one_device(c["tcfg"], c["params"], prompt,
                                          fed, src=src)
        cells[name] = dict(c, mode=mode, shape=shape, prompt=prompt, src=src,
                           fed=fed, single=single, routes=routes)
    return cells


def _job(s, fault=None):
    return ("serve", dict(cfg=s["tcfg"], params=s["path"], prompt=s["prompt"],
                          fed=s["fed"], serve_mode=s["mode"], src=s["src"],
                          decode_shape=s["shape"], fault=fault))


@pytest.fixture(scope="module")
def world(setup):
    """Every cell's and every planted fault's results, rank by rank."""
    jobs = [_job(setup[name]) for name in CELLS] + \
        [_job(setup["mamba2"], fault) for fault in FAULTS]
    ranks = tmesh.spawn(cases.run_jobs, *MESH, backend="gloo", device="cpu",
                        timeout_s=WORLD_TIMEOUT_S, args=(jobs,))
    names = list(CELLS) + list(FAULTS)
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


def _src_struct(s):
    prompt = np.asarray(s["prompt"], np.int32)
    if s["src"] is None:
        return prompt
    return {"tokens": prompt, "src_embeds": jax.numpy.asarray(
        s["src"], jax.numpy.bfloat16)}


def _reference_cells(s):
    """The reference's sharded prefill and decode cells on a 2 x 2 JAX
    mesh, fed the same prompt and tokens: their logits.  The prefill's
    self-attention rows are padded to ``T`` on the host; a one-row prompt
    is prefilled unsharded."""
    jcfg, jp = s["jcfg"], s["jparams"]
    rows = s["prompt"].shape[0]
    mesh = jmesh.make_mesh(MESH, ("data", "model"),
                           devices=jax.devices()[:math.prod(MESH)])
    prompt = _src_struct(s)
    try:
        if rows == 1:
            mod = japi.build(jcfg)
            logits, cache = jax.jit(lambda p, x: mod.prefill(
                jcfg, p, x, max_len=P))(jp, prompt)
        else:
            pc = jspecs.build_prefill_cell(
                jcfg, JShape("prefill_32k", P, rows, "prefill"), mesh,
                weights="bf16")
            with jax.set_mesh(mesh):
                args = jax.device_put((jp, prompt), pc.in_shardings)
                logits, cache = jax.jit(
                    pc.fn, in_shardings=pc.in_shardings,
                    out_shardings=pc.out_shardings)(*args)
        out = [np.asarray(logits, np.float32)[:, -1]]
        pad = [(0, 0), (0, 0), (0, T - P), (0, 0), (0, 0)]
        cache = {k: np.pad(np.asarray(v), pad) if k in ("k", "v")
                 else np.asarray(v) for k, v in cache.items()}
        dc = jspecs.build_decode_cell(
            jcfg, JShape(s["shape"], T, rows, "decode"), mesh,
            weights="bf16", serve_mode=s["mode"])
        step = jax.jit(dc.fn, in_shardings=dc.in_shardings,
                       out_shardings=dc.out_shardings)
        with jax.set_mesh(mesh):
            jp, cache = jax.device_put((jp, cache), (dc.in_shardings[0],
                                                     dc.in_shardings[2]))
            for i in range(N):
                tok, pos = jax.device_put(
                    (np.asarray(s["fed"][:, i:i + 1], np.int32),
                     np.int32(P + i)), (dc.in_shardings[1],
                                        dc.in_shardings[3]))
                logits, cache = step(jp, tok, cache, pos)
                out.append(np.asarray(logits, np.float32)[:, -1])
    finally:
        jspecs.clear_contexts()
    return out


@pytest.fixture(scope="module")
def reference(setup):
    """Every cell's reference logits, the reference's cells jitted once
    for the module."""
    return {name: _reference_cells(setup[name]) for name in CELLS}


def _bf16_step(x: float) -> float:
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def _near_tie_equal(got, want, rows):
    for r in rows:
        best = float(want[r].max())
        gap = best - float(want[r, int(got[r].argmax())])
        assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (r, gap)


def _compared_rows(s, ranks):
    """For each step, the rows compared with one device
    (:func:`torch_sharded_cases.compared_rows`)."""
    return cases.compared_rows(cases.whole_routes(ranks), s["routes"],
                               s["prompt"].shape[0], N + 1, NEAR_TIE_STEPS)


@pytest.mark.parametrize("name", list(CELLS))
def test_cells_match_reference_sharded_cells(setup, world, reference, name):
    ranks = world[name]
    for step, (g, w) in enumerate(zip(ranks[0]["logits"], reference[name])):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")
    for r in ranks[1:]:
        for a, b in zip(r["logits"], ranks[0]["logits"]):
            np.testing.assert_array_equal(a, b)
    assert all(r["sharded_compute"] for r in ranks)


@pytest.mark.parametrize("name", list(CELLS))
def test_cells_match_one_device(setup, world, name):
    s, ranks = setup[name], world[name]
    got = ranks[0]["logits"]
    assert len(got) == N + 1
    rows = _compared_rows(s, ranks)
    assert sum(map(len, rows)) >= len(s["prompt"]) * (N + 1) // 2, rows
    for step, (g, w, keep) in enumerate(zip(got, s["single"], rows)):
        np.testing.assert_allclose(g[keep], w[keep], atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")
        _near_tie_equal(g, w, keep)


def test_greedy_tokens_equal_one_device_up_to_near_ties(setup, world):
    """Each cell's argmax at every decode step picks the single device's
    fed token, or a near-tie."""
    for name in CELLS:
        s, ranks = setup[name], world[name]
        got = ranks[0]["logits"]
        rows = _compared_rows(s, ranks)
        exact = 0
        for i in range(N):
            exact += int((got[i][rows[i]].argmax(-1)
                          == s["fed"][rows[i], i]).sum())
            _near_tie_equal(got[i], s["single"][i], rows[i])
        assert exact >= len(s["prompt"]) * N // 2, (name, exact)


def test_cache_placement(setup, world):
    """Each rank's block of the cache: rows over data (not for one row or
    the stationary state's activation rows), an SSM's inner channels and
    heads over model, the KV heads over model, and for the long decode
    the KV rows' T over data."""
    m = setup["mamba2"]["tcfg"]
    ssm = m.ssm
    Din, H = ssm.d_inner(m.d_model), ssm.n_heads(m.d_model)
    K, NS, Pd = ssm.d_conv - 1, ssm.d_state, ssm.head_dim
    for name in ("mamba2", "mamba2-stationary"):
        for r in world[name]:
            assert r["cache_shapes"] == {
                "conv_x": (m.n_layers, B // 2, K, Din // 2),
                "conv_bc": (m.n_layers, B // 2, K, 2 * NS),
                "ssm": (m.n_layers, B // 2, H // 2, Pd, NS)}, r
    j = setup["jamba"]["tcfg"]
    jd, jH = j.ssm.d_inner(j.d_model), j.ssm.n_heads(j.d_model)
    nm = j.attn_period - 1
    for name, rows, t in (("jamba", B // 2, T), ("jamba-long", 1, T // 2)):
        for r in world[name]:
            sh = r["cache_shapes"]
            assert sh["k"] == (1, rows, t, j.n_kv_heads // 2, j.hd), sh
            assert sh["conv_x"] == (1, nm, rows, K, jd // 2), sh
            assert sh["ssm"] == (1, nm, rows, jH // 2, Pd, j.ssm.d_state)
    e = setup["seamless"]["tcfg"]
    for r in world["seamless"]:
        sh = r["cache_shapes"]
        assert sh["k"] == (e.n_layers, B // 2, T, e.n_kv_heads // 2, e.hd)
        assert sh["xk"] == (e.n_layers, B // 2, P, e.n_kv_heads // 2, e.hd)
    # sequence-parallel prefill carries but the hybrid's
    for name in ("mamba2", "seamless"):
        assert all(r["collectives"]["reduce_scatter"] > 0
                   for r in world[name])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_layout_fails(setup, world, fault):
    """A rank's gated norm over its block of the inner channels only, or
    its z / x halves of ``in_zx`` taken without the re-blocking: the
    prefill's logits miss one device's by more than ``ATOL``."""
    got = world[fault][0]["logits"][0]
    want = setup["mamba2"]["single"][0]
    assert float(np.abs(got - want).max()) > ATOL
