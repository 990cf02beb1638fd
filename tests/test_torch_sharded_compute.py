"""The port's sharded compute (the production cells' layouts: column- and
row-parallel matmuls, sequence-parallel carries, a cache split along its
sequence with an exact partial-softmax combine, the weight-stationary
decode) on the CPU, against the JAX package's sharded cells and one
device.

One spawned ``gloo`` world a mesh shape (``repro_torch.launch.mesh.spawn``,
one process a rank, one intra-op thread each), shared by the module:

* **2 x 2**, reduced qwen3-1.7b and qwen2-moe-a2.7b (every config cut to
  2 layers): their 2 KV heads
  divide the model axis, so the heads split over it and the cache holds a
  rank's head; the 8-token prompt's carry splits along S;
* **1 x 4**, reduced glm4-9b: 2 KV heads do not divide 4, so the cache
  rests split along its sequence over model and decode attends block by
  block with the combine; the unit cases of the combine and of the
  parallel matmuls run in the same world.

In each world the port's prefill cell (4 x 8 prompt into a 12-row cache)
and then its decode cell, fed 4 tokens (the single device's greedy
continuation, teacher-forced so that every variant sees the same inputs),
are held against (a) the reference's cells of the same shapes —
``repro.launch.specs.build_prefill_cell`` / ``build_decode_cell`` on a JAX
mesh of the same shape over the 8 host devices ``tests/conftest.py``
forces, jitted with their in / out shardings, the prefill's cache padded
to 12 rows on the host — and (b) the port on one device.  Both take the
weights the reference made (bf16), carried to the ranks as an npz.

Tolerances: logits within ``ATOL`` (``tests/test_torch_dense.py``'s
attention limit) of both; greedy tokens equal one device's up to a
near-tie (two candidates within ``NEAR_TIE_STEPS`` bf16 steps).  The MoE
config held against one device admits every routed choice
(``capacity_factor`` = E / top_k): a sharded cell sizes the capacity by
each data rank's rows, as the reference's EP body does, one device by the
whole batch's, and the two route alike only while nothing is dropped
(``moe.prefill_chunk``'s contract).  The same config at its own
``capacity_factor`` (``moe_drop``), which drops choices on this input, is
held against the reference's sharded cells, whose drops it must follow.
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
WORLD_TIMEOUT_S = 240
CONFIGS = {"qwen3": ("qwen3-1.7b", (2, 2)), "moe": ("qwen2-moe-a2.7b", (2, 2)),
           "moe_drop": ("qwen2-moe-a2.7b", (2, 2)),
           "glm4": ("glm4-9b", (1, 4))}


def _cfgs(arch, own_capacity: bool = False):
    """Both packages' reduced config of ``arch`` cut to 2 layers; an MoE
    config admits every choice unless ``own_capacity`` keeps its
    ``capacity_factor``."""
    jcfg = dataclasses.replace(jreg.reduced(jreg.get(arch)), n_layers=2)
    tcfg = dataclasses.replace(treg.reduced(treg.get(arch)), n_layers=2)
    if jcfg.moe and not own_capacity:
        cf = float(jcfg.moe.padded_experts(16) // jcfg.moe.top_k)
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=cf))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def few_threads_module():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, few_threads_module):
    """Each config's reference weights (npz), prompt, the single device's
    greedy continuation and its teacher-forced logits."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = {}
    for key, (arch, _) in CONFIGS.items():
        jcfg, tcfg = _cfgs(arch, own_capacity=key == "moe_drop")
        jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
        host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
        path = str(tmp / f"{key}.npz")
        np.savez(path, **host)
        params = cases.load_params(tcfg, path)
        prompt = np.random.default_rng(1).integers(0, tcfg.vocab, (B, P))
        fed = cases.greedy(tcfg, params, prompt, N)
        single, routes = cases.one_device(tcfg, params, prompt, fed)
        out[key] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jp, path=path,
                        prompt=prompt, fed=fed, single=single, routes=routes)
    return out


def _combine_inputs():
    """Split-T attention cases for 4 ranks: T = 16 (4 a rank), GQA 4 / 2
    heads of 32.  (a) lockstep decode at 10: rank 3's block [12, 16) is
    masked whole; (b) ragged per-row kv_len (2, 5, 9, 16): ranks 1-3 see
    whole-block masks on some rows; (c) a causal 3-token chunk at 6."""
    rng = np.random.default_rng(7)
    Bc, H, KV, hd, T = 4, 4, 2, 32, 16
    mk = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    k, v = mk(Bc, T, KV, hd), mk(Bc, T, KV, hd)
    # scores spread over a wide range: one block's max far above another's
    q = mk(Bc, 1, H, hd) * 4
    lens = np.array([2, 5, 9, 16], np.int64)
    return [(q, k, v, 11, False, 10),
            (q, k, v, lens, False, lens - 1),
            (mk(Bc, 3, H, hd) * 4, k, v, 9, True, 6)]


def _matmul_inputs():
    rng = np.random.default_rng(9)
    return (rng.normal(0, 1, (2, 8, 64)).astype(np.float32),
            rng.normal(0, 0.1, (64, 128)).astype(np.float32),
            rng.normal(0, 0.1, (128, 64)).astype(np.float32))


def _serve_job(s, mode="fsdp"):
    return ("serve", dict(cfg=s["tcfg"], params=s["path"], prompt=s["prompt"],
                          fed=s["fed"], serve_mode=mode))


@pytest.fixture(scope="module")
def worlds(setup):
    """The 2 x 2 and 1 x 4 worlds' results, rank by rank."""
    x, wc, wr = _matmul_inputs()
    comb = _combine_inputs()
    jobs22 = [_serve_job(setup["qwen3"]), _serve_job(setup["moe"]),
              _serve_job(setup["qwen3"], "stationary"),
              _serve_job(setup["moe"], "stationary"),
              _serve_job(setup["moe_drop"])]
    jobs14 = [_serve_job(setup["glm4"]),
              ("combine", dict(cases=comb)),
              ("combine", dict(cases=comb, mutant=True)),
              ("matmuls", dict(x=x, w_col=wc, w_row=wr, seq_split=False)),
              ("matmuls", dict(x=x, w_col=wc, w_row=wr, seq_split=True))]
    run = lambda d, m, jobs: tmesh.spawn(  # noqa: E731
        cases.run_jobs, d, m, backend="gloo", device="cpu",
        timeout_s=WORLD_TIMEOUT_S, args=(jobs,))
    r22, r14 = run(2, 2, jobs22), run(1, 4, jobs14)
    return {"qwen3": [r[0] for r in r22], "moe": [r[1] for r in r22],
            ("qwen3", "stationary"): [r[2] for r in r22],
            ("moe", "stationary"): [r[3] for r in r22],
            "moe_drop": [r[4] for r in r22],
            "glm4": [r[0] for r in r14], "combine": [r[1] for r in r14],
            "mutant": [r[2] for r in r14], "matmuls": [r[3] for r in r14],
            "matmuls_sp": [r[4] for r in r14]}


def _reference_cells(s, mesh_shape, mode="fsdp"):
    """The reference's sharded prefill and decode cells on a JAX mesh of
    the same shape, fed the same prompt and tokens: their logits."""
    jcfg, jp = s["jcfg"], s["jparams"]
    mesh = jmesh.make_mesh(mesh_shape, ("data", "model"),
                           devices=jax.devices()[:math.prod(mesh_shape)])
    T = P + N
    try:
        pc = jspecs.build_prefill_cell(jcfg, JShape("prefill_32k", P, B,
                                                    "prefill"), mesh,
                                       weights="bf16")
        with jax.set_mesh(mesh):
            args = jax.device_put(
                (jp, np.asarray(s["prompt"], np.int32)), pc.in_shardings)
            logits, cache = jax.jit(
                pc.fn, in_shardings=pc.in_shardings,
                out_shardings=pc.out_shardings)(*args)
        out = [np.asarray(logits, np.float32)[:, -1]]
        pad = [(0, 0), (0, 0), (0, T - P), (0, 0), (0, 0)]
        cache = {k: np.pad(np.asarray(v), pad) for k, v in cache.items()}
        dc = jspecs.build_decode_cell(jcfg, JShape("decode_32k", T, B,
                                                   "decode"), mesh,
                                      weights="bf16", serve_mode=mode)
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


def _bf16_step(x: float) -> float:
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def _near_tie_equal(got, want, rows=None):
    """Each row's argmax of ``got`` is ``want``'s, or within
    ``NEAR_TIE_STEPS`` bf16 steps of ``want``'s best."""
    for r in range(want.shape[0]) if rows is None else rows:
        best = float(want[r].max())
        gap = best - float(want[r, int(got[r].argmax())])
        assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (r, gap)


def _compared_rows(s, ranks, coupled: bool = False):
    """For each step, the rows whose logits are compared with one device:
    every row, but in the MoE family a row from the step on which a router
    choice first differed from one device's — each such flip asserted a
    near-tie of the probabilities (``tests/test_torch_moe_serving.py``'s
    rule), after which the row's continuation is not compared.  With
    ``coupled`` (a capacity that drops choices, shared by the batch's
    rows) a flip ends the comparison of every row."""
    L = s["tcfg"].n_layers
    start = {}
    got, want = cases.whole_routes(ranks), s["routes"]
    assert len(got) == len(want)
    for c, ((probs, tidx), (_, sidx)) in enumerate(zip(got, want)):
        diff = (np.sort(tidx, -1) != np.sort(sidx, -1)).any(-1)
        for b, pos in zip(*np.nonzero(diff)):
            p = probs[b, pos]
            only_t = np.setdiff1d(tidx[b, pos], sidx[b, pos])
            only_s = np.setdiff1d(sidx[b, pos], tidx[b, pos])
            gap = float(abs(p[only_t].min() - p[only_s].max()))
            assert gap <= NEAR_TIE_STEPS * _bf16_step(p[only_t].min()), \
                (c, b, pos, gap)
            step = 0 if c < L else 1 + (c - L) // L
            for row in range(B) if coupled else (int(b),):
                start[row] = min(start.get(row, N + 1), step)
    return [[b for b in range(B) if start.get(b, N + 1) > i]
            for i in range(N + 1)]


CELLS = [("qwen3", "fsdp"), ("moe", "fsdp"), ("glm4", "fsdp"),
         ("qwen3", "stationary"), ("moe", "stationary")]
# the cells held against the reference's: these, and the MoE config at its
# own capacity, which drops choices as the reference's does
REF_CELLS = CELLS + [("moe_drop", "fsdp")]


def _ranks(worlds, key, mode):
    return worlds[key if mode == "fsdp" else (key, mode)]


@pytest.mark.parametrize("key,mode", REF_CELLS,
                         ids=[f"{k}-{m}" for k, m in REF_CELLS])
def test_cells_match_reference_sharded_cells(setup, worlds, key, mode):
    s = setup[key]
    want = _reference_cells(s, CONFIGS[key][1], mode)
    ranks = _ranks(worlds, key, mode)
    for step, (g, w) in enumerate(zip(ranks[0]["logits"], want)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")
    # every rank returns the same whole logits
    for r in ranks[1:]:
        for a, b in zip(r["logits"], ranks[0]["logits"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("key,mode", CELLS,
                         ids=[f"{k}-{m}" for k, m in CELLS])
def test_cells_match_one_device(setup, worlds, key, mode):
    single = setup[key]["single"]
    ranks = _ranks(worlds, key, mode)
    got = ranks[0]["logits"]
    assert len(got) == N + 1
    rows = _compared_rows(setup[key], ranks)
    assert sum(map(len, rows)) >= B * (N + 1) // 2, rows
    for step, (g, w, keep) in enumerate(zip(got, single, rows)):
        np.testing.assert_allclose(g[keep], w[keep], atol=ATOL, rtol=0,
                                   err_msg=f"step {step}")
        _near_tie_equal(g, w, keep)


def test_greedy_tokens_equal_one_device_up_to_near_ties(setup, worlds):
    """The fed tokens are the single device's greedy ones: each sharded
    cell's argmax at every step picks them, or a near-tie (at least
    ``B * N`` tokens compared a cell)."""
    for key, mode in CELLS:
        fed = setup[key]["fed"]
        single = setup[key]["single"]
        ranks = _ranks(worlds, key, mode)
        got = ranks[0]["logits"]
        rows = _compared_rows(setup[key], ranks)
        exact = 0
        for i in range(N):
            exact += int((got[i][rows[i]].argmax(-1)
                          == fed[rows[i], i]).sum())
            _near_tie_equal(got[i], single[i], rows[i])
        assert exact >= B * N // 2, (key, mode, exact)


def test_cache_placement(setup, worlds):
    """2 x 2: rows over data, the KV heads over model (one a rank); 1 x 4:
    the sequence over model (12 / 4 rows a rank, both KV heads)."""
    L = setup["qwen3"]["tcfg"].n_layers
    T, hd = P + N, setup["qwen3"]["tcfg"].hd
    for key, shape in (("qwen3", (L, B // 2, T, 1, hd)),
                       ("moe", (setup["moe"]["tcfg"].n_layers, B // 2, T, 1,
                                hd)),
                       (("qwen3", "stationary"), (L, B // 2, T, 1, hd)),
                       ("glm4", (setup["glm4"]["tcfg"].n_layers, B, T // 4, 2,
                                 setup["glm4"]["tcfg"].hd))):
        for r in worlds[key]:
            assert r["cache_shape"] == shape, (key, r["cache_shape"])
    # the prompt's carry splits along S: the row-parallel sums of the
    # prefill are reduce-scatters
    assert all(r["collectives"]["reduce_scatter"] > 0
               for r in worlds["qwen3"])


def _unsplit(q, k, v, kv_len, causal, q_offset):
    import torch
    from repro_torch.models import layers
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    as_t = lambda a: (torch.from_numpy(a) if isinstance(a, np.ndarray)  # noqa: E731
                      else a)
    return layers.gqa_attention(t(q), t(k), t(v), causal=causal,
                                q_offset=as_t(q_offset),
                                kv_len=as_t(kv_len)).float().numpy()


def test_combine_equals_unsplit_attention(worlds):
    """Split-T attention with the combine against one block over all of T:
    a rank whose whole block is masked, ragged per-row lengths, a causal
    chunk.  The probabilities are the unsplit softmax's up to the float32
    sum of the exps; the output rounds to bf16 once."""
    for case, got in zip(_combine_inputs(), worlds["combine"][0]):
        want = _unsplit(*case)
        np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    for r in worlds["combine"][1:]:
        for a, b in zip(r, worlds["combine"][0]):
            np.testing.assert_array_equal(a, b)


def test_combine_without_the_max_rescale_fails(worlds):
    """The mutant that takes each block's exps against its own row maxima
    (no all-reduce max) is caught by the comparison above."""
    worst = max(float(np.abs(got - _unsplit(*case)).max())
                for case, got in zip(_combine_inputs(), worlds["mutant"][0]))
    assert worst > 0.1, worst


@pytest.mark.parametrize("sp", [False, True], ids=["all-reduce",
                                                   "reduce-scatter"])
def test_column_then_row_parallel_matmuls(worlds, sp):
    """``x @ w_col`` column-parallel, then ``silu(.) @ w_row`` row-parallel
    over 4 ranks (the partial sums reduced in float32), against one
    device's products: within one bf16 step of the outputs' scale."""
    import torch
    from repro_torch.models import layers
    x, wc, wr = _matmul_inputs()
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    want = (layers.silu(t(x) @ t(wc)) @ t(wr)).float().numpy()
    got, counts = worlds["matmuls_sp" if sp else "matmuls"][0]
    np.testing.assert_allclose(got, want, atol=_bf16_step(
        float(np.abs(want).max())), rtol=0)
    if sp:
        assert counts["reduce_scatter"] == 1 and counts["all_gather"] == 1
    else:
        assert counts["all_reduce"] == 1 and counts["reduce_scatter"] == 0


def _dropped(cfg, routes, blocks: int = 1) -> int:
    """The routed choices dropped (past their expert's capacity) over the
    router calls ``routes``, each call's rows dispatched in ``blocks``
    equal blocks with a capacity of their own (a sharded cell's data
    ranks), else whole (one device): the port's own slot assignment of
    each block's choices, in dispatch order."""
    import torch
    from repro_torch.models import moe
    E, K = cfg.moe.padded_experts(16), cfg.moe.top_k
    n = 0
    for _, idx in routes:
        for part in np.split(idx, blocks):
            C = moe._capacity(part.shape[0] * part.shape[1], K, E,
                              cfg.moe.capacity_factor)
            keep, _ = moe._assign_slots(
                torch.from_numpy(part.reshape(-1)), 0, E, C)
            n += int((~keep).sum())
    return n


def test_moe_drops_follow_the_reference(setup, worlds):
    """Sharded qwen2-moe at its own ``capacity_factor`` on 2 x 2: each data
    rank routes its own rows and sizes the capacity by them, as the
    reference's EP body does, so on this input it drops choices one device
    keeps (the first: router call 1, row 1, position 1, expert 15).  The
    port's sharded router calls, dispatched by data rank, drop more than
    one device's dispatch of the whole batch; the prefill's logits move
    off one device's by more than ``ATOL`` on the rows the drops touch,
    while they match the reference's sharded cell
    (``test_cells_match_reference_sharded_cells[moe_drop-fsdp]``)."""
    s = setup["moe_drop"]
    ranks = worlds["moe_drop"]
    data = CONFIGS["moe_drop"][1][0]
    routes = cases.whole_routes(ranks)
    one = _dropped(s["tcfg"], s["routes"])
    assert one > 0
    assert _dropped(s["tcfg"], routes, data) > one
    # the router sees the same inputs in the first call (layer 0 of the
    # prefill), before any drop differs
    np.testing.assert_array_equal(routes[0][1], s["routes"][0][1])
    moved = np.abs(ranks[0]["logits"][0] - s["single"][0]).max(-1)
    assert (moved > ATOL).any(), moved
