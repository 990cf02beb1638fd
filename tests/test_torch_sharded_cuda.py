"""Sharded compute on the card: ranks sharing one card over ``gloo``.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_sharded_cuda.py

The machine has one card and NCCL refuses two ranks on one device, so the
ranks share ``cuda:0`` over ``gloo``.  Against one device on the same card:

* the exact combine of attention over a T split 4 ways (a rank whose
  block is masked whole, ragged per-row lengths, a causal chunk), within
  1e-2, and its mutant without the cross-rank max, which must miss;
* a column-parallel then a row-parallel product over 4 ranks, the partial
  sums all-reduced or reduce-scattered along S, within one bf16 step of
  the outputs' scale;
* reduced qwen3-1.7b (2 layers) through the sharded prefill and decode
  cells on 1 x 2 and glm4-9b on 1 x 4 (its cache split along T), and
  reduced mamba2-370m, seamless-m4t-medium (2 layers) and jamba (one
  period) on 1 x 2, logits within 2e-2 of the single device's (a routed
  row up to its first router flip, a near-tie of the router's
  probabilities: the rule of the CPU tests).  jamba's MoE admits every
  routed choice (``capacity_factor`` = E / top_k): the
  sharded dispatch sizes the capacity by each data rank's rows and one
  device by the whole batch's, which drop alike only while nothing is
  dropped;
* reduced qwen3-1.7b (2 layers) through the sharded train cell's step on
  1 x 2 (``tests/torch_sharded_train_cases.py``), against one device's
  on the card: every gradient of one batch within ``GRAD_RTOL`` relative
  L2, then 2 steps' losses and grad norms within ``TRAIN_RTOL``, first
  moments within ``GRAD_RTOL`` and updates within ``UPDATE_RTOL``
  (``tests/test_torch_sharded_train.py``'s limits and reasons).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api, layers

import torch_sharded_cases as cases
import torch_sharded_train_cases as train_cases

TIMEOUT_S = 300
ATOL = 2e-2
NEAR_TIE_STEPS = 2
GRAD_RTOL = 0.05
TRAIN_RTOL = 2e-3
UPDATE_RTOL = 0.25

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _combine_inputs():
    rng = np.random.default_rng(7)
    Bc, H, KV, hd, T = 4, 8, 2, 64, 64
    mk = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    k, v = mk(Bc, T, KV, hd), mk(Bc, T, KV, hd)
    q = mk(Bc, 1, H, hd) * 4
    lens = np.array([3, 17, 40, 64], np.int64)
    return [(q, k, v, 20, False, 19),
            (q, k, v, lens, False, lens - 1),
            (mk(Bc, 5, H, hd) * 4, k, v, 30, True, 25)]


def _unsplit(card, q, k, v, kv_len, causal, q_offset):
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(card)  # noqa: E731
    as_t = lambda a: torch.from_numpy(a).to(card) \
        if isinstance(a, np.ndarray) else a  # noqa: E731
    return layers.gqa_attention(t(q), t(k), t(v), causal=causal,
                                q_offset=as_t(q_offset),
                                kv_len=as_t(kv_len)).float().cpu().numpy()


def test_combine_on_the_card(card):
    inputs = _combine_inputs()
    want = [_unsplit(card, *c) for c in inputs]
    for mutant in (False, True):
        got = tmesh.spawn(cases.combine_cases, 1, 4, backend="gloo",
                          device="cuda", timeout_s=TIMEOUT_S,
                          args=(inputs, mutant))
        worst = max(float(np.abs(g - w).max())
                    for g, w in zip(got[0], want))
        if mutant:
            assert worst > 0.1, worst
        else:
            assert worst <= 1e-2, worst
            for r in got[1:]:
                for a, b in zip(r, got[0]):
                    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sp", [False, True], ids=["all-reduce",
                                                   "reduce-scatter"])
def test_parallel_matmuls_on_the_card(card, sp):
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 16, 256)).astype(np.float32)
    wc = rng.normal(0, 0.05, (256, 512)).astype(np.float32)
    wr = rng.normal(0, 0.05, (512, 256)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16).to(card)  # noqa: E731
    want = (layers.silu(t(x) @ t(wc)) @ t(wr)).float().cpu().numpy()
    got = tmesh.spawn(cases.parallel_matmuls, 1, 4, backend="gloo",
                      device="cuda", timeout_s=TIMEOUT_S,
                      args=(x, wc, wr, sp))
    scale = float(np.abs(want).max())
    step = 2.0 ** (math.frexp(scale)[1] - 8)
    for y, counts in got:
        np.testing.assert_allclose(y, want, atol=step, rtol=0)
        assert counts["reduce_scatter" if sp else "all_reduce"] == 1


def _reduced(arch):
    """The reduced config cut to 2 layers (the hybrid to one period), its
    MoE admitting every choice."""
    cfg = registry.reduced(registry.get(arch))
    cfg = dataclasses.replace(
        cfg, n_layers=cfg.attn_period if cfg.family == "hybrid" else 2)
    if cfg.moe:
        cf = float(cfg.moe.padded_experts(16) // cfg.moe.top_k)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


@pytest.mark.parametrize("arch,model", [
    ("qwen3-1.7b", 2), ("glm4-9b", 4), ("mamba2-370m", 2),
    ("seamless-m4t-medium", 2), ("jamba-1.5-large-398b", 2)])
def test_sharded_cells_on_the_card(card, arch, model):
    cfg = _reduced(arch)
    params = api.build(cfg).init(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, (4, 8))
    src = rng.normal(0, 1, (4, 8, cfg.d_model)).astype(np.float32) \
        if cfg.family == "encdec" else None
    fed = cases.greedy(cfg, params, prompt, 4, card, src=src)
    single, routes = cases.one_device(cfg, params, prompt, fed, card,
                                      src=src)
    got = tmesh.spawn(cases.serve_cells, 1, model, backend="gloo",
                      device="cuda", timeout_s=TIMEOUT_S,
                      args=(cfg, params, prompt, fed, src))
    # a routed row leaves the comparison at a router near-tie flip
    rows = cases.compared_rows(cases.whole_routes(got), routes, 4, 5,
                               NEAR_TIE_STEPS)
    assert sum(map(len, rows)) >= 4 * 5 // 2, rows
    for r in got:
        for step, (g, w, keep) in enumerate(zip(r["logits"], single, rows)):
            np.testing.assert_allclose(g[keep], w[keep], atol=ATOL, rtol=0,
                                       err_msg=f"step {step}")


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_sharded_train_step_on_the_card(card):
    cfg = _reduced("qwen3-1.7b")
    params = api.build(cfg).init(cfg, 0, card)
    rng = np.random.default_rng(2)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)).to(card)}
        for _ in range(2)]
    loss, grads, _ = train_cases.single_grads(cfg, params, batches[0])
    want = train_cases.single_steps(cfg, params, batches)
    host = {n: p.cpu() for n, p in params.items()}
    hb = [{k: v.cpu() for k, v in b.items()} for b in batches]
    got = tmesh.spawn(train_cases.run_jobs, 1, 2, backend="gloo",
                      device="cuda", timeout_s=TIMEOUT_S,
                      args=([("grads", dict(cfg=cfg, params=host,
                                            batch=hb[0])),
                             ("steps", dict(cfg=cfg, params=host,
                                            batches=hb))],))
    init = {n: p.float().numpy() for n, p in host.items()}
    for g, s in got:
        np.testing.assert_allclose(g["loss"], loss, rtol=TRAIN_RTOL)
        for n in grads:
            assert _rel(g["grads"][n], grads[n]) <= GRAD_RTOL, n
        np.testing.assert_allclose(s["losses"], want["losses"],
                                   rtol=TRAIN_RTOL)
        np.testing.assert_allclose(s["grad_norms"], want["grad_norms"],
                                   rtol=TRAIN_RTOL)
        for n, p in want["params"].items():
            assert _rel(s["params"][n] - init[n], p - init[n]) \
                <= UPDATE_RTOL, n
            assert _rel(s["moments"][n], want["moments"][n]) <= GRAD_RTOL, n
