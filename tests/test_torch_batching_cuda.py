"""Continuous batching on the card against the same port on the CPU.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_batching_cuda.py

* Per-slot cache writes on the card equal the CPU's bitwise; per-slot
  attention is within ``ATOL`` of the CPU's (the card's matmul and ``exp``
  round in other places), and rows past a slot's ``kv_len`` (filled with
  large values here) do not change it at all.
* A reduced qwen3-1.7b ``ContinuousEngine`` on the card, dense-resident
  (weights decoded by the CUDA decode kernels) and compressed-resident
  fused (the fused kernels inside every step), serves a Poisson trace; each
  request's tokens equal its CPU run's up to a near-tie of the CPU run's
  logits (two candidates within ``NEAR_TIE_STEPS`` bf16 steps), and both
  engines launch their kernels.
* A card engine refuses weights that live on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.quant import Granularity
from repro_torch.core.spec import CompressionSpec
from repro_torch.core.store import CompressedModel
from repro_torch.kernels import build
from repro_torch.models import dense
from repro_torch.models import layers
from repro_torch.serving import engine
from repro_torch.serving.batching import (ContinuousEngine, poisson_trace,
                                          replay)
from repro_torch.serving.resident import CompressedResidentWeights

ATOL = 2e-2
NEAR_TIE_STEPS = 2
MAX_LEN = 40
SPEC = ("*norm*:fp32; layers/wo:bits=8,codec=huffman; "
        "layers/*:bits=4,codec=rans; *:bits=8,codec=huffman; "
        "defaults:segment_symbols=1024")
CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slot_inputs(seed):
    rng = np.random.default_rng(seed)
    B, S, T, H, KV, hd = 3, 4, 32, 16, 8, 128
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16() for shape in ((B, S, H, hd), (B, T, KV, hd),
                                         (B, T, KV, hd)))
    return q, k, v, torch.tensor([0, 9, 20]), torch.tensor([4, 13, 24])


@pytest.mark.cuda
def test_per_slot_cache_writes_equal_cpu(card):
    q, k, v, pos, _ = _slot_inputs(0)
    out = []
    for dev in (card, CPU):
        ck = torch.zeros((3, 32, 8, 128), dtype=torch.bfloat16, device=dev)
        cv = torch.zeros_like(ck)
        layers.update_kv_cache(ck, cv, k[:, :4].to(dev), v[:, :4].to(dev),
                               pos.to(dev))
        out.append((ck.cpu(), cv.cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert bool((out[0][0][1, 9:13] == k[1, :4]).all())


@pytest.mark.cuda
def test_per_slot_attention_matches_cpu_and_ignores_dead_rows(card):
    q, k, v, offsets, lens = _slot_inputs(1)
    kw = dict(causal=True)
    got = layers.gqa_attention(q.to(card), k.to(card), v.to(card),
                               q_offset=offsets.to(card),
                               kv_len=lens.to(card), **kw)
    want = layers.gqa_attention(q, k, v, q_offset=offsets, kv_len=lens, **kw)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=ATOL,
                               rtol=0)
    dead_k, dead_v = k.clone(), v.clone()
    for b, n in enumerate(lens.tolist()):
        dead_k[b, n:] = 3e4
        dead_v[b, n:] = -3e4
    dead = layers.gqa_attention(q.to(card), dead_k.to(card),
                                dead_v.to(card), q_offset=offsets.to(card),
                                kv_len=lens.to(card), **kw)
    assert torch.equal(dead, got)


def _container():
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    spec = CompressionSpec.parse(SPEC,
                                 default_granularity=Granularity.PER_CHANNEL)
    host = {k: w.float().numpy() for k, w in dense.init(cfg, 2, CPU).items()}
    return cfg, CompressedModel.compress(host, spec=spec)


def _cpu_solo_logits(cfg, params, prompt, gen):
    """Greedy decode of one prompt on the CPU through the lockstep steps:
    tokens (gen,) and each step's logits (gen, V)."""
    steps = engine.ServeSteps(cfg, engine.ServeConfig(max_len=MAX_LEN))
    with torch.inference_mode():
        logits, cache = steps.prefill_fn(
            params, torch.as_tensor(prompt[None], dtype=torch.int64))
        toks, out = [], []
        for i in range(gen):
            lg = logits[0, -1].float().numpy()
            out.append(lg)
            toks.append(int(lg.argmax()))
            if i + 1 < gen:
                logits, cache = steps.decode_fn(
                    params, torch.tensor([[toks[-1]]]), cache,
                    len(prompt) + i)
    return toks, np.stack(out)


def _agree_up_to_near_tie(got, want, logits):
    """Equal tokens up to the first difference, which must be a near-tie of
    ``logits``; returns how many tokens were compared."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            best = float(logits[i, w])
            gap = best - float(logits[i, g])
            step = 2.0 ** (math.frexp(abs(best))[1] - 8)
            assert gap <= NEAR_TIE_STEPS * step, (i, g, w, gap)
            return i + 1
    return len(want)


def _serve(cfg, weights, dev, trace, resident):
    ce = ContinuousEngine(cfg, weights, engine.ServeConfig(max_len=MAX_LEN),
                          n_slots=4, prefill_chunk=8, resident=resident,
                          device=dev)
    reqs, shed, _ = replay(ce, trace)
    assert shed == 0 and all(r.output for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("resident", ["dense", "compressed"])
def test_continuous_engine_on_card_agrees_with_cpu(card, resident):
    cfg, cm = _container()
    trace = poisson_trace(4, rate_per_s=200.0, prompt_max=12, gen_max=6,
                          vocab=cfg.vocab, seed=3)
    cpu_dense = engine.load_params_from_compressed(cm, backend="torch",
                                                   device=CPU)
    for k in build.launches:
        build.launches[k] = 0
    if resident == "dense":
        weights = engine.load_params_from_compressed(cm, backend="cuda",
                                                     device=card)
        cpu_weights = cpu_dense
        kernels = ("huffman_decode", "ans_decode")
    else:
        weights = CompressedResidentWeights(cm, cfg, backend="cuda",
                                            fused=True, device=card)
        cpu_weights = CompressedResidentWeights(cm, cfg, backend="torch",
                                                fused=True, device=CPU)
        assert not weights.fused_fallback
        kernels = ("fused_prefix", "fused_tans")
    got = _serve(cfg, weights, card, trace, resident)
    for k in kernels:
        assert build.launches[k] > 0, k
    want = _serve(cfg, cpu_weights, CPU, trace, resident)
    if resident == "compressed":
        weights.close()
        cpu_weights.close()
    compared = 0
    for g, w, (_, prompt, gen) in zip(got, want, trace):
        toks, logits = _cpu_solo_logits(cfg, cpu_dense, prompt, gen)
        assert toks == w            # the CPU run is packing-free
        compared += _agree_up_to_near_tie(g, w, logits)
    assert compared >= len(trace)


@pytest.mark.cuda
def test_card_engine_refuses_cpu_weights(card):
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    params = dense.init(cfg, 0, CPU)
    with pytest.raises(ValueError, match="cannot serve an engine on cuda"):
        ContinuousEngine(cfg, params, engine.ServeConfig(max_len=16),
                         device=card)
