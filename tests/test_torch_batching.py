"""Continuous batching of the port against its own lockstep engine and the
JAX package's, on the CPU (counterpart of
``tests/test_continuous_batching.py``, dense family).

Reduced qwen3-1.7b (4 layers, d_model 128), weights from
``jax.random.PRNGKey(0)`` crossed to the port as numpy arrays
(``convert.params_from_numpy``), dense bf16.

* Per-slot cache writes and per-slot attention masks are **bitwise** equal
  to the JAX package's.  Attention is compared on inputs whose score sums
  are exact in float32 (``tests/test_torch_dense.py`` explains why random
  inputs are not bitwise between the two CPU dots); on random inputs the
  port's packed rows are bitwise its own rows run alone.
* ``prefill_chunk``, chunk by chunk, is within ``ATOL`` = 2e-2 of the port's
  full ``prefill`` (the reference's test) and of the JAX ``prefill_chunk``.
* The port's ``ContinuousEngine`` on a seeded Poisson trace gives every
  request **bitwise** the greedy tokens of its solo port
  ``Engine.generate``, and the JAX package's solo tokens up to a reference
  near-tie (``tests/test_torch_serve.py``'s rule).
* ``poisson_trace`` is bitwise the reference's; queue, slot and engine
  mechanics follow the reference's tests.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.serving import engine as jengine
from repro.serving.batching import traffic as jtraffic
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import (ContinuousEngine, QueueFullError,
                                          Request, RequestQueue, RequestState,
                                          SamplingParams, SlotBatchManager,
                                          poisson_trace, replay)
from test_torch_serve import assert_tokens_equal_up_to_near_tie

MAX_LEN = 48
ATOL = 2e-2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def harness():
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    sc = tengine.ServeConfig(max_len=MAX_LEN)
    eng = tengine.Engine(tcfg, tp, sc, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, sc=sc, eng=eng)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (L,)).astype(np.int32) for L in lens]


def _solo(eng, prompt, steps):
    return eng.generate(prompt[None], steps)[0].tolist()


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _engine(h, **kw):
    return ContinuousEngine(h["tcfg"], h["tp"], h["sc"], device="cpu", **kw)


# --------------------------------------------------------------- layer level

def test_update_kv_cache_per_slot_positions_equal_reference():
    rng = np.random.default_rng(0)
    B, T, KV, hd, S = 3, 12, 2, 4, 2
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.array([0, 3, 10])
    jk, jv = jlayers.update_kv_cache(
        jnp.zeros((B, T, KV, hd), jnp.bfloat16),
        jnp.zeros((B, T, KV, hd), jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos, jnp.int32))
    ck = torch.zeros((B, T, KV, hd), dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    tlayers.update_kv_cache(ck, cv, torch.from_numpy(k).bfloat16(),
                            torch.from_numpy(v).bfloat16(),
                            torch.from_numpy(pos))
    np.testing.assert_array_equal(_np(ck), _np(jk))
    np.testing.assert_array_equal(_np(cv), _np(jv))
    for b, p in enumerate(pos):
        assert float(ck[b, :p].abs().sum()) == 0.0
        assert float(ck[b, p + S:].abs().sum()) == 0.0


def _exact_sum_qkv(B, S, T, H, KV, hd, seed):
    """q of magnitudes in [1, 2), k and v small integers (k mostly zero):
    every score sum is exact in float32 (tests/test_torch_dense.py)."""
    rng = np.random.default_rng(seed)
    q = (rng.choice([-1.0, 1.0], (B, S, H, hd))
         * (1 + rng.integers(0, 128, (B, S, H, hd)) / 128))
    k = rng.integers(-1, 2, (B, T, KV, hd)) * (rng.random((B, T, KV, hd))
                                               < 0.125)
    v = rng.integers(-2, 3, (B, T, KV, hd))
    return [a.astype(np.float32) for a in (q, k, v)]


@pytest.mark.parametrize("S,causal,offsets,lens", [
    (1, False, None, [4, 9, 16]),            # the reference's ragged kv_len
    (1, False, [3, 8, 15], [4, 9, 16]),      # a decode step over slots
    (8, True, [0, 8, 0], [8, 16, 8]),        # prefill chunks at two offsets
])
def test_gqa_attention_per_slot_equals_reference(S, causal, offsets, lens):
    B, T, H, KV, hd = 3, 16, 4, 2, 32
    q, k, v = _exact_sum_qkv(B, S, T, H, KV, hd, seed=S + len(lens))
    kw = dict(causal=causal, kv_len=np.asarray(lens))
    if offsets is not None:
        kw["q_offset"] = np.asarray(offsets)
    tb = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    got = tlayers.gqa_attention(
        tb(q), tb(k), tb(v),
        **{n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    want = jlayers.gqa_attention(
        jb(q), jb(k), jb(v),
        **{n: jnp.asarray(a, jnp.int32) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()})
    assert tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_gqa_attention_packed_rows_equal_solo_rows():
    """On random inputs, row b of a slot batch is bitwise row b run alone
    with its scalar offset and length (per-slot masking keeps lanes
    independent)."""
    rng = np.random.default_rng(1)
    B, S, T, H, KV, hd = 3, 4, 16, 4, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16() for shape in ((B, S, H, hd), (B, T, KV, hd),
                                         (B, T, KV, hd)))
    offsets, lens = [0, 5, 12], [4, 9, 16]
    packed = tlayers.gqa_attention(q, k, v, causal=True,
                                   q_offset=torch.tensor(offsets),
                                   kv_len=torch.tensor(lens))
    for b, (o, n) in enumerate(zip(offsets, lens)):
        solo = tlayers.gqa_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                     causal=True, q_offset=o, kv_len=n)
        assert torch.equal(packed[b:b + 1], solo), b


# --------------------------------------------------------------- model level

def _chunked_prefill(prefill_chunk, init_cache, prompt, chunk, to_pos):
    """Run ``prompt`` chunk by chunk into a fresh cache; the logit at the
    last prompt position and the cache."""
    P = len(prompt)
    padded = np.zeros((1, -(-P // chunk) * chunk), np.int32)
    padded[0, :P] = prompt
    cache, last = init_cache(), None
    for c0 in range(0, padded.shape[1], chunk):
        lg, cache = prefill_chunk(padded[:, c0:c0 + chunk], cache, to_pos(c0))
        if c0 <= P - 1 < c0 + chunk:
            last = lg[:, P - 1 - c0][:, None]
    return last, cache


def test_prefill_chunk_matches_full_prefill_and_reference(harness):
    h = harness
    cfg, tp, mod = h["tcfg"], h["tp"], tapi.build(h["tcfg"])
    jmod = japi.build(h["jcfg"])
    prompt = _prompts(cfg.vocab, [20])[0]
    P = len(prompt)
    with torch.inference_mode():
        full, full_cache = mod.prefill(cfg, tp, torch.as_tensor(prompt[None]),
                                       max_len=MAX_LEN)
        last, cache = _chunked_prefill(
            lambda t, c, p: mod.prefill_chunk(cfg, tp, torch.as_tensor(t),
                                              c, p),
            lambda: mod.init_cache(cfg, 1, MAX_LEN), prompt, 8,
            lambda c0: torch.full((1,), c0))
    jlast, jcache = _chunked_prefill(
        lambda t, c, p: jmod.prefill_chunk(h["jcfg"], h["jp"],
                                           jnp.asarray(t), c, p),
        lambda: jmod.init_cache(h["jcfg"], 1, MAX_LEN), prompt, 8,
        lambda c0: jnp.full((1,), c0, jnp.int32))
    assert tuple(last.shape) == tuple(full.shape) == (1, 1,
                                                      cfg.padded_vocab())
    np.testing.assert_allclose(_np(last), _np(full), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(last), _np(jlast), atol=ATOL, rtol=0)
    # layer 0's rows: everything before attention is bitwise in both
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(cache[key][0, :, :P]),
                                      _np(full_cache[key][0, :, :P]))
        np.testing.assert_array_equal(_np(cache[key][0, :, :P]),
                                      _np(jcache[key][0, :, :P]))
    assert tapi.supports_continuous_batching(cfg)
    assert not tapi.supports_continuous_batching(
        treg.reduced(treg.get("mamba2-370m")))


# -------------------------------------------------------------- engine level

def _jax_solo(h, prompt, gen):
    """The JAX package's greedy decode of one prompt through its step
    functions: tokens (gen,) and each step's last-position logits
    (gen, V)."""
    steps = jengine.ServeSteps(h["jcfg"], jengine.ServeConfig(max_len=MAX_LEN))
    logits, cache = steps.prefill_fn(h["jp"], jnp.asarray(prompt[None]))
    out, toks = [], []
    for i in range(gen):
        lg = np.asarray(logits, np.float32)[0, -1]
        out.append(lg)
        toks.append(int(np.argmax(lg)))
        if i + 1 < gen:
            logits, cache = steps.decode_fn(
                h["jp"], jnp.asarray([[toks[-1]]], jnp.int32), cache,
                jnp.int32(len(prompt) + i))
    return np.asarray(toks), np.stack(out)


def test_poisson_trace_serves_solo_tokens_and_reference(harness):
    """Every request of a Poisson trace (more requests than slots, ragged
    prompts and lengths): bitwise its solo port tokens, and the JAX
    package's solo tokens up to a reference near-tie."""
    h = harness
    trace = poisson_trace(8, rate_per_s=100.0, prompt_max=24, gen_max=8,
                          vocab=h["tcfg"].vocab, seed=0)
    ce = _engine(h, n_slots=3, max_queue=16, prefill_chunk=8)
    reqs, shed, makespan = replay(ce, trace)
    assert shed == 0 and makespan > 0 and len(reqs) == len(trace)
    compared = 0
    for (_, prompt, gen), req in zip(trace, reqs):
        assert req.state is RequestState.FINISHED
        assert req.finish_reason == "length"
        assert req.output == _solo(h["eng"], prompt, gen), req.rid
        want, logits = _jax_solo(h, prompt, gen)
        compared += assert_tokens_equal_up_to_near_tie(
            np.asarray([req.output]), want[None], logits[:, None])
        assert req.ttft_s >= 0 and req.latency_s >= req.ttft_s
        assert req.queue_wait_s >= 0
    assert compared >= len(trace)
    # completed requests detached without stalling the batch
    assert ce.n_decode_steps < sum(g for _, _, g in trace)
    assert not ce.has_work


def test_more_requests_than_slots_match_lockstep(harness):
    """The reference's engine test: six ragged requests, three slots,
    submitted at once and drained with ``run``."""
    h = harness
    jobs = list(zip(_prompts(h["tcfg"].vocab, [20, 11, 7, 25, 5, 16], seed=3),
                    [6, 9, 3, 5, 8, 4]))
    ce = _engine(h, n_slots=3, max_queue=16, prefill_chunk=8)
    rids = [ce.submit(p, g).rid for p, g in jobs]
    fin = {r.rid: r for r in ce.run()}
    assert [fin[r].output for r in rids] == \
        [_solo(h["eng"], p, g) for p, g in jobs]
    assert ce.n_decode_steps < sum(g for _, g in jobs)


def test_eos_detaches_early(harness):
    h = harness
    prompt = _prompts(h["tcfg"].vocab, [9], seed=4)[0]
    ref = _solo(h["eng"], prompt, 8)
    eos = ref[2]                       # force a stop at the third token
    ce = _engine(h, n_slots=2)
    req = ce.submit(prompt, 8, eos_id=eos)
    ce.run()
    assert req.output == ref[:ref.index(eos) + 1]
    assert req.finish_reason == "eos"
    assert ce.slots.n_free == 2


def test_sampled_tokens_follow_the_seed_not_the_packing(harness):
    h = harness
    prompt, other, third = _prompts(h["tcfg"].vocab, [10, 14, 6], seed=5)
    hot = lambda s: SamplingParams(temperature=0.9, seed=s)  # noqa: E731

    def once(seed, neighbours=()):
        ce = _engine(h, n_slots=3)
        for p, sp in neighbours:
            ce.submit(p, 5, sampling=sp)
        r = ce.submit(prompt, 6, sampling=hot(seed))
        ce.run()
        return r.output

    alone = once(7)
    assert alone == once(7)
    assert alone != once(8)            # astronomically unlikely to collide
    assert once(7, [(other, SamplingParams()), (third, hot(9))]) == alone
    assert once(7, [(third, hot(1))]) == alone


def test_request_too_long_for_cache_rejected(harness):
    ce = _engine(harness, n_slots=1)
    with pytest.raises(ValueError, match="cache rows"):
        ce.submit(_prompts(harness["tcfg"].vocab, [MAX_LEN])[0], 4)
    with pytest.raises(ValueError, match="prefill padded"):
        ce.submit(np.ones(MAX_LEN - 1, np.int32), 1)


def test_engine_guardrails(harness):
    h = harness
    ssm = treg.reduced(treg.get("mamba2-370m"))
    with pytest.raises(NotImplementedError, match="slot-batch"):
        ContinuousEngine(ssm, {}, h["sc"], device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(h, prefill_chunk=0)
    # no device named: the card, which this host lacks
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(h["tcfg"], h["tp"], h["sc"])


# ---------------------------------------------------- queue + slot mechanics

def _req(n=4, **kw):
    return Request(prompt=np.ones(n, np.int32), max_new_tokens=2, **kw)


def test_queue_bound_backpressure():
    q = RequestQueue(max_queue=2)
    q.submit(_req())
    q.submit(_req())
    shed = _req()
    with pytest.raises(QueueFullError):
        q.submit(shed)
    assert q.n_rejected == 1 and len(q) == 2
    assert shed.state is RequestState.REJECTED and shed.done
    assert shed.finish_reason == "queue_full"


def test_queue_deadline_expiry_and_request_requeue():
    q = RequestQueue(max_queue=4)
    now = time.monotonic()
    dead, live = _req(deadline_s=0.5), _req(deadline_s=5.0)
    q.submit(dead, now=now)
    q.submit(live, now=now)
    assert q.pop(now=now + 1.0) is live           # dead expired in passing
    assert dead.state is RequestState.EXPIRED and dead.done
    assert dead.finish_reason == "deadline" and q.expired == [dead]
    assert q.pop(now=now + 1.0) is None
    live.output.append(3)
    live.t_admitted = now + 1.0
    live.requeue()
    assert live.state is RequestState.QUEUED and live.redrives == 1
    assert live.output == [] and live.t_admitted is None
    assert live.t_arrival == now                  # deadlines keep counting
    assert not live.expired(now + 4.0) and live.expired(now + 6.0)


def test_slot_manager_alloc_release_compact(harness):
    cfg = harness["tcfg"]
    m = SlotBatchManager(cfg, n_slots=2, max_len=16, device=CPU)
    req = _req()
    slot = m.alloc(req)
    assert slot == 0 and m.n_free == 1 and m.active == [0]
    rc = {k: torch.ones_like(c[:, :1])
          for k, c in tapi.build(cfg).init_cache(cfg, 2, 16).items()}
    m.cache["k"][:, 1] = 2                        # the neighbour's rows
    m.insert(slot, rc, kv_len=4)
    assert m.kv_len[0] == 4
    assert bool((m.cache["k"][:, 0] == 1).all())  # every row of the slot
    assert bool((m.cache["k"][:, 1] == 2).all())
    assert m.release(slot) is req and m.n_free == 2 and m.active == []
    assert float(m.cache["k"][:, 0].abs().sum()) == 0.0   # compacted
    assert bool((m.cache["k"][:, 1] == 2).all())
    assert m.kv_len[0] == 0


def test_slot_exhaustion_returns_none(harness):
    m = SlotBatchManager(harness["tcfg"], n_slots=1, max_len=8, device=CPU)
    assert m.alloc(_req(2)) == 0
    assert m.alloc(_req(2)) is None
    with pytest.raises(ValueError, match="n_slots"):
        SlotBatchManager(harness["tcfg"], n_slots=0, max_len=8, device=CPU)


def test_insert_overwrites_idle_lane_garbage(harness):
    """Idle lanes ride the decode step and write a row at position 0 of
    their slot; the next request's insert must overwrite it."""
    h = harness
    ce = _engine(h, n_slots=2, prefill_chunk=8)
    a = ce.submit(_prompts(h["tcfg"].vocab, [6], seed=8)[0], 6)
    ce.step()                          # a admitted and decoding, slot 1 idle
    ce.step()
    assert float(ce.slots.cache["k"][:, 1, 0].abs().sum()) > 0
    prompt = _prompts(h["tcfg"].vocab, [5], seed=9)[0]
    b = ce.submit(prompt, 4)
    ce.run()
    assert a.output == _solo(h["eng"], a.prompt, 6)
    assert b.output == _solo(h["eng"], prompt, 4)


# ------------------------------------------------------------------ traffic

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("prefix", [{}, dict(prefix_pool=2, prefix_len=6)])
def test_poisson_trace_equals_reference(seed, prefix):
    kw = dict(rate_per_s=50.0, prompt_max=24, gen_max=12, vocab=512,
              seed=seed, **prefix)
    got, want = poisson_trace(9, **kw), jtraffic.poisson_trace(9, **kw)
    assert len(got) == len(want) == 9
    for (ta, tp, tg), (wa, wp, wg) in zip(got, want):
        assert ta == wa and tg == wg
        assert tp.dtype == wp.dtype == np.int32
        np.testing.assert_array_equal(tp, wp)
    assert got[0][0] == 0.0
    # prefix-stable: a shorter trace is a prefix of a longer one
    short = poisson_trace(4, **kw)
    assert all(a == b and np.array_equal(p, q) and g == h
               for (a, p, g), (b, q, h) in zip(short, got))


def test_poisson_trace_clamps_degenerate_bounds():
    trace = poisson_trace(5, rate_per_s=100.0, prompt_max=3, gen_max=1,
                          vocab=64, seed=0)
    assert len(trace) == 5
    assert all(len(p) == 3 and g == 1 for _, p, g in trace)
    assert all(a <= b for (a, *_), (b, *_) in zip(trace, trace[1:]))


def test_replay_sheds_on_full_queue(harness):
    h = harness
    trace = [(0.0, p, 2) for p in _prompts(h["tcfg"].vocab, [5] * 4)]
    ce = _engine(h, n_slots=1, max_queue=2)
    with pytest.raises(QueueFullError):
        replay(ce, trace)
    ce = _engine(h, n_slots=1, max_queue=2)
    reqs, shed, _ = replay(ce, trace, shed_on_full=True)
    assert shed == 2 and reqs[2:] == [None, None]
    assert all(r.output for r in reqs[:2])


def test_launcher_serves_continuous_traffic(capsys):
    from repro_torch.launch import serve as tserve
    rc = tserve.main(["--arch", "qwen3-1.7b", "--batch-slots", "3",
                      "--traffic", "4", "--gen", "4", "--prompt-len", "8",
                      "--device", "cpu", "--decode-backend", "numpy",
                      "--compress-spec",
                      "*:bits=8,codec=huffman; defaults:segment_symbols=4096"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3].startswith("continuous batching [3 slots, queue bound "
                                "64]: 4/4 requests")
    assert lines[-2].startswith("  ttft p50 ") and "fused decode steps" \
        in lines[-2]
    assert lines[-1].startswith("  queue wait [admitted] p50 ")
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-1.7b", "--traffic", "4",
                     "--device", "cpu"])
    assert "--batch-slots" in capsys.readouterr().err


def test_replay_stamps_each_request_in_order(harness):
    """Each request gets a fresh rid and its lifecycle stamps in order."""
    h = harness
    trace = poisson_trace(3, rate_per_s=200.0, prompt_max=8, gen_max=3,
                          vocab=h["tcfg"].vocab, seed=2)
    reqs, _, _ = replay(_engine(h, n_slots=2), trace)
    rids = [r.rid for r in reqs]
    assert rids == sorted(rids) and len(set(rids)) == 3
    for r in reqs:
        assert r.t_arrival <= r.t_admitted <= r.t_first_token \
            <= r.t_finished
