"""The fleet on the card: every request bitwise a single engine's.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_fleet_cuda.py

A reduced qwen3-1.7b with seeded weights made on the card.  A fleet
replica runs the same step shapes as a single ``ContinuousEngine`` with as
many slots (all lanes a decode step, ``(1, chunk)`` a prefill chunk), so on
the card too each request's tokens are **bitwise** the single engine's:

* 2 data-parallel replicas, in lockstep and threaded, the threaded
  workers leaving no allocator memory behind once stopped;
* a 1:1 disaggregated split on ``bits=16`` and on ``bits=8`` blocks,
  against the single paged engine with the same spec;
* a replica killed mid-decode, its requests redriven;
* a sampled request (temperature 0.8) across a 1:1 handoff: its CUDA
  generator's state crosses the wire, and the decode replica continues
  from the same Philox offset.
"""
import gc

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models import dense
from repro_torch.serving import engine
from repro_torch.serving.batching import (ContinuousEngine, SamplingParams,
                                          poisson_trace, replay_fleet)
from repro_torch.serving.fleet import FleetDriver

MAX_LEN = 48
N_SLOTS, CHUNK = 2, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev):
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    params = dense.init(cfg, 0, dev)
    sc = engine.ServeConfig(max_len=MAX_LEN)
    trace = poisson_trace(8, rate_per_s=1e4, prompt_max=16, gen_max=8,
                          vocab=cfg.vocab, seed=3)
    return cfg, params, sc, trace


def _single(cfg, params, sc, jobs, dev, kv_spec=None):
    ce = ContinuousEngine(cfg, params, sc, n_slots=N_SLOTS,
                          prefill_chunk=CHUNK, kv_spec=kv_spec, device=dev)
    reqs = [ce.submit(p, g, **kw) for p, g, kw in jobs]
    ce.run()
    return [r.output for r in reqs]


def _fleet(cfg, params, sc, jobs, dev, **kw):
    fd = FleetDriver(cfg, params, sc, n_slots=N_SLOTS, prefill_chunk=CHUNK,
                     devices=[dev], **kw)
    reqs = [fd.submit(p, g, **skw) for p, g, skw in jobs]
    return fd, reqs


def _jobs(trace):
    return [(p, g, {}) for _, p, g in trace]


@pytest.mark.cuda
def test_dp_fleet_equals_single_engine_on_card(card):
    cfg, params, sc, trace = _setup(card)
    jobs = _jobs(trace)
    want = _single(cfg, params, sc, jobs, card)
    fd, reqs = _fleet(cfg, params, sc, jobs, card, n_replicas=2,
                      policy="least-loaded")
    fd.run()
    assert [r.output for r in reqs] == want
    assert all(len(h.engine.finished) for h in fd.replicas)
    threaded = FleetDriver(cfg, params, sc, n_replicas=2, n_slots=N_SLOTS,
                           prefill_chunk=CHUNK, devices=[card])
    reqs, shed, _ = replay_fleet(threaded, trace, threaded=True)
    assert shed == 0 and [r.output for r in reqs] == want


@pytest.mark.cuda
def test_stopped_workers_release_their_cublas_workspaces(card):
    # each worker thread's cuBLAS handle takes a workspace from the caching
    # allocator; stop_workers frees them, so a threaded fleet that is gone
    # leaves no more allocated than before it was built
    cfg, params, sc, trace = _setup(card)
    _single(cfg, params, sc, _jobs(trace)[:1], card)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    threaded = FleetDriver(cfg, params, sc, n_replicas=2, n_slots=N_SLOTS,
                           prefill_chunk=CHUNK, devices=[card])
    reqs, shed, _ = replay_fleet(threaded, trace, threaded=True)
    assert shed == 0 and all(r.done for r in reqs)
    del threaded, reqs
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) <= before


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["bits=16,block=8",
                                  "bits=8,codec=rans,block=8"])
def test_disaggregated_equals_single_paged_engine_on_card(card, spec):
    cfg, params, sc, trace = _setup(card)
    kv_spec = KVCompressionSpec.parse(spec)
    jobs = _jobs(trace)
    want = _single(cfg, params, sc, jobs, card, kv_spec)
    fd, reqs = _fleet(cfg, params, sc, jobs, card, n_replicas=2,
                      disaggregate=(1, 1), kv_spec=kv_spec)
    fd.run()
    assert [r.output for r in reqs] == want
    assert fd.handoff.n_handoffs == fd.handoff.n_delivered == len(jobs)


@pytest.mark.cuda
def test_killed_replica_redrives_bitwise_on_card(card):
    cfg, params, sc, trace = _setup(card)
    jobs = _jobs(trace)
    want = _single(cfg, params, sc, jobs, card)
    fd, reqs = _fleet(cfg, params, sc, jobs, card, n_replicas=3,
                      policy="least-loaded")
    while fd.replicas[1].engine.n_decode_steps < 3:
        assert fd.step()
    victims = fd.kill_replica(1)
    fin = {r.rid: r for r in fd.run()}
    assert victims and sorted(fin) == sorted(r.rid for r in reqs)
    assert [r.output for r in reqs] == want
    assert all(v.redrives == 1 for v in victims)


@pytest.mark.cuda
def test_sampled_request_across_handoff_on_card(card):
    cfg, params, sc, trace = _setup(card)
    kv_spec = KVCompressionSpec.parse("bits=16,block=8")
    sampled = dict(sampling=SamplingParams(temperature=0.8, seed=7))
    jobs = _jobs(trace)[:3] + [(trace[0][1], 12, sampled)]
    want = _single(cfg, params, sc, jobs, card, kv_spec)
    fd, reqs = _fleet(cfg, params, sc, jobs, card, n_replicas=2,
                      disaggregate=(1, 1), kv_spec=kv_spec)
    fd.run()
    assert [r.output for r in reqs] == want
    greedy = _single(cfg, params, sc, [(trace[0][1], 12, {})], card)[0]
    assert want[-1] != greedy
