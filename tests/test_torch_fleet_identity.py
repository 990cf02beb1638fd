"""The port's fleet: N replicas == 1 engine, token for token, on the CPU;
and the same fleet against the JAX package's (counterpart of
``tests/fleet/test_fleet_identity.py``).

Reduced qwen3-1.7b and reduced qwen2-moe-a2.7b at ``capacity_factor`` 8.0
(the reference's harness), weights from ``jax.random.PRNGKey(0)`` crossed
to the port as numpy arrays (``convert.params_from_numpy``).

* The reference's identity tests, parametrised (its hypothesis grid as
  fixed cases): DP fleets over (replica count, policy, trace seed), the
  prefix-shared paged fleet, the disaggregated 1:1 on ``bits=16`` and 1:2
  on ``bits=8,codec=rans``, the wire round-trip byte-equal, and
  ``weight_bytes`` for share against per-replica — each request's tokens
  **bitwise** the port's single engine.
* Against the JAX package, on jobs submitted one a fleet step (so the
  least-loaded policy sees unequal loads): the rid → replica placements
  are equal exactly, and the greedy tokens up to a reference near-tie
  (``tests/test_torch_serve.py``'s rule, the reference's solo logits as
  the oracle).
* The blocks a ``bits=16`` handoff exports have the reference's count,
  shapes and ``kv_len``; layer 0's are bitwise the reference's, the deeper
  layers' within ``BLOCK_STEPS`` bf16 steps of the leaf's largest value
  (the two CPU dots sum attention scores in other orders: ROADMAP queue 3
  item 1).
* The port's ``encode_block_leaves`` on the reference's uint8 wire leaves
  gives the reference's stream bytes.
* A sampled request (temperature 0.8, seed 7) across a 1:1 handoff is
  bitwise the port's single paged engine: its generator state crosses the
  wire with it.  The JAX package cannot be the yardstick here (its PRNG
  differs), so the port is held to itself.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.codecs import get_codec as jget_codec
from repro.core.spec import KVCompressionSpec as JSpec
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.fleet import FleetDriver as JFleet
from repro.serving.kvcache import cold as jcold
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core.codecs import get_codec
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import (ContinuousEngine, SamplingParams,
                                          poisson_trace)
from repro_torch.serving.fleet import POLICIES, FleetDriver
from repro_torch.serving.kvcache.cold import (decode_block_leaves,
                                              encode_block_leaves,
                                              entry_nbytes)
from test_torch_serve import assert_tokens_equal_up_to_near_tie

MAX_LEN = 48
# bf16 K / V of the deeper layers, port vs reference: within this many bf16
# steps at the leaf's largest |value| (the attention-score sums of the layer
# before differ in their last bits, and the K / V of the next inherit it)
BLOCK_STEPS = 4
CPU = torch.device("cpu")


def _cfgs(family):
    """(reference config, port config) of ``family``."""
    out = []
    for reg in (jreg, treg):
        if family == "dense":
            out.append(reg.reduced(reg.get("qwen3-1.7b")))
            continue
        cfg = reg.reduced(reg.get("qwen2-moe-a2.7b"))
        # generous capacity keeps GShard token-dropping packing-independent
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)))
    return out


@pytest.fixture(scope="module", params=["dense", "moe"])
def harness(request):
    jcfg, cfg = _cfgs(request.param)
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    params = convert.params_from_numpy(cfg, host, "cpu")
    sc = tengine.ServeConfig(max_len=MAX_LEN)
    eng = tengine.Engine(cfg, params, sc, device="cpu")
    jsc = jengine.ServeConfig(max_len=MAX_LEN)
    return dict(cfg=cfg, params=params, sc=sc, eng=eng, jcfg=jcfg, jp=jp,
                jsc=jsc, jeng=jengine.Engine(jcfg, jp, jsc))


def _trace_jobs(cfg, seed, n, prefix=False):
    """(prompt, gen) pairs off a Poisson trace (arrival times dropped —
    identity is about content, the fault suite covers pacing)."""
    kw = dict(prefix_pool=2, prefix_len=8) if prefix else {}
    trace = poisson_trace(n, rate_per_s=1e9, prompt_max=16, gen_max=6,
                          vocab=cfg.vocab, seed=seed, **kw)
    return [(p, g) for _, p, g in trace]


def _kw(extra):
    """A job's submit keywords: ``(prompt, gen[, kwargs])``."""
    return extra[0] if extra else {}


def _solo_refs(eng, jobs):
    return [eng.generate(np.asarray(p)[None], g)[0].tolist()
            for p, g in jobs]


def _fleet(h, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("prefill_chunk", 4)
    return FleetDriver(h["cfg"], h["params"], h["sc"], steps=h["eng"].steps,
                       devices=[CPU], **kw)


def _run_fleet(h, jobs, **kw):
    fd = _fleet(h, **kw)
    reqs = [fd.submit(p, g, **_kw(s)) for p, g, *s in jobs]
    fin = {r.rid: r for r in fd.run()}
    assert sorted(fin) == sorted(r.rid for r in reqs)
    return fd, [fin[r.rid].output for r in reqs]


def _single_paged(h, jobs, kv_spec):
    ref = ContinuousEngine(h["cfg"], h["params"], h["sc"], n_slots=2,
                           prefill_chunk=4, steps=h["eng"].steps,
                           kv_spec=kv_spec, device="cpu")
    reqs = [ref.submit(p, g, **_kw(s)) for p, g, *s in jobs]
    ref.run()
    return [r.output for r in reqs]


# --------------------------------------------------------------- DP fleets

@pytest.mark.parametrize("n_replicas,policy,seed", [
    (1, "round-robin", 0), (1, "least-loaded", 1),
    (2, "round-robin", 1), (2, "least-loaded", 2),
    (3, "round-robin", 3), (3, "least-loaded", 0)])
def test_fleet_matches_single_engine(harness, n_replicas, policy, seed):
    jobs = _trace_jobs(harness["cfg"], seed, n=5)
    _, outs = _run_fleet(harness, jobs, n_replicas=n_replicas, policy=policy)
    assert outs == _solo_refs(harness["eng"], jobs)


def test_fleet_identity_survives_prefix_shared_paged_traffic(harness):
    """2-replica paged fleet with prefix sharing == 1 paged engine, on a
    trace of shared system prompts (the sharing fast path must not leak
    across replicas or requests)."""
    kv_spec = KVCompressionSpec.parse("bits=16,block=4,sharing")
    jobs = _trace_jobs(harness["cfg"], seed=1, n=5, prefix=True)
    fd, outs = _run_fleet(harness, jobs, n_replicas=2, policy="least-loaded",
                          kv_spec=kv_spec)
    assert outs == _single_paged(harness, jobs, kv_spec)
    assert sum(h.engine.slots.stats()["shared_hits"]
               for h in fd.replicas) > 0


# ------------------------------------------------------- disaggregated path

@pytest.mark.parametrize("split,spec", [
    ((1, 1), "bits=16,block=8"),
    ((1, 2), "bits=8,codec=rans,block=8"),
])
def test_disaggregated_fleet_matches_single_paged_engine(harness, split,
                                                         spec):
    kv_spec = KVCompressionSpec.parse(spec)
    jobs = _trace_jobs(harness["cfg"], seed=2, n=4)
    fd, outs = _run_fleet(harness, jobs, n_replicas=sum(split),
                          disaggregate=split, kv_spec=kv_spec)
    assert outs == _single_paged(harness, jobs, kv_spec)
    assert fd.handoff.n_handoffs == fd.handoff.n_delivered == len(jobs)
    assert fd.handoff.bytes_on_wire > 0
    assert fd.replicas[0].engine.n_decode_steps == 0   # prefill side only


def test_handoff_wire_format_round_trips_byte_equal(harness):
    """decode(encode(blocks)) is byte-equal and dtype-preserving — the
    cold-tier codec round-trip really is lossless as a wire format."""
    kv_spec = KVCompressionSpec.parse("bits=8,codec=rans,block=8")
    captured = []
    fd = _fleet(harness, n_replicas=2, disaggregate=(1, 1), kv_spec=kv_spec,
                handoff_transport=lambda p: captured.append(p) or 0)
    for p, g in _trace_jobs(harness["cfg"], seed=3, n=3):
        fd.submit(p, g)
    fd.run()
    assert captured
    for payload in captured:
        leaves = payload.decode_blocks()
        assert len(leaves) == -(-payload.kv_len // kv_spec.block_size)
        for block in leaves:
            entry, _, _ = encode_block_leaves(fd.handoff.codec, block)
            again = decode_block_leaves(entry)
            assert set(again) == set(block)
            for name in block:
                assert again[name].dtype == block[name].dtype
                np.testing.assert_array_equal(again[name].view(np.uint8),
                                              block[name].view(np.uint8))


# -------------------------------------------------------- weight accounting

def test_weight_bytes_accounts_share_vs_per_replica(harness):
    h = harness
    shared = _fleet(h, n_replicas=3, n_slots=1)
    wb = shared.weight_bytes()
    assert wb["mode"] == "share" and wb["copies"] == 1
    assert wb["total_bytes"] == wb["bytes_per_copy"] == sum(
        t.numel() * t.element_size() for t in h["params"].values())

    copies = [{k: v.clone() for k, v in h["params"].items()}
              for _ in range(2)]
    per = FleetDriver(h["cfg"], None, h["sc"], steps=h["eng"].steps,
                      n_replicas=2, n_slots=1, replica_params=copies,
                      devices=[CPU])
    wb2 = per.weight_bytes()
    assert wb2["mode"] == "per-replica" and wb2["copies"] == 2
    assert wb2["total_bytes"] == 2 * wb["bytes_per_copy"]
    assert per.replicas[1].engine.params is copies[1]   # placed, not copied

    # per-replica trees still serve bit-identically (same values, same steps)
    jobs = _trace_jobs(h["cfg"], seed=0, n=2)
    rids = [per.submit(p, g).rid for p, g in jobs]
    fin = {r.rid: r for r in per.run()}
    assert [fin[r].output for r in rids] == _solo_refs(h["eng"], jobs)


# ------------------------------------------------- against the JAX package

def _staggered(fd, jobs):
    """Submit one job before each lockstep step, then drain; returns each
    job's request."""
    reqs = []
    for p, g in jobs:
        reqs.append(fd.submit(p, g))
        fd.step()
    fd.run()
    return reqs


def _placements(fd, reqs):
    where = {r.rid: h.idx for h in fd.replicas for r in h.engine.finished}
    return [where[r.rid] for r in reqs]


def _reference_solo_logits(h, prompt, gen):
    """Greedy decode through the JAX package's step functions, keeping each
    step's last-position logits."""
    steps = h["jeng"].steps
    logits, cache = steps.prefill_fn(h["jp"], jnp.asarray(prompt[None]))
    out, toks = [], []
    for i in range(gen):
        out.append(np.asarray(logits, np.float32)[0, -1])
        toks.append(int(np.argmax(out[-1])))
        if i + 1 < gen:
            logits, cache = steps.decode_fn(
                h["jp"], jnp.asarray([[toks[-1]]], jnp.int32), cache,
                jnp.int32(len(prompt) + i))
    return np.asarray(toks), np.stack(out)


@pytest.fixture(scope="module")
def both_fleets(harness):
    """The port's and the JAX package's 3-replica fleets under each policy
    on one staggered job list: (jobs, {policy: (port, reference)})."""
    h = harness
    jobs = _trace_jobs(h["cfg"], seed=5, n=9)
    runs = {}
    for policy in POLICIES:
        kw = dict(n_replicas=3, policy=policy, n_slots=2, max_queue=2,
                  prefill_chunk=4)
        fd = _fleet(h, **kw)
        jfd = JFleet(h["jcfg"], h["jp"], h["jsc"], steps=h["jeng"].steps,
                     **kw)
        runs[policy] = ((fd, _staggered(fd, jobs)),
                        (jfd, _staggered(jfd, jobs)))
    return jobs, runs


@pytest.mark.parametrize("policy", POLICIES)
def test_placements_equal_reference(both_fleets, policy):
    _, runs = both_fleets
    (fd, reqs), (jfd, jreqs) = runs[policy]
    got = _placements(fd, reqs)
    assert got == _placements(jfd, jreqs)
    assert len(set(got)) == 3
    assert fd.n_steps == jfd.n_steps
    assert fd.router.n_dispatched == jfd.router.n_dispatched == len(reqs)


@pytest.mark.parametrize("policy", POLICIES)
def test_greedy_tokens_equal_reference_fleet(harness, both_fleets, policy):
    jobs, runs = both_fleets
    (_, reqs), (_, jreqs) = runs[policy]
    compared = 0
    for (prompt, gen), r, jr in zip(jobs, reqs, jreqs):
        got, want = np.asarray([r.output]), np.asarray([jr.output])
        logits = None
        if not np.array_equal(got, want):
            toks, logits = _reference_solo_logits(harness, prompt, gen)
            assert toks.tolist() == jr.output
            logits = logits[:, None]
        compared += assert_tokens_equal_up_to_near_tie(got, want, logits)
    assert compared >= len(jobs)


def _bf16_values(bits):
    """float32 values of bf16 bit patterns (int16)."""
    return (bits.astype(np.int32) << 16).view(np.float32)


def _captured_handoffs(fleet_cls, h, params, cfg, sc, steps, spec, **kw):
    captured = []
    fd = fleet_cls(cfg, params, sc, steps=steps, n_replicas=2, n_slots=2,
                   prefill_chunk=4, disaggregate=(1, 1), kv_spec=spec,
                   handoff_transport=lambda p: captured.append(p) or 0, **kw)
    for p, g in _trace_jobs(h["cfg"], seed=6, n=3):
        fd.submit(p, g)
    fd.run()
    assert len(captured) == 3
    return captured


def test_exported_bf16_blocks_equal_reference(harness):
    h = harness
    spec = "bits=16,block=8"
    got = _captured_handoffs(FleetDriver, h, h["params"], h["cfg"], h["sc"],
                             h["eng"].steps, KVCompressionSpec.parse(spec),
                             devices=[CPU])
    want = _captured_handoffs(JFleet, h, h["jp"], h["jcfg"], h["jsc"],
                              h["jeng"].steps, JSpec.parse(spec))
    for p, jp in zip(got, want):
        assert (p.kv_len, p.token, len(p.blocks)) == \
            (jp.kv_len, jp.token, len(jp.blocks))
        for j, (block, jblock) in enumerate(zip(p.decode_blocks(),
                                                jp.decode_blocks())):
            assert sorted(block) == sorted(jblock)
            rows = min(8, p.kv_len - 8 * j)      # rows past kv_len: garbage
            for name, leaf in block.items():
                ref = np.asarray(jblock[name])
                assert leaf.dtype == np.int16 and leaf.shape == ref.shape
                np.testing.assert_array_equal(leaf[0, :rows],
                                              ref.view(np.int16)[0, :rows])
                x, y = (_bf16_values(a[:, :rows])
                        for a in (leaf, ref.view(np.int16)))
                step = 2.0 ** (np.floor(np.log2(np.abs(y).max())) - 7)
                np.testing.assert_allclose(x, y, rtol=0,
                                           atol=BLOCK_STEPS * step)


def test_encode_block_leaves_on_reference_leaves_equals_reference(harness):
    """The reference's uint8 wire leaves (8-bit rANS handoff) through the
    port's codec: the same stream bytes, counts and entry bytes."""
    h = harness
    spec = "bits=8,codec=rans,block=8"
    payloads = _captured_handoffs(JFleet, h, h["jp"], h["jcfg"], h["jsc"],
                                  h["jeng"].steps, JSpec.parse(spec))
    codec, jcodec = get_codec("rans"), jget_codec("rans")
    n_streams = 0
    for payload in payloads:
        for jentry in payload.blocks:
            leaves = jcold.decode_block_leaves(jentry)
            host = {k: (np.asarray(v).view(np.int16)
                        if np.asarray(v).dtype.itemsize == 2
                        else np.asarray(v)) for k, v in leaves.items()}
            entry, nsym, nbits = encode_block_leaves(codec, host)
            assert (nsym, nbits) == jcold.encode_block_leaves(jcodec,
                                                              leaves)[1:]
            assert entry_nbytes(entry) == jcold.entry_nbytes(jentry)
            for name, leaf in entry.items():
                ref = jentry[name]
                if host[name].dtype == np.uint8:
                    np.testing.assert_array_equal(leaf.stream, ref.stream)
                    assert (leaf.count, leaf.shape) == (ref.count, ref.shape)
                    n_streams += 1
                else:
                    np.testing.assert_array_equal(
                        leaf, np.asarray(ref).view(np.int16))
    assert n_streams >= 2 * len(payloads)


def test_sampled_request_across_handoff_equals_single_paged_engine(harness):
    """Greedy neighbours and one sampled request through a 1:1 split: the
    sampled tokens continue on the decode replica from the generator
    offset the prefill replica left, bitwise the single paged engine."""
    kv_spec = KVCompressionSpec.parse("bits=16,block=8")
    jobs = _trace_jobs(harness["cfg"], seed=4, n=3)
    sampled = dict(sampling=SamplingParams(temperature=0.8, seed=7))
    jobs.insert(1, (jobs[0][0], 6, sampled))
    fd, outs = _run_fleet(harness, jobs, n_replicas=2, disaggregate=(1, 1),
                          kv_spec=kv_spec)
    want = _single_paged(harness, jobs, kv_spec)
    assert outs == want
    assert fd.handoff.n_delivered == len(jobs)
    greedy = _solo_refs(harness["eng"], [(jobs[0][0], 6)])[0]
    assert outs[1] != greedy              # the sampled lane really sampled
