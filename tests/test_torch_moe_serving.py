"""MoE serving through every path the port serves, on the CPU (the MoE half
of ``tests/test_continuous_batching.py``, ``tests/test_resident_serving.py``,
``tests/differential/test_fused_serving_identity.py`` and
``tests/test_kvcache.py``, which run their harnesses over dense and moe).

Reduced qwen2-moe-a2.7b with ``capacity_factor`` 8.0, as the JAX package's
harnesses serve it: capacity follows the tokens in flight, so only a
capacity that admits every choice makes tokens independent of the packing.
Weights from ``jax.random.PRNGKey(0)``; one container the JAX package
writes (Huffman-8, 256-symbol segments, which tile every 2-D layer
matrix's rows, so the CPU's plain decoders take few steps) and the port
loads; the per-layer decode takes 2^18 symbols a call.

* Lockstep: the port's greedy tokens equal the JAX package's
  ``Engine.generate`` up to a reference near-tie of the logits or of the
  router (``tests/test_torch_moe.py``).
* Compressed-resident fused and unfused equal dense-resident bitwise; the
  (L, E, D, F) expert stacks fall back to the per-layer decode with the JAX
  package's reason, and the fused / fallback partition and bytes equal its.
* Continuous batching: packed tokens equal solo tokens bitwise; the low
  capacity warning fires at the published 1.25.
* Paged bf16 blocks equal the slot pool bitwise.
* The launcher serves ``--arch qwen2-moe-a2.7b`` and ``dbrx-132b``
  (reduced) in lockstep, resident fused, continuous and paged modes.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.quant import Granularity as JGranularity
from repro.core.spec import spec_from_legacy as jspec_from_legacy
from repro.core.store import CompressedModel as JModel
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.resident import CompressedResidentWeights as JResident
from repro_torch.configs import registry as treg
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.kernels.fused_decode_matmul import FusedQT
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models.layers import QT, QT4
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import ContinuousEngine
from repro_torch.serving.resident import CompressedResidentWeights
from test_torch_moe import (NEAR_TIE_STEPS, _bf16_step, recorded_routes,
                            route_flips)
from test_torch_resident import _assert_partition_and_bytes_equal

B, PROMPT, GEN, MAX_LEN = 2, 8, 4, 32
SEGMENT = 256
CHUNK = 1 << 18
FALLBACK = "is not a stacked (L, K, N) matrix"
SMALL_SPEC = "*:bits=8,codec=huffman; defaults:segment_symbols=256"


def _cfgs(cf=8.0):
    out = []
    for reg in (jreg, treg):
        cfg = reg.reduced(reg.get("qwen2-moe-a2.7b"))
        out.append(dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    return out


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    jcfg, tcfg = _cfgs()
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    jcm = JModel.compress(host, spec=jspec_from_legacy(
        8, JGranularity.PER_CHANNEL, segment_symbols=SEGMENT))
    path = str(tmp_path_factory.mktemp("moe") / "model.npz")
    jcm.save(path)
    tcm = TModel.load(path)
    dense = tengine.load_params_from_compressed(tcm, device="cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, PROMPT))
    return dict(jcfg=jcfg, tcfg=tcfg, host=host, jcm=jcm, tcm=tcm,
                dense=dense, prompt=prompt,
                sc=tengine.ServeConfig(max_len=MAX_LEN))


def _generate(h, weights, resident="dense", prompt=None, gen=GEN):
    prompt = h["prompt"] if prompt is None else prompt
    eng = tengine.Engine(h["tcfg"], weights, h["sc"], device="cpu",
                         resident=resident)
    out = eng.generate(prompt, gen)
    assert out.dtype == torch.int32 and tuple(out.shape) == (len(prompt),
                                                             gen)
    return out.numpy()


def test_api_supports_every_serving_contract(harness):
    for name in ("qwen2-moe-a2.7b", "dbrx-132b"):
        cfg = treg.reduced(treg.get(name))
        assert tapi.supports_continuous_batching(cfg)
        assert tapi.supports_paged_kv(cfg)
        assert tapi.supports_resident_serving(cfg)
        assert tapi.supports_fused_resident(cfg)


def test_lockstep_tokens_equal_reference(harness):
    """The port's ``Engine.generate`` on the JAX-written container against
    the JAX package's step functions on the same container: each row equal
    up to the first step where the two routers chose differently (a
    near-tie, asserted; from there the row is not compared), and before
    it, up to a reference near-tie of the logits."""
    h = harness
    L = h["tcfg"].n_layers
    jparams = jengine.load_params_from_compressed(h["jcm"], backend="numpy")
    jsc = jengine.ServeConfig(max_len=MAX_LEN)
    with recorded_routes() as (port, ref):
        steps = jengine.ServeSteps(h["jcfg"], jsc)
        logits, cache = steps.prefill_fn(
            jparams, jnp.asarray(h["prompt"], jnp.int32))
        want, lgs = [], []
        for i in range(GEN):
            lgs.append(np.asarray(logits, np.float32)[:, -1])
            want.append(np.argmax(lgs[-1], axis=-1))
            if i + 1 < GEN:
                logits, cache = steps.decode_fn(
                    jparams, jnp.asarray(want[-1][:, None], jnp.int32),
                    cache, jnp.int32(PROMPT + i))
        got = _generate(h, h["dense"])
    want = np.stack(want, axis=1)
    np.testing.assert_array_equal(want, np.asarray(jengine.Engine(
        h["jcfg"], jparams, jsc).generate(jnp.asarray(h["prompt"], jnp.int32),
                                          GEN)))
    # router calls: the prefill's L (token 0), then L a decode step
    first_flip = {}
    for c, b, _ in route_flips(port, ref):
        first_flip.setdefault(b, c // L)
    compared = 0
    for r in range(B):
        n = first_flip.get(r, GEN)
        diff = np.nonzero(got[r, :n] != want[r, :n])[0]
        if len(diff):
            d = int(diff[0])
            best = float(lgs[d][r, want[r, d]])
            gap = best - float(lgs[d][r, got[r, d]])
            assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (r, d, gap)
            n = d + 1
        compared += n
    assert compared >= B


# ------------------------------------------------------------ residency

@pytest.fixture(scope="module")
def resident(harness):
    h = harness
    unfused = CompressedResidentWeights(h["tcm"], h["tcfg"],
                                        chunk_symbols=CHUNK, device="cpu")
    fused = CompressedResidentWeights(h["tcm"], h["tcfg"], chunk_symbols=CHUNK,
                                      fused=True, device="cpu")
    yield unfused, fused
    unfused.close()
    fused.close()


def test_fused_partition_equals_reference(harness, resident):
    """The expert stacks fall back under the reference's reason; the
    attention weights, router and shared experts fuse; partition and
    bytes equal the JAX package's."""
    h = harness
    unfused, fused = resident
    jw = JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK, fused=True,
                   prefetch=False)
    _assert_partition_and_bytes_equal(jw, fused)
    stacks = {f"layers/moe/{n}" for n in ("w_gate", "w_up", "w_down")}
    assert set(fused.fused_fallback) == stacks
    assert all(FALLBACK in r for r in fused.fused_fallback.values())
    assert all(len(h["tcm"].tensors[n].shape) == 4 for n in stacks)
    assert sorted(fused._fused + list(fused.fused_fallback)) == \
        sorted(unfused._hosted)
    short = {n.split("/", 1)[1] for n in fused._fused}
    assert {"wq", "wk", "wv", "wo", "moe/router",
            "moe/shared_w_down"} <= short
    slot = fused.get(0)
    for name in fused._fused:
        assert isinstance(slot[name.split("/", 1)[1]], FusedQT)
    for name in stacks:
        assert isinstance(slot[name.split("/", 1)[1]], (QT, QT4))


def test_resident_tokens_and_logits_equal_dense_bitwise(harness, resident):
    h = harness
    unfused, fused = resident
    dense = _generate(h, h["dense"])
    np.testing.assert_array_equal(_generate(h, unfused, "compressed"), dense)
    np.testing.assert_array_equal(_generate(h, fused, "compressed"), dense)
    tok = torch.as_tensor(h["prompt"])
    with torch.inference_mode():
        ld, cd = tengine.ServeSteps(h["tcfg"], h["sc"]).prefill_fn(
            h["dense"], tok)
        lf, cf = tengine.ServeSteps(h["tcfg"], h["sc"],
                                    resident="compressed").prefill_fn(fused,
                                                                      tok)
    assert torch.equal(ld, lf)
    assert torch.equal(cd["k"], cf["k"]) and torch.equal(cd["v"], cf["v"])


# ------------------------------------------------------- continuous batching

def _jobs(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), g)
            for n, g in ((11, 4), (5, 3), (16, 2), (7, 4))]


def _run(h, jobs, **kw):
    ce = ContinuousEngine(h["tcfg"], h["dense"], h["sc"], n_slots=3,
                          prefill_chunk=8, device="cpu", **kw)
    reqs = [ce.submit(p, g) for p, g in jobs]
    ce.run()
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output for r in reqs]


def test_packed_equals_solo_bitwise(harness):
    """Four requests through 3 slots (one waits for a free slot): each
    request's tokens bitwise its solo ``Engine.generate``."""
    h = harness
    jobs = _jobs(h["tcfg"].vocab)
    solo = [_generate(h, h["dense"], prompt=p[None], gen=g)[0].tolist()
            for p, g in jobs]
    assert _run(h, jobs) == solo


def test_low_capacity_warns(harness):
    _, tcfg = _cfgs(cf=treg.get("qwen2-moe-a2.7b").moe.capacity_factor)
    assert tcfg.moe.capacity_factor * tcfg.moe.top_k < tcfg.moe.num_experts
    with pytest.warns(UserWarning, match="capacity_factor"):
        ContinuousEngine(tcfg, harness["dense"], harness["sc"], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ContinuousEngine(harness["tcfg"], harness["dense"], harness["sc"],
                         device="cpu")


def test_paged_bf16_equals_slot_pool(harness):
    h = harness
    jobs = _jobs(h["tcfg"].vocab)
    want = _run(h, jobs)
    assert _run(h, jobs, kv_spec=KVCompressionSpec(block_size=8)) == want
    assert _run(h, jobs, kv_spec=KVCompressionSpec(
        block_size=8, sharing=True)) == want


# ----------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch,mode", [
    ("qwen2-moe-a2.7b", "lockstep"), ("qwen2-moe-a2.7b", "resident-fused"),
    ("qwen2-moe-a2.7b", "continuous"), ("qwen2-moe-a2.7b", "paged"),
    ("dbrx-132b", "lockstep"), ("dbrx-132b", "continuous"),
    ("dbrx-132b", "paged")])
def test_launcher_serves_moe(arch, mode, capsys):
    flags = {
        "lockstep": ["--batch", "2", "--gen", "2"],
        "resident-fused": ["--batch", "1", "--gen", "2", "--resident",
                           "compressed", "--fused", "--chunk-symbols",
                           str(CHUNK)],
        "continuous": ["--batch-slots", "2", "--traffic", "3", "--gen", "3"],
        "paged": ["--batch-slots", "2", "--traffic", "3", "--gen", "3",
                  "--kv-spec", "bits=16"],
    }[mode]
    rc = tserve.main(["--arch", arch, "--device", "cpu", "--prompt-len", "8",
                      "--compress-spec", SMALL_SPEC, *flags])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    if mode in ("lockstep", "resident-fused"):
        assert out[-1].startswith("generated (")
    else:
        assert any("3/3 requests" in ln for ln in out)
    if mode == "resident-fused":
        assert any(ln.startswith("  fused decode→dequant→matmul:")
                   and "3 fall back" in ln for ln in out)
    if mode == "paged":
        assert any(ln.startswith("  paged KV [bits=16") for ln in out)
