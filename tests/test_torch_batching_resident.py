"""Continuous batching on compressed-resident fused weights, on the CPU
(counterpart of ``tests/test_resident_serving.py``'s
``test_continuous_batching_bit_identity``).

Reduced qwen3-1.7b, weights from ``jax.random.PRNGKey(0)``, one Huffman-8
container the JAX package writes with 1,024-symbol segments (every layer
slice tiles its rows, so every matrix takes the fused path, here through
the kernels' plain versions; short segments keep the plain decoders quick).
Three ragged requests on three slots, prefill chunks of 8.

* The port's compressed-resident fused ``ContinuousEngine`` gives **bitwise**
  the tokens of the port's dense-resident one, and of each request's solo
  ``Engine.generate`` (one device, the same ops in the same order).
* Its tokens equal the JAX package's compressed-resident continuous
  engine's up to a reference near-tie (``tests/test_torch_serve.py``'s
  rule, with the JAX package's solo step-function logits, which its own
  continuous engine reproduces).
* The chunked prefill of the fused path equals the dense path's bitwise.
"""
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
from repro.serving.batching import ContinuousEngine as JContinuousEngine
from repro.serving.resident import CompressedResidentWeights as JResident
from repro_torch.configs import registry as treg
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import ContinuousEngine
from repro_torch.serving.resident import CompressedResidentWeights
from test_torch_serve import assert_tokens_equal_up_to_near_tie

SEGMENT = 1024
CHUNK = 64 * 1024
MAX_LEN = 24
GEN = 5
SLOTS = 3
PREFILL_CHUNK = 8


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    jcm = JModel.compress(host, spec=jspec_from_legacy(
        8, JGranularity.PER_CHANNEL, segment_symbols=SEGMENT))
    path = str(tmp_path_factory.mktemp("batching_resident") / "model.npz")
    jcm.save(path)
    tcm = TModel.load(path)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, (5 + i,)).astype(np.int32)
               for i in range(3)]
    fused = CompressedResidentWeights(tcm, tcfg, chunk_symbols=CHUNK,
                                      fused=True, device="cpu")
    assert fused._fused and not fused.fused_fallback
    yield dict(jcfg=jcfg, tcfg=tcfg, jcm=jcm, tcm=tcm, prompts=prompts,
               dense=tengine.load_params_from_compressed(tcm, device="cpu"),
               fused=fused)
    fused.close()


def _sc():
    return tengine.ServeConfig(max_len=MAX_LEN)


def _serve(engine, prompts):
    reqs = [engine.submit(p, GEN) for p in prompts]
    engine.run()
    assert all(len(r.output) == GEN for r in reqs)
    return [r.output for r in reqs]


def _jax_solo(cfg, params, prompt):
    """The JAX package's greedy decode of one prompt through its dense
    step functions: tokens (GEN,) and each step's logits (GEN, V)."""
    steps = jengine.ServeSteps(cfg, jengine.ServeConfig(max_len=MAX_LEN))
    logits, cache = steps.prefill_fn(params, jnp.asarray(prompt[None]))
    out, toks = [], []
    for i in range(GEN):
        lg = np.asarray(logits, np.float32)[0, -1]
        out.append(lg)
        toks.append(int(np.argmax(lg)))
        if i + 1 < GEN:
            logits, cache = steps.decode_fn(
                params, jnp.asarray([[toks[-1]]], jnp.int32), cache,
                jnp.int32(len(prompt) + i))
    return np.asarray(toks), np.stack(out)


def test_fused_continuous_equals_dense_and_reference(harness):
    h = harness
    kw = dict(n_slots=SLOTS, prefill_chunk=PREFILL_CHUNK, device="cpu")
    fused = _serve(ContinuousEngine(h["tcfg"], h["fused"], _sc(),
                                    resident="compressed", **kw), h["prompts"])
    dense = _serve(ContinuousEngine(h["tcfg"], h["dense"], _sc(), **kw),
                   h["prompts"])
    assert fused == dense
    solo = tengine.Engine(h["tcfg"], h["dense"], _sc(), device="cpu")
    assert dense == [solo.generate(p[None], GEN)[0].tolist()
                     for p in h["prompts"]]

    jres = JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK, fused=True)
    want = _serve(JContinuousEngine(
        h["jcfg"], jres, jengine.ServeConfig(max_len=MAX_LEN),
        n_slots=SLOTS, prefill_chunk=PREFILL_CHUNK, resident="compressed"),
        h["prompts"])
    jparams = jengine.load_params_from_compressed(h["jcm"], backend="numpy")
    compared = 0
    for got, w, prompt in zip(fused, want, h["prompts"]):
        toks, logits = _jax_solo(h["jcfg"], jparams, prompt)
        assert toks.tolist() == w         # the reference is packing-free
        compared += assert_tokens_equal_up_to_near_tie(
            np.asarray([got]), toks[None], logits[:, None])
    assert compared >= len(h["prompts"])


def test_fused_chunked_prefill_equals_dense_bitwise(harness):
    h = harness
    dense_steps = tengine.ServeSteps(h["tcfg"], _sc())
    fused_steps = tengine.ServeSteps(h["tcfg"], _sc(), resident="compressed")
    assert fused_steps.prefill_chunk_fn == fused_steps._resident_step
    prompt = h["prompts"][2]
    toks = torch.zeros((1, 8), dtype=torch.int64)
    toks[0, :len(prompt)] = torch.from_numpy(prompt.astype(np.int64))
    out = {}
    for name, steps, w in (("dense", dense_steps, h["dense"]),
                           ("fused", fused_steps, h["fused"])):
        cache = steps.mod.init_cache(h["tcfg"], 1, MAX_LEN)
        with torch.inference_mode():
            out[name] = steps.prefill_chunk_fn(w, toks, cache,
                                               torch.zeros(1, dtype=torch.int64))
    assert torch.equal(out["dense"][0], out["fused"][0])
    assert tuple(out["fused"][0].shape) == (1, 8, h["tcfg"].padded_vocab())
    for key in ("k", "v"):
        assert torch.equal(out["dense"][1][key], out["fused"][1][key])
