"""Compressed-resident serving of the port against its dense-resident engine
and the JAX package's, on the CPU (counterpart of
``tests/test_resident_serving.py`` and
``tests/differential/test_fused_serving_identity.py``).

Reduced qwen3-1.7b (4 layers, d_model 128), weights from
``jax.random.PRNGKey(0)``, one container the JAX package writes with
1,024-symbol segments (every layer slice is a whole number of segments
that tile its rows, so every matrix takes the fused path); the port loads
it.  Batch 2, prompt 8, 4 greedy tokens.

* The port's per-layer plan, slots and byte accounting equal the JAX
  package's, and so does its fused / fallback partition with its reasons
  (the reasons are compared letter for letter), for the default container,
  a mixed rANS-4 + Huffman-8 one, and one whose 1,000-symbol segments tile
  nothing.
* Greedy tokens of the port's compressed-resident engine, unfused and
  fused, equal the port's dense-resident tokens **bitwise** (one device, the
  same ops in the same order), and equal the JAX package's resident tokens
  under the near-tie rule of ``tests/test_torch_serve.py``: the attention
  score product sums in another order than XLA's CPU dot, so a bf16 logit
  may move one step, which flips a greedy choice only where the reference's
  two best logits are within two bf16 steps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.quant import Granularity as JGranularity
from repro.core.scheduler import plan_execution as jplan_execution
from repro.core.spec import CompressionSpec as JSpec
from repro.core.spec import spec_from_legacy as jspec_from_legacy
from repro.core.store import CompressedModel as JModel
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.resident import CompressedResidentWeights as JResident
from repro_torch.configs import registry as treg
from repro_torch.core import decode_backends as tdb
from repro_torch.core.scheduler import (decode_execution_step, iter_seg_runs,
                                        plan_execution, tensor_segments)
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.kernels.fused_decode_matmul import FusedQT
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models.layers import QT, QT4
from repro_torch.serving import engine as tengine
from repro_torch.serving.resident import CompressedResidentWeights

B, PROMPT, GEN, MAX_LEN = 2, 8, 4, 16
SEGMENT = 1024
CHUNK = 64 * 1024
NEAR_TIE_STEPS = 2
MIXED = (f"defaults:segment_symbols={SEGMENT};"
         f"layers/*w_*:bits=4,codec=rans")


def _short(name):
    return name.split("/", 1)[1]


def _containers(host, jspec, tmp_path):
    jcm = JModel.compress(host, spec=jspec)
    path = str(tmp_path / "model.npz")
    jcm.save(path)
    return jcm, TModel.load(path)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    jcm, tcm = _containers(host, jspec_from_legacy(
        8, JGranularity.PER_CHANNEL, segment_symbols=SEGMENT),
        tmp_path_factory.mktemp("resident"))
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, PROMPT))
    dense = tengine.load_params_from_compressed(tcm, device="cpu")
    unfused = CompressedResidentWeights(tcm, tcfg, chunk_symbols=CHUNK,
                                        device="cpu")
    fused = CompressedResidentWeights(tcm, tcfg, chunk_symbols=CHUNK,
                                      fused=True, device="cpu")
    yield dict(jcfg=jcfg, tcfg=tcfg, host=host, jcm=jcm, tcm=tcm,
               prompt=prompt, dense=dense, unfused=unfused, fused=fused)
    unfused.close()
    fused.close()


def _sc():
    return tengine.ServeConfig(max_len=MAX_LEN)


def _generate(cfg, weights, prompt, resident="compressed"):
    eng = tengine.Engine(cfg, weights, _sc(), device="cpu",
                         resident=resident)
    out = eng.generate(prompt, GEN)
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, GEN)
    return out.numpy()


# ------------------------------------------------------------- plan level

def test_execution_plan_equals_reference(harness):
    h = harness
    names = h["unfused"]._hosted
    assert names == JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK,
                              prefetch=False)._hosted
    got = plan_execution(h["tcm"], 4, names)
    want = jplan_execution(h["jcm"], 4, names)
    flat = lambda plan: [  # noqa: E731
        (st.layer, st.table_id, [(sp.tensor, sp.trim, sp.count,
                                  [s.index for s in sp.segs])
                                 for sp in st.spans])
        for steps in plan for st in steps]
    assert flat(got) == flat(want)
    per_tensor = {n: 0 for n in names}
    for steps in got:
        for st in steps:
            for sp in st.spans:
                per_tensor[sp.tensor] += sp.count
    assert per_tensor == {n: h["tcm"].tensors[n].n_symbols for n in names}


def test_iter_seg_runs_respects_budget(harness):
    cm = harness["tcm"]
    segs = tensor_segments(cm, harness["unfused"]._hosted[0])
    runs = list(iter_seg_runs(segs, 2 * SEGMENT))
    assert [s.index for r in runs for s in r] == [s.index for s in segs]
    assert all(len(r) == 1 or sum(s.count for s in r) <= 2 * SEGMENT
               for r in runs)
    assert list(iter_seg_runs(segs, None)) == [segs]


def test_layer_slots_match_stacked_loader(harness):
    """Per-layer decode reproduces the whole-model loader's stacked QT
    slices byte for byte; fused slots hold handles instead."""
    h = harness
    for l in (0, 3):
        slot = h["unfused"].get(l)
        for name in h["unfused"]._hosted:
            got, stacked = slot[_short(name)], h["dense"][name]
            assert type(got) is type(stacked)
            for g, s in zip(got, stacked):
                assert torch.equal(g, s[l]), name
        for name, w in h["unfused"].stacked.items():
            assert torch.equal(slot[_short(name)], h["dense"][name][l])
        fslot = h["fused"].get(l)
        for name in h["fused"]._fused:
            assert isinstance(fslot[_short(name)], FusedQT)


# ----------------------------------------------------------- engine level

def _reference(h):
    """JAX resident (fused) tokens and the per-step logits of the JAX
    package's step functions on the same prompt."""
    jres = JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK, fused=True)
    sc = jengine.ServeConfig(max_len=MAX_LEN)
    want = np.asarray(jengine.Engine(h["jcfg"], jres, sc,
                                     resident="compressed").generate(
        jnp.asarray(h["prompt"], jnp.int32), GEN))
    jparams = jengine.load_params_from_compressed(h["jcm"], backend="numpy")
    steps = jengine.ServeSteps(h["jcfg"], sc)
    logits, cache = steps.prefill_fn(jparams,
                                     jnp.asarray(h["prompt"], jnp.int32))
    out, toks = [], []
    for i in range(GEN):
        lg = np.asarray(logits, np.float32)[:, -1]
        out.append(lg)
        toks.append(np.argmax(lg, axis=-1))
        if i + 1 < GEN:
            logits, cache = steps.decode_fn(
                jparams, jnp.asarray(toks[-1][:, None], jnp.int32), cache,
                jnp.int32(PROMPT + i))
    np.testing.assert_array_equal(np.stack(toks, axis=1), want)
    return want, np.stack(out)


def _equal_up_to_near_tie(got, want, ref_logits):
    compared = 0
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            compared += got.shape[1]
            continue
        d = int(diff[0])
        best = float(ref_logits[d, r, want[r, d]])
        gap = best - float(ref_logits[d, r, got[r, d]])
        step = 2.0 ** (math.frexp(abs(best))[1] - 8)
        assert gap <= NEAR_TIE_STEPS * step, (r, d, gap)
        compared += d + 1
    return compared


def test_greedy_tokens_fused_unfused_dense_reference(harness):
    h = harness
    dense = _generate(h["tcfg"], h["dense"], h["prompt"], resident="dense")
    np.testing.assert_array_equal(
        _generate(h["tcfg"], h["unfused"], h["prompt"]), dense)
    np.testing.assert_array_equal(
        _generate(h["tcfg"], h["fused"], h["prompt"]), dense)
    want, ref_logits = _reference(h)
    assert _equal_up_to_near_tie(dense, want, ref_logits) >= B


def test_prefill_logits_equal_dense_bitwise(harness):
    h = harness
    tok = torch.as_tensor(h["prompt"])
    with torch.inference_mode():
        ld, cd = tengine.ServeSteps(h["tcfg"], _sc()).prefill_fn(
            h["dense"], tok)
        steps = tengine.ServeSteps(h["tcfg"], _sc(), resident="compressed")
        lf, cf = steps.prefill_fn(h["fused"], tok)
    assert torch.equal(ld, lf)
    assert torch.equal(cd["k"], cf["k"]) and torch.equal(cd["v"], cf["v"])


# ---------------------------------------------------- partition and bytes

def _resident_pair(h, spec, tmp_path):
    jcm, tcm = _containers(h["host"], spec, tmp_path)
    jw = JResident(jcm, h["jcfg"], chunk_symbols=CHUNK, fused=True,
                   prefetch=False)
    tw = CompressedResidentWeights(tcm, h["tcfg"], chunk_symbols=CHUNK,
                                   fused=True, prefetch=False, device="cpu")
    return jcm, tcm, jw, tw


def _assert_partition_and_bytes_equal(jw, tw):
    assert tw._fused == jw._fused
    assert tw._hosted == jw._hosted
    assert tw.fused_fallback == jw.fused_fallback
    assert tw.resident_bytes() == jw.resident_bytes()
    for fn in ("peak_resident_bytes", "dense_resident_bytes",
               "dense_bf16_bytes"):
        assert getattr(tw, fn)() == getattr(jw, fn)(), fn
    assert tw.peak_resident_bytes() < tw.dense_bf16_bytes()


def test_default_partition_and_bytes_equal_reference(harness):
    h = harness
    jw = JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK, fused=True,
                   prefetch=False)
    _assert_partition_and_bytes_equal(jw, h["fused"])
    assert h["fused"]._fused and not h["fused"].fused_fallback
    ju = JResident(h["jcm"], h["jcfg"], chunk_symbols=CHUNK, prefetch=False)
    assert h["unfused"].resident_bytes() == ju.resident_bytes()
    b = h["unfused"].resident_bytes()
    assert h["unfused"].peak_resident_bytes() == sum(b.values()) \
        + b["layer_slot"]


def test_mixed_rans4_huffman8_partition_and_tokens(harness, tmp_path):
    h = harness
    _, tcm, jw, tw = _resident_pair(h, JSpec.parse(
        MIXED, default_granularity=JGranularity.PER_CHANNEL), tmp_path)
    assert sorted(tcm.tables) == ["huffman8", "rans4"]
    _assert_partition_and_bytes_equal(jw, tw)
    handles = [fq for slots in tw._fused_slots for fq in slots.values()]
    assert {fq.family for fq in handles} == {"prefix", "tans"}
    assert {fq.bits for fq in handles} == {4, 8}
    dense = tengine.load_params_from_compressed(tcm, device="cpu")
    np.testing.assert_array_equal(
        _generate(h["tcfg"], tw, h["prompt"]),
        _generate(h["tcfg"], dense, h["prompt"], resident="dense"))


def test_misaligned_segments_fall_back_per_tensor(harness, tmp_path):
    h = harness
    _, tcm, jw, tw = _resident_pair(h, jspec_from_legacy(
        8, JGranularity.PER_CHANNEL, segment_symbols=1000), tmp_path)
    assert not tw._fused
    assert sorted(tw.fused_fallback) == sorted(tw._hosted)
    _assert_partition_and_bytes_equal(jw, tw)
    slot = tw.get(0)
    assert all(isinstance(slot[_short(n)], (QT, QT4)) for n in tw._hosted)
    dense = tengine.load_params_from_compressed(tcm, device="cpu")
    np.testing.assert_array_equal(
        _generate(h["tcfg"], tw, h["prompt"]),
        _generate(h["tcfg"], dense, h["prompt"], resident="dense"))


# ------------------------------------------------------------- decode step

def test_decode_goes_into_the_preallocated_buffer(harness):
    h = harness
    w = h["unfused"]
    step = w.plan[1][0]
    buf = np.full(w._buf.shape, -1, np.int32)
    got = decode_execution_step(h["tcm"], step, tdb.get_backend("torch"),
                                out=buf, chunk_symbols=CHUNK)
    assert (buf != -1).any()
    want = decode_execution_step(h["tcm"], step, tdb.get_backend("numpy"))
    assert sorted(got) == sorted(want)
    for name in got:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].dtype == np.uint8
    with pytest.raises(ValueError, match="too small"):
        decode_execution_step(h["tcm"], step, tdb.get_backend("torch"),
                              out=np.zeros((2, 8), np.int32))


def test_wait_prefetches_leaves_each_for_its_get(harness):
    """``wait_prefetches`` returns once every decode in flight is done and
    leaves each queued, so a count read after it does not race the worker
    and the next ``get`` is a hit."""
    from repro_torch.obs import metrics as obs_metrics
    w = CompressedResidentWeights(harness["tcm"], harness["tcfg"],
                                  chunk_symbols=CHUNK, device="cpu")
    assert w.wait_prefetches() == 0
    w.prefetch(1)
    w.prefetch(1)                          # already in flight: no-op
    assert w.wait_prefetches() == 1
    hits = obs_metrics.counter("resident.prefetch_hit")
    before = hits.total()
    slot = w.get(1)
    assert hits.total() == before + 1
    assert w.wait_prefetches() == 0
    for name, want in w._decode_layer(1).items():
        got = slot[name]
        for a, b in zip(got, want) if isinstance(got, tuple) else [(got,
                                                                    want)]:
            assert torch.equal(a, b), name
    w.close()


# ------------------------------------------------------------- guardrails

def test_resident_mode_guardrails(harness):
    with pytest.raises(ValueError, match="resident"):
        tengine.ServeSteps(harness["tcfg"], _sc(), resident="bogus")
    ssm = treg.reduced(treg.get("mamba2-370m"))
    assert not tapi.supports_resident_serving(ssm)
    assert tapi.supports_fused_resident(harness["tcfg"])
    with pytest.raises(NotImplementedError, match="per-layer"):
        tengine.ServeSteps(ssm, _sc(), resident="compressed")
    # no device named: the card, which this host lacks
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompressedResidentWeights(harness["tcm"], harness["tcfg"])


@pytest.mark.parametrize("argv,message", [
    (["--fused"], "require --resident compressed"),
    (["--resident", "compressed", "--no-quantized-serving"],
     "always serves QT"),
    (["--resident", "compressed", "--fused-impl", "pallas"],
     "not ported yet"),
])
def test_launcher_guard_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu", *argv])
    assert e.value.code != 0
    assert message in capsys.readouterr().err


def test_launcher_prints_resident_report(capsys):
    rc = tserve.main([
        "--arch", "qwen3-1.7b", "--batch", "1", "--prompt-len", "4",
        "--gen", "2", "--device", "cpu", "--resident", "compressed",
        "--fused", "--fused-impl", "auto", "--compress-spec",
        f"*:bits=8,codec=huffman; defaults:segment_symbols={SEGMENT}"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("  fused decode→dequant→matmul: 7 tensors")
               and "via plain torch; 0 fall back" in ln for ln in lines)
    assert any(ln.startswith("compressed-resident load [torch]")
               for ln in lines)
    assert any(ln.startswith("  peak resident weights") and "dense bf16"
               in ln for ln in lines)
    assert lines[-1].startswith("generated (1, 2) tokens")
