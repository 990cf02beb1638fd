"""The ssm, hybrid and encdec families served on the CPU: the port's
lockstep ``Engine`` against the JAX package's through one container, the
model API's contracts and the launcher (the families' compression specs
are held in ``tests/test_torch_ssm.py`` and ``tests/test_torch_hybrid.py``).

* ``api.build`` returns a module for every config of the registry, and the
  ``supports_*`` answers equal the JAX package's for all of them (only
  dense and moe meet the slot-batch, paged and resident contracts).
* Lockstep: reduced mamba2-370m, jamba-1.5-large-398b (``capacity_factor``
  8.0, so tokens do not depend on the batch) and seamless-m4t-medium; the
  JAX package writes the container under the family's spec (1024-symbol
  segments, so the CPU's plain decoders take few steps), both packages
  load it, and the port's greedy tokens equal the JAX package's
  ``Engine.generate`` up to a reference near-tie of the logits
  (``NEAR_TIE_STEPS`` bf16 steps) or of the router (``tests/
  test_torch_moe.py``), after which a row is not compared.  The JAX
  package's compiled hybrid flips two router near-ties on this container
  that its op-by-op run does not (ROADMAP queue 3, item 6); one of them,
  in the prefill's last MoE block at the first position, reaches no
  sampled token.  The test compares at least ``MIN_COMPARED`` of the
  B x GEN tokens: all 8 of encdec's, 7 of the ssm's and 4 of the
  hybrid's.
* The launcher serves each family lockstep (``--device cpu``), refuses
  ``--batch-slots`` and ``--resident compressed`` with the JAX package's
  messages, and its mamba2 trace passes ``scripts/check_trace.py --expect
  dense-lockstep``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.quant import Granularity as JGranularity
from repro.core.spec import CompressionSpec as JSpec
from repro.core.store import CompressedModel as JModel
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.batching import ContinuousEngine as JContinuous
from repro_torch.configs import registry as treg
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import ContinuousEngine
from test_torch_hybrid import hybrid_routes
from test_torch_moe import NEAR_TIE_STEPS, _bf16_step, route_flips

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

B, PROMPT, GEN, MAX_LEN, SRC = 2, 8, 4, 16, 8
SEGMENTS = "; defaults:segment_symbols=1024"
FAMILIES = ("ssm", "hybrid", "encdec")
# tokens of the B x GEN the lockstep test compares on this container (its
# readings): every encdec token; the ssm's but one, where row 1's third
# token meets a logit near-tie of one bf16 step; the hybrid's row 1 whole,
# its row 0 none (a router flip of the compiled reference in the prefill)
MIN_COMPARED = {"ssm": B * GEN - 1, "hybrid": GEN, "encdec": B * GEN}


def _cfgs(family):
    out = []
    for reg in (jreg, treg):
        cfg = reg.reduced(reg.get(chip_smoke.FAMILY_ARCHS[family]))
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        out.append(cfg)
    return out


def test_api_builds_every_registry_config():
    assert sorted(jreg.ARCHS) == sorted(treg.ARCHS) and len(treg.ARCHS) == 10
    for name in treg.ARCHS:
        for cfg, jcfg in ((treg.get(name), jreg.get(name)),
                          (treg.reduced(treg.get(name)),
                           jreg.reduced(jreg.get(name)))):
            mod = tapi.build(cfg)
            assert mod.__name__.rsplit(".", 1)[1] == \
                japi.build(jcfg).__name__.rsplit(".", 1)[1]
            for fn in ("supports_continuous_batching", "supports_paged_kv",
                       "supports_resident_serving",
                       "supports_fused_resident"):
                assert getattr(tapi, fn)(cfg) == getattr(japi, fn)(jcfg), \
                    (name, fn)
            assert tapi.param_shapes(cfg) == japi.param_shapes(jcfg), name
    assert not hasattr(tapi, "_NOT_PORTED")
    with pytest.raises(KeyError, match="unknown model family"):
        tapi.build(dataclasses.replace(treg.get("qwen3-1.7b"),
                                       family="bogus"))


@pytest.fixture(scope="module", params=FAMILIES)
def harness(request, tmp_path_factory):
    family = request.param
    jcfg, tcfg = _cfgs(family)
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    jcm = JModel.compress(host, spec=JSpec.parse(
        chip_smoke.FAMILY_SPEC[family] + SEGMENTS,
        default_granularity=JGranularity.PER_CHANNEL))
    path = str(tmp_path_factory.mktemp(family) / "model.npz")
    jcm.save(path)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, PROMPT))
    src = rng.normal(0, 1, (B, SRC, jcfg.d_model))
    return dict(family=family, jcfg=jcfg, tcfg=tcfg, jcm=jcm,
                tcm=TModel.load(path), toks=toks, src=src)


def _prompts(h):
    if h["family"] != "encdec":
        return jnp.asarray(h["toks"], jnp.int32), h["toks"]
    return ({"tokens": jnp.asarray(h["toks"], jnp.int32),
             "src_embeds": jnp.asarray(h["src"], jnp.bfloat16)},
            {"tokens": h["toks"],
             "src_embeds": torch.from_numpy(h["src"]).to(torch.bfloat16)})


def test_lockstep_tokens_equal_reference(harness):
    """The port's ``Engine.generate`` on the JAX-written container against
    the JAX package's step functions on it: each row equal up to the first
    step where the two routers chose differently (a near-tie, asserted),
    and before it, up to a reference near-tie of the logits."""
    h = harness
    jprompt, tprompt = _prompts(h)
    jparams = jengine.load_params_from_compressed(h["jcm"], backend="numpy")
    jsc = jengine.ServeConfig(max_len=MAX_LEN)
    with hybrid_routes() as (port, ref):
        steps = jengine.ServeSteps(h["jcfg"], jsc)
        logits, cache = steps.prefill_fn(jparams, jprompt)
        want, lgs = [], []
        for i in range(GEN):
            lgs.append(np.asarray(logits, np.float32)[:, -1])
            want.append(np.argmax(lgs[-1], axis=-1))
            if i + 1 < GEN:
                logits, cache = steps.decode_fn(
                    jparams, jnp.asarray(want[-1][:, None], jnp.int32),
                    cache, jnp.int32(PROMPT + i))
        tparams = tengine.load_params_from_compressed(h["tcm"], device="cpu")
        eng = tengine.Engine(h["tcfg"], tparams,
                             tengine.ServeConfig(max_len=MAX_LEN),
                             device="cpu")
        got = eng.generate(tprompt, GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)
    got = got.numpy()
    want = np.stack(want, axis=1)
    np.testing.assert_array_equal(want, np.asarray(jengine.Engine(
        h["jcfg"], jparams, jsc).generate(jprompt, GEN)))
    calls = len(ref) // GEN if ref else 1   # router calls a forward
    first_flip = {}
    for c, b, s in route_flips(port, ref):
        if c % calls == calls - 1 and c < calls and s != PROMPT - 1:
            # the prefill's last MoE block, at a position whose output no
            # sampled token reads (no mixing block follows it)
            continue
        first_flip.setdefault(b, c // calls)
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
    assert compared >= MIN_COMPARED[h["family"]], compared


def test_engines_refuse_other_modes_with_reference_messages(harness):
    """No slot batch and no compressed residency for these families, in
    either package, with the same messages."""
    h = harness
    errors = []
    for build in (lambda: JContinuous(h["jcfg"], {}, jengine.ServeConfig()),
                  lambda: ContinuousEngine(h["tcfg"], {},
                                           tengine.ServeConfig(),
                                           device="cpu"),
                  lambda: jengine.ServeSteps(h["jcfg"], jengine.ServeConfig(),
                                             resident="compressed"),
                  lambda: tengine.ServeSteps(h["tcfg"], tengine.ServeConfig(),
                                             resident="compressed")):
        with pytest.raises(NotImplementedError) as e:
            build()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "slot-batch" in errors[0]
    assert errors[2] == errors[3] and "per-layer" in errors[2]


@pytest.mark.parametrize("family", FAMILIES)
def test_launcher_serves_family_lockstep(family, capsys):
    arch = chip_smoke.FAMILY_ARCHS[family]
    rc = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--compress-spec",
                      chip_smoke.FAMILY_SPEC[family] + SEGMENTS])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("compressed ")
    assert any(ln.startswith("streamed decode + load") for ln in out)
    assert any(ln.startswith("  KV cache ") for ln in out)
    assert out[-1].startswith("generated (2, 3) tokens")


@pytest.mark.parametrize("flags,message", [
    (["--batch-slots", "2"], "slot-batch"),
    (["--resident", "compressed"], "per-layer"),
])
def test_launcher_refuses_slots_and_compressed_residency(flags, message):
    with pytest.raises(NotImplementedError, match=message):
        tserve.main(["--arch", "mamba2-370m", "--device", "cpu",
                     "--prompt-len", "4", "--gen", "2", "--compress-spec",
                     chip_smoke.FAMILY_SPEC["ssm"] + SEGMENTS, *flags])


def test_launcher_encdec_batch_equals_reference_launcher():
    """The launcher's encdec prompt: the tokens, then the frames from the
    same generator, normal in bf16 (the JAX launcher's draws)."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 512, (2, 8))
    src = rng.normal(0, 1, (2, 8, 128))
    want = np.asarray(jnp.asarray(src, jnp.bfloat16), np.float32)
    again = np.random.default_rng(0)
    np.testing.assert_array_equal(again.integers(0, 512, (2, 8)), toks)
    got = torch.from_numpy(again.normal(0, 1, (2, 8, 128))).to(
        torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_mamba2_launcher_trace_passes_check_trace(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2-370m", "--device", "cpu", "--decode-backend", "numpy",
         "--batch", "1", "--prompt-len", "4", "--gen", "2",
         "--compress-spec", chip_smoke.FAMILY_SPEC["ssm"] + SEGMENTS,
         "--trace-out", str(trace), "--metrics-out", str(metrics)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr
    check = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_trace.py"),
         "--trace", str(trace), "--metrics", str(metrics), "--expect",
         "dense-lockstep"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    assert "all 'dense-lockstep' instrumentation points emitted" in \
        check.stdout
