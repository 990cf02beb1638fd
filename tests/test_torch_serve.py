"""The whole slice on the CPU: the JAX package writes a container, the port
loads and decodes it (``device="cpu"``, so ``auto`` picks the ``torch``
backend, the kernels' plain versions), and the port's greedy tokens equal
the JAX package's ``Engine.generate`` tokens (batch 2, prompt 8, 6 tokens),
for a Huffman-8 container and a mixed rANS-4 + Huffman-8 one.

Tolerance.  The decoded weights are bitwise equal, and so is every op of
the model but one: the attention score product sums its exact bf16
products in float32 in another order than XLA's CPU dot (see
``tests/test_torch_dense.py``), so a bf16 logit can land one step away from
the reference's.  Logits are bf16, so two candidates often sit one step
apart or tie; there a one-step difference flips the greedy choice, and
from then on the two sequences continue from different tokens.  So each
row's tokens must be equal up to the first step where they differ, that
step must be such a reference near-tie (the port's token within
``NEAR_TIE_STEPS`` bf16 steps of the reference's best logit), and the rest
of the row is not compared.  With the seeds below both cases agree on
every token, now that the attention scale is rounded to bf16 as JAX rounds
a Python scalar (before that fix the mixed case's row 1 diverged at its
third token, a near-tie of 0.6875 against 0.68359375).

Also: the port's launcher runs on the reduced config with ``--device cpu``
and prints its three report lines, flags of serving modes not ported yet
exit with a message (compressed residency and ``--fused`` are ported, see
``tests/test_torch_resident.py``, and so is ``--batch-slots``, see
``tests/test_torch_batching.py``), fleets (``--replicas``, ``--router``,
``--disaggregate``) serve with the JAX launcher's upfront validation, and
every entry point called without ``device`` raises on this card-less host
instead of running on the CPU.
"""
import json
import math

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
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.launch import serve as tserve
from repro_torch.models import dense as tdense
from repro_torch.serving import engine as tengine

B, PROMPT, GEN = 2, 8, 6
NEAR_TIE_STEPS = 2
SPECS = {
    "huffman8": "*:bits=8,codec=huffman; defaults:segment_symbols=4096",
    "rans4+huffman8": "*norm*:fp32; layers/*:bits=4,codec=rans; "
                      "*:bits=8,codec=huffman; defaults:segment_symbols=4096",
}


@pytest.fixture(scope="module")
def reference():
    cfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    params = japi.build(cfg).init(cfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (B, PROMPT))
    return cfg, host, prompt


def _bf16_step(x: float) -> float:
    """Spacing of bf16 values around ``x`` (8 significant bits)."""
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def _reference_logits(cfg, params, prompt, sc):
    """Greedy decode through the JAX package's step functions, keeping each
    step's last-position logits (float32, (GEN, B, V))."""
    steps = jengine.ServeSteps(cfg, sc)
    logits, cache = steps.prefill_fn(params, jnp.asarray(prompt, jnp.int32))
    out, toks = [], []
    for i in range(GEN):
        lg = np.asarray(logits, np.float32)[:, -1]
        out.append(lg)
        toks.append(np.argmax(lg, axis=-1))
        if i + 1 < GEN:
            logits, cache = steps.decode_fn(
                params, jnp.asarray(toks[-1][:, None], jnp.int32), cache,
                jnp.int32(PROMPT + i))
    return np.stack(out), np.stack(toks, axis=1)


def assert_tokens_equal_up_to_near_tie(got, want, ref_logits):
    """Returns the number of tokens compared."""
    compared = 0
    for r in range(got.shape[0]):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            compared += got.shape[1]
            continue
        d = int(diff[0])
        lg = ref_logits[d, r]
        best = float(lg[want[r, d]])
        gap = best - float(lg[got[r, d]])
        assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (
            f"row {r} step {d}: port token {got[r, d]} is {gap} below the "
            f"reference's {want[r, d]} at {best}: not a near-tie")
        compared += d + 1
    return compared


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_port_greedy_tokens_equal_reference(reference, spec, tmp_path):
    cfg, host, prompt = reference
    cm = JModel.compress(host, spec=JSpec.parse(
        SPECS[spec], default_granularity=JGranularity.PER_CHANNEL))
    path = str(tmp_path / "model.npz")
    cm.save(path)

    sc = jengine.ServeConfig(max_len=PROMPT + GEN)
    jparams = jengine.load_params_from_compressed(cm, backend="numpy")
    want = np.asarray(jengine.Engine(cfg, jparams, sc).generate(
        jnp.asarray(prompt, jnp.int32), GEN))
    ref_logits, ref_toks = _reference_logits(cfg, jparams, prompt, sc)
    np.testing.assert_array_equal(ref_toks, want)

    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    load = {}
    tparams = tengine.load_params_from_compressed(
        TModel.load(path), device="cpu", metrics=load)
    assert load["decode_backend"] == "torch"
    assert load["decode_load_s"] >= load["time_to_first_weight_s"] > 0
    eng = tengine.Engine(tcfg, tparams,
                         tengine.ServeConfig(max_len=PROMPT + GEN),
                         device="cpu")
    got, met = eng.generate(prompt, GEN, echo_metrics=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)
    compared = assert_tokens_equal_up_to_near_tie(got.numpy(), want,
                                                  ref_logits)
    assert compared >= {"huffman8": 12, "rans4+huffman8": 12}[spec]
    for k in ("prefill_s", "decode_s", "ttft_s", "decode_tok_per_s",
              "e2e_tok_per_s"):
        assert met[k] > 0, k


def test_monolithic_and_streamed_loads_agree(reference, tmp_path):
    """``stream=False`` and the chunked stream give the same weights, and
    the dense (``quantized=False``) load gives the dequantized values."""
    _, host, _ = reference
    spec = JSpec.parse(SPECS["rans4+huffman8"],
                       default_granularity=JGranularity.PER_CHANNEL)
    path = str(tmp_path / "model.npz")
    JModel.compress(host, spec=spec).save(path)
    cm = TModel.load(path)
    streamed = tengine.load_params_from_compressed(
        cm, device="cpu", backend="numpy", chunk_symbols=8192)
    mono = tengine.load_params_from_compressed(
        cm, device="cpu", backend="numpy", stream=False)
    assert sorted(streamed) == sorted(mono)
    for k in streamed:
        a, b = streamed[k], mono[k]
        assert type(a) is type(b), k
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert torch.equal(x, y), k
    dense = tengine.load_params_from_compressed(
        cm, device="cpu", backend="numpy", quantized=False)
    deq = JModel.load(path).dequantize_all(backend="numpy")
    for k, v in deq.items():
        np.testing.assert_array_equal(dense[k].numpy(), v)


def test_launcher_prints_three_lines(capsys):
    rc = tserve.main(["--arch", "qwen3-1.7b", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3", "--device", "cpu",
                      "--compress-spec", SPECS["rans4+huffman8"]])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("compressed ")
    assert any(ln.startswith("  [rans4]") for ln in lines)
    assert any(ln.startswith("streamed decode + load [torch]") for ln in lines)
    assert lines[-1].startswith("generated (2, 3) tokens")


def test_launcher_monolithic_numpy_dense_load(capsys):
    rc = tserve.main(["--arch", "qwen3-1.7b", "--bits", "8", "--batch", "1",
                      "--prompt-len", "4", "--gen", "2", "--device", "cpu",
                      "--decode-backend", "numpy", "--no-stream",
                      "--no-quantized-serving"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "monolithic decode + load [numpy]" in out
    assert "quantized residency: False" in out


@pytest.mark.parametrize("flag", ["--fused-impl=pallas", "--production",
                                  "--multi-pod", "--shape=decode_32k"])
def test_launcher_refuses_flags_not_ported_yet(flag, capsys):
    """``--fused-impl pallas`` is refused; the production flags are ported
    now: with ``--production`` they run the dry-run (mamba2-370m, whose
    cells run in seconds)."""
    if flag.startswith("--fused-impl"):
        with pytest.raises(SystemExit) as e:
            tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu", flag])
        assert e.value.code != 0
        assert "not ported yet" in capsys.readouterr().err
        return
    assert tserve.main(["--arch", "mamba2-370m", "--production", flag]) == 0
    out = capsys.readouterr().out
    mesh = "2x16x16" if flag == "--multi-pod" else "16x16"
    assert f"== mamba2-370m x decode_32k on {mesh}" in out


FLEET_ARGS = ["--arch", "qwen3-1.7b", "--device", "cpu", "--decode-backend",
              "numpy", "--compress-spec", SPECS["huffman8"], "--gen", "4",
              "--prompt-len", "8"]


@pytest.mark.parametrize("flags,lines", [
    (["--batch-slots", "2", "--traffic", "4", "--replicas", "2"],
     ["fleet [2x data-parallel; router round-robin]: 1 weight copy",
      "fleet serve: 4/4 requests", "  per replica: r0[up] ",
      "  ttft p50 "]),
    (["--batch-slots", "2", "--traffic", "4", "--replicas", "2",
      "--disaggregate", "1:1", "--kv-spec", "bits=16"],
     ["fleet [1 prefill + 1 decode, disaggregated; router round-robin]",
      "fleet serve: 4/4 requests", "  per replica: r0[up] 0 tok, r1[up] ",
      "  ttft p50 ", "  handoff: 4 prefill->decode payloads"]),
], ids=["dp", "disaggregated"])
def test_launcher_serves_fleet(flags, lines, capsys):
    assert tserve.main(FLEET_ARGS + flags) == 0
    out = capsys.readouterr().out.splitlines()
    got = out[-len(lines):]
    assert all(g.startswith(w) for g, w in zip(got, lines)), got


@pytest.mark.parametrize("flags,message", [
    (["--batch-slots", "2", "--disaggregate", "1:1"],
     "--disaggregate requires --replicas"),
    (["--batch-slots", "2", "--replicas", "3", "--disaggregate", "1:1",
      "--kv-spec", "bits=16"], "must sum to --replicas (3)"),
    (["--batch-slots", "2", "--replicas", "2", "--disaggregate", "1:1"],
     "--disaggregate requires --kv-spec"),
    (["--batch-slots", "2", "--replicas", "2", "--resident", "compressed"],
     "--replicas needs --resident dense"),
], ids=["no-replicas", "split-sum", "no-kv-spec", "compressed"])
def test_launcher_fleet_validation(flags, message, capsys):
    with pytest.raises(SystemExit) as e:
        tserve.main(FLEET_ARGS + flags)
    assert e.value.code != 0
    assert message in capsys.readouterr().err


def test_entry_points_without_device_raise(reference):
    """Entry points run on the card unless the caller names the CPU; here
    there is none, so they raise rather than run elsewhere."""
    _, host, _ = reference
    assert not torch.cuda.is_available()
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    cm = TModel.compress({"layers/w": np.linspace(
        -1, 1, 128, dtype=np.float32).reshape(2, 8, 8)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.load_params_from_compressed(cm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.Engine(cfg, {}, tengine.ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdense.init(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_numpy(cfg, host)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen3-1.7b", "--gen", "2"])


def test_launcher_writes_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    rc = tserve.main(["--arch", "qwen3-1.7b", "--batch", "1",
                      "--prompt-len", "4", "--gen", "2", "--device", "cpu",
                      "--decode-backend", "numpy", "--trace-sync",
                      "--trace-out", str(trace), "--metrics-out",
                      str(metrics)])
    assert rc == 0
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"load.stream", "serve.prefill", "serve.decode_step"} <= names
    rows = [json.loads(ln) for ln in metrics.read_text().splitlines()]
    assert any(r.get("name") == "load.decode_load_s" for r in rows)
    out = capsys.readouterr().out
    assert f"-> {trace}" in out and f"-> {metrics}" in out


def test_temperature_sampling_follows_its_generator():
    logits = torch.randn(3, 2, 50, generator=torch.Generator().manual_seed(1))
    greedy = tengine.sample(logits, 0.0)
    assert torch.equal(greedy, logits[:, -1].argmax(-1).to(torch.int32))
    draws = [tengine.sample(logits, 0.8, torch.Generator().manual_seed(s))
             for s in (7, 7, 8)]
    assert draws[0].dtype == torch.int32 and tuple(draws[0].shape) == (3,)
    assert torch.equal(draws[0], draws[1])
    assert ((draws[2] >= 0) & (draws[2] < 50)).all()
