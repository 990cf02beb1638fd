"""Dense-model parity: the port's ``models/dense.py`` against the JAX
package's on the CPU, reduced qwen3-1.7b (4 layers, d_model 128, 4 heads and
2 KV heads of 32, d_ff 256, vocab 512, qk-norm).

The JAX package initialises the weights; they cross to the port as numpy
arrays (``convert.params_from_numpy``).  Both packages run ``prefill`` on
the same prompt and then three ``decode_step`` calls on the same tokens,
with dense bf16 weights and with QT / QT4 weights decoded from one
JAX-written container.

Tolerance.  Embedding rows, RMS norm, bf16 dequantization, the bf16
projections, RoPE and SiLU are bitwise equal between the two packages on
the CPU, so layer 0's K/V cache is asserted bitwise.  Attention is bitwise
when its score sums are exact (the last test below), but not on random
inputs: the score product ``q·k`` sums the exact bf16 products in float32
in another order than XLA's CPU dot, so a few scores in a hundred to about
half of them (by shape) differ in their last float32 bit, and after the bf16
rounding of the probabilities some attention outputs differ by one bf16
step.  Those steps propagate through the later layers, so logits are held
to ``ATOL`` = 2e-2 (about 5 bf16 steps at the logits' scale of ~1), and the
greedy token of every step must agree unless the reference's best two
logits are within ``NEAR_TIE_STEPS`` bf16 steps (bf16 logits tie often; a
one-step difference flips such a choice).
"""
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
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.serving import engine as tengine

ATOL = 2e-2
NEAR_TIE_STEPS = 2
B, S, STEPS, MAX_LEN = 2, 8, 3, 16
MIXED = ("*norm*:fp32; layers/*:bits=4,codec=rans; *:bits=8,codec=huffman;"
         " defaults:segment_symbols=4096")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    cm = JModel.compress(host, spec=JSpec.parse(
        MIXED, default_granularity=JGranularity.PER_CHANNEL))
    path = str(tmp_path_factory.mktemp("dense") / "mixed.npz")
    cm.save(path)
    weights = {
        "dense": (jp, convert.params_from_numpy(tcfg, host, "cpu")),
        "qt": (jengine.load_params_from_compressed(cm, backend="numpy"),
               tengine.load_params_from_compressed(
                   TModel.load(path), backend="numpy", device="cpu")),
    }
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, weights, prompt


def _assert_same_greedy(tl, jl):
    """Greedy tokens of the port's logits ``tl`` equal the reference's
    ``jl`` wherever the reference is not a near-tie."""
    t, j = _np(tl)[:, -1], _np(jl)[:, -1]
    for r in range(j.shape[0]):
        best = float(j[r].max())
        gap = best - float(j[r, t[r].argmax()])
        assert gap <= NEAR_TIE_STEPS * 2.0 ** (math.frexp(best)[1] - 8), r


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def test_schema_matches_reference(setup):
    jcfg, tcfg, _, _ = setup
    for cfg in (jcfg, tcfg):
        assert cfg.n_layers == 4 and cfg.qk_norm
    assert japi.param_shapes(jcfg) == tapi.param_shapes(tcfg)
    assert japi.param_specs(jcfg) == tapi.param_specs(tcfg)
    # full width as well: the configs were copied, not re-derived
    assert japi.param_shapes(jreg.get("qwen3-1.7b")) == \
        tapi.param_shapes(treg.get("qwen3-1.7b"))


def test_quantized_weights_match_reference(setup):
    _, _, weights, _ = setup
    jq, tq = weights["qt"]
    assert sorted(jq) == sorted(tq)
    kinds = set()
    for k in jq:
        j, t = jq[k], tq[k]
        kind = type(t).__name__ if isinstance(t, tuple) else "array"
        kinds.add(kind)
        assert (type(j).__name__ if isinstance(j, tuple) else "array") == kind
        parts = zip(j, t) if isinstance(t, tuple) else [(j, t)]
        for a, b in parts:
            a = np.asarray(a)
            b = b.numpy() if b.dtype != torch.bfloat16 else _np(b)
            assert a.shape == b.shape, k
            np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=k)
    assert kinds == {"QT", "QT4", "array"}


@pytest.mark.parametrize("kind", ["dense", "qt"])
def test_prefill_and_decode_logits_match_reference(setup, kind):
    jcfg, tcfg, weights, prompt = setup
    jp, tp = weights[kind]
    steps = jengine.ServeSteps(jcfg, jengine.ServeConfig(max_len=MAX_LEN))
    tmod = tapi.build(tcfg)
    jl, jc = steps.prefill_fn(jp, jnp.asarray(prompt, jnp.int32))
    with torch.inference_mode():
        tl, tc = tmod.prefill(tcfg, tp, torch.as_tensor(prompt),
                              max_len=MAX_LEN)
    assert tl.shape == tuple(jl.shape) == (B, 1, tcfg.padded_vocab())
    assert tl.dtype == torch.bfloat16
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        np.testing.assert_array_equal(_np(tc[key][0]), _np(jc[key][0]))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
    _assert_same_greedy(tl, jl)
    tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    for i in range(STEPS):
        jl, jc = steps.decode_fn(jp, jnp.asarray(tok, jnp.int32), jc,
                                 jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tmod.decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                      S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0)
        _assert_same_greedy(tl, jl)
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_bitwise_building_blocks_match_reference():
    """The ops the tolerance note above calls bitwise, one by one."""
    from repro.models import layers as jl
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 128)).astype(np.float32)
    w = (rng.normal(size=(128, 256)) * 0.02).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(128,))).astype(np.float32)
    q8 = rng.integers(0, 256, (128, 256)).astype(np.uint8)
    q4 = rng.integers(0, 16, (128, 256)).astype(np.uint8)
    s, z = np.float32(1e-3), np.float32(-0.1)
    xr = rng.normal(size=(2, 8, 4, 32)).astype(np.float32)
    pos = np.arange(8)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    pairs = [
        (jl.rms_norm(jb(x), jnp.asarray(scale)),
         tlayers.rms_norm(tb(x), torch.from_numpy(scale))),
        (jb(x) @ jb(w), tb(x) @ tb(w)),
        (jl.deq(jl.QT(jnp.asarray(q8), jnp.asarray(s), jnp.asarray(z))),
         tlayers.deq(tlayers.QT(torch.from_numpy(q8), torch.tensor(s),
                                torch.tensor(z)))),
        (jl.matmul(jb(x), jl.pack_qt(q4, s, z, bits=4)),
         tlayers.matmul(tb(x), tlayers.pack_qt(q4, s, z, bits=4))),
        (jl.rope(jb(xr), jnp.asarray(pos), 1e6),
         tlayers.rope(tb(xr), torch.from_numpy(pos), 1e6)),
        (jax.nn.silu(jb(x)), tlayers.silu(tb(x))),
        (jl.take_rows(jl.pack_qt(q4, s, z, bits=4), jnp.asarray([3, 0, 7])),
         tlayers.take_rows(tlayers.pack_qt(q4, s, z, bits=4),
                           torch.tensor([3, 0, 7]))),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=str(i))


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,q_offset,kv_len", [
    (2, 8, 8, 4, 4, 32, True, 0, None),
    (2, 16, 16, 4, 2, 128, True, 0, None),
    (2, 32, 32, 4, 4, 128, True, 0, None),     # another CPU dot kernel
    (2, 1, 32, 4, 2, 128, False, 20, 21),      # a decode step on a cache
])
def test_attention_bitwise_when_summation_order_cannot_matter(
        B, S, T, H, KV, hd, causal, q_offset, kv_len):
    """Attention of the port equals the JAX package's bitwise once the score
    sums are exact in float32, so the order of summation (the one thing the
    two CPU dots do differently) cannot change them.  q has magnitudes in
    [1, 2), so ``q * hd**-0.5`` rounds to bf16 values of two binades; k and
    v are small integers, k mostly zero.  Every product is then a multiple
    of 2**-11 below 2**-1 and every partial sum below 2**7: 18 bits, exact
    in float32's 24.  This pins the casts, the scale, the mask, the softmax
    and ``p · v``; only the summation order of random inputs is left free
    (queue 3 of ROADMAP.md)."""
    from repro.models import layers as jl
    rng = np.random.default_rng(hd + S)
    q = (rng.choice([-1.0, 1.0], (B, S, H, hd))
         * (1 + rng.integers(0, 128, (B, S, H, hd)) / 128))
    k = rng.integers(-1, 2, (B, T, KV, hd)) * (rng.random((B, T, KV, hd))
                                               < 0.125)
    v = rng.integers(-2, 3, (B, T, KV, hd))
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    # the premise: the scores' float32 and float64 sums agree
    qs = (tq * hd ** -0.5).to(torch.bfloat16)
    kk = tk.repeat_interleave(H // KV, dim=2)
    s32 = torch.einsum("bsnh,btnh->bnst", qs.float(), kk.float())
    s64 = torch.einsum("bsnh,btnh->bnst", qs.double(), kk.double())
    assert torch.equal(s32.double(), s64)
    assert float(s64.abs().max()) > 0.5           # the scores are not trivial
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = tlayers.gqa_attention(tq, tk, tv, **kw)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = jl.gqa_attention(jb(q), jb(k), jb(v), **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, hd)
    np.testing.assert_array_equal(_np(got), _np(want))
