"""Encoder-decoder parity: the port's ``models/encdec.py`` against the JAX
package's on the CPU, reduced seamless-m4t-medium (2 encoder and 4 decoder
layers, d_model 128, 4 heads and 2 KV heads of 32, d_ff 256, vocab 512),
the batch the target tokens and 12 stub frontend frames.

The JAX package initialises the weights; they cross to the port as numpy
arrays (``convert.params_from_numpy``).

Tolerances.  The encoder output is held to ``ENC_ATOL`` = 2e-2 against the
reference's compiled ``encode`` (``lax.scan``: XLA keeps fused bf16 chains
in float32, and the attention score product is not bitwise on the CPU,
ROADMAP queue 3 item 1), and layer 0's self-attention K / V, which come
before any attention, bitwise.  Logits are held to ``ATOL`` = 2e-2 and
greedy tokens must agree unless the reference's best two logits are
within ``NEAR_TIE_STEPS`` bf16 steps (``tests/test_torch_dense.py``'s
rule).  The cross K / V a decode step reads are the prefill's, bitwise;
decode at S-1 must match prefill over S within the reference's atol 0.15 /
rtol 0.05 (``tests/test_arch_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from test_torch_moe import _assert_logits, _np

ATOL = ENC_ATOL = 2e-2
B, S, SRC, STEPS, MAX_LEN = 2, 10, 12, 3, 16
ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.reduced(jreg.get(ARCH))
    tcfg = treg.reduced(treg.get(ARCH))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (B, S))
    src = rng.normal(size=(B, SRC, jcfg.d_model))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "src_embeds": jnp.asarray(src, jnp.bfloat16)}
    tb = {"tokens": torch.as_tensor(toks),
          "src_embeds": torch.from_numpy(src).to(torch.bfloat16)}
    return jcfg, tcfg, jp, tp, jb, tb


def test_schema_matches_reference(setup):
    jcfg, tcfg, *_ = setup
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for jc, tc in ((jcfg, tcfg), (jreg.get(ARCH), treg.get(ARCH))):
        js, ts = jencdec.schema(jc), tencdec.schema(tc)
        assert list(js) == list(ts)
        for name in js:
            assert js[name].shape == ts[name].shape, name
            assert js[name].axes == ts[name].axes, name
            assert js[name].init == ts[name].init, name
            assert dtypes[js[name].dtype] == ts[name].dtype, name
    assert tapi.build(tcfg) is tencdec


def test_encode_matches_reference(setup):
    """The bidirectional encoder: a frame attends to later frames too (a
    change to the last frame moves the first output)."""
    jcfg, tcfg, jp, tp, jb, tb = setup
    want = _np(jencdec.encode(jcfg, jp, jb["src_embeds"]))
    with torch.inference_mode():
        got = tencdec.encode(tcfg, tp, tb["src_embeds"])
        moved = tb["src_embeds"].clone()
        moved[:, -1] += 1
        other = tencdec.encode(tcfg, tp, moved)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ENC_ATOL)
    assert not torch.equal(other[:, 0], got[:, 0])


def test_prefill_and_decode_logits_match_reference(setup):
    """Prefill on the batch dict, then STEPS greedy decode steps fed the
    reference's tokens; the cross K / V stay the prefill's."""
    jcfg, tcfg, jp, tp, jb, tb = setup
    jl, jc = jencdec.prefill(jcfg, jp, jb, max_len=MAX_LEN)
    with torch.inference_mode():
        tl, tc = tencdec.prefill(tcfg, tp, tb, max_len=MAX_LEN)
    assert tl.shape == tuple(jl.shape) == (B, 1, tcfg.padded_vocab())
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tc["k"][0]), _np(jc["k"][0]))
    np.testing.assert_allclose(_np(tc["xk"]), _np(jc["xk"]), rtol=0,
                               atol=ENC_ATOL)
    keep = np.ones((B, 1), bool)
    _assert_logits(tl, jl, keep)
    xk, xv = tc["xk"].clone(), tc["xv"].clone()
    tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    for i in range(STEPS):
        jl, jc = jencdec.decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                     jc, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tencdec.decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                         S + i)
        _assert_logits(tl, jl, keep)
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    assert torch.equal(tc["xk"], xk) and torch.equal(tc["xv"], xv)
    # the decode steps' self-attention rows landed at S .. S + STEPS - 1
    assert bool(tc["k"][:, :, S:S + STEPS].abs().sum(-1).gt(0).all())
    assert not bool(tc["k"][:, :, S + STEPS:].any())


def test_decode_step_matches_prefill_extension(setup):
    _, tcfg, _, tp, _, tb = setup
    part = dict(tb, tokens=tb["tokens"][:, :-1])
    with torch.inference_mode():
        full, _ = tencdec.prefill(tcfg, tp, tb)
        _, cache = tencdec.prefill(tcfg, tp, part, max_len=S)
        step, _ = tencdec.decode_step(tcfg, tp, tb["tokens"][:, -1:], cache,
                                      S - 1)
    np.testing.assert_allclose(_np(full[:, -1]), _np(step[:, -1]),
                               atol=0.15, rtol=0.05)


def test_init_cache_takes_src_len(setup):
    _, tcfg, *_ = setup
    c = tencdec.init_cache(tcfg, 2, 16, src_len=7, device="meta")
    assert c["k"].shape[2] == 16 and c["xk"].shape[2] == 7
    assert tencdec.init_cache(tcfg, 2, 16, device="meta")["xv"].shape[2] == 16
