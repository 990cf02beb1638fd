"""Hybrid parity: the port's ``models/hybrid.py`` against the JAX package's
on the CPU, reduced jamba-1.5-large-398b (8 layers in 2 periods of 4: the
attention block at position 2, Mamba-2 blocks elsewhere, MoE feed-forwards
at positions 1 and 3 (4 routed experts padded to 16, top-2), dense SwiGLU
at 0 and 2; d_model 128, 4 heads and 2 KV heads of 32, d_ff 256, vocab
512).

The JAX package initialises the weights; they cross to the port as numpy
arrays (``convert.params_from_numpy``).

Tolerances.  The period body run op by op (outside any compiled scan)
matches the reference's op-by-op run within ``BLOCK_STEPS`` = 2 bf16 steps
at its largest magnitude, at the published ``capacity_factor``, with every
router choice equal.  Against the reference's compiled ``forward`` /
``prefill`` / ``decode_step`` (``lax.scan``, where XLA keeps fused bf16
chains in float32) the hidden state drifts by a few bf16 steps and can
flip a router near-tie (ROADMAP queue 3, item 5): both packages' router
choices are recorded call by call, every choice that differs must be a
near-tie of ``NEAR_TIE_STEPS`` bf16 steps, and a row is not compared from
such a choice on (``tests/test_torch_moe.py``'s rule, at
``capacity_factor`` 8.0, where no choice is dropped).  Every other logit is
held to ``ATOL`` = 2e-2 and greedy token to the near-tie rule; decode at
S-1 must match prefill over S within the reference's atol 0.15 / rtol 0.05
(``tests/test_arch_smoke.py``).

On this prompt the compiled reference flips a router choice in both rows
during the prefill, so its comparison reaches no decode logit.  The whole
prefill and decode are therefore also held to the reference run op by op
(``jax.disable_jit``), where every router choice agrees: logits within
``BLOCK_STEPS`` bf16 steps, and every cache leaf (the SSM and conv states
of each Mamba layer, the attention K / V of each period) within
``STATE_OP_RTOL`` = 1e-3 of its size, layer by layer
(``tests/test_torch_ssm.py``'s ``assert_state_close``; the SSM state is
about 3e-5 here, below what any logit shows).  The period body's states
and the state a decode step leaves after a prefill of S-1 tokens, against
the prefill of S, are held the same way.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as thybrid
from test_torch_moe import (_assert_logits, _bf16_step, _Excused, _np,
                            recorded_routes, route_flips)
from test_torch_ssm import (STATE_OP_RTOL,
                            assert_family_spec_keeps_ssm_tensors_fp32,
                            assert_state_close)

BLOCK_STEPS = 2
B, S, STEPS, MAX_LEN = 2, 12, 3, 16
ARCH = "jamba-1.5-large-398b"


def _lead(key):
    """Leading axes of a cache leaf that index one layer's state: (period,
    Mamba block) for the SSM and conv states, the period for K / V."""
    return 2 if key in ("ssm", "conv_x", "conv_bc") else 1


def _wide(cfg, cf=8.0):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.reduced(jreg.get(ARCH))
    tcfg = treg.reduced(treg.get(ARCH))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, jp, tp, prompt


@contextlib.contextmanager
def hybrid_routes():
    """``recorded_routes`` of ``tests/test_torch_moe.py``, reaching the
    reference's hybrid too (it imported ``moe_mlp`` by name)."""
    with recorded_routes() as (port, ref):
        orig = jhybrid.moe_mlp
        jhybrid.moe_mlp = jmoe.moe_mlp
        try:
            yield port, ref
        finally:
            jhybrid.moe_mlp = orig


def test_layout_matches_reference(setup):
    jcfg, tcfg, *_ = setup
    assert thybrid._layout(tcfg) == jhybrid._layout(jcfg) == [
        ("mamba", "mlp"), ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe")]
    full = thybrid._layout(treg.get(ARCH))
    assert full == jhybrid._layout(jreg.get(ARCH))
    assert [m for m, _ in full].count("attn") == 1 and full[4][0] == "attn"
    assert [f for _, f in full] == ["mlp", "moe"] * 4


def test_schema_matches_reference(setup):
    jcfg, tcfg, *_ = setup
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for jc, tc in ((jcfg, tcfg), (jreg.get(ARCH), treg.get(ARCH))):
        js, ts = jhybrid.schema(jc), thybrid.schema(tc)
        assert list(js) == list(ts)
        for name in js:
            assert js[name].shape == ts[name].shape, name
            assert js[name].axes == ts[name].axes, name
            assert js[name].init == ts[name].init, name
            assert dtypes[js[name].dtype] == ts[name].dtype, name
    assert tapi.build(tcfg) is thybrid
    assert japi.param_shapes(jreg.get(ARCH)) == \
        tapi.param_shapes(treg.get(ARCH))


def _period_j(jp, p):
    return {k.split("/", 1)[1]: v[p] for k, v in jp.items()
            if k.startswith("periods/")}


def test_period_body_equals_reference_op_by_op(setup):
    """Each period of the reference's scan body, run op by op, against the
    port's, on the same input: outputs within BLOCK_STEPS bf16 steps, every
    router choice and the collected conv states equal, the MoE aux close."""
    jcfg, tcfg, jp, tp, prompt = setup
    jx = jlayers.take_rows(jp["embed"], jnp.asarray(prompt, jnp.int32))
    for p in range(jcfg.n_layers // jcfg.attn_period):
        tx = torch.from_numpy(_np(jx)).to(torch.bfloat16)
        with torch.inference_mode(), hybrid_routes() as (port, ref):
            jo, jc, jaux = jhybrid._period_body(
                jcfg, _period_j(jp, p), jx, positions=jnp.arange(S),
                collect=True)
            to, tc, taux = thybrid._period_body(
                tcfg, thybrid._period(tp, p), tx,
                positions=torch.arange(S), collect=True)
        assert len(port) == len(ref) == 2
        for (_, ti), ji in zip(port, ref):
            np.testing.assert_array_equal(ti, ji)
        step = _bf16_step(np.abs(_np(jo)).max())
        np.testing.assert_allclose(_np(to), _np(jo), rtol=0,
                                   atol=BLOCK_STEPS * step, err_msg=str(p))
        for key in ("k", "v", "conv_x", "conv_bc", "ssm"):
            assert_state_close(tc[key], jc[key], STATE_OP_RTOL,
                               lead=_lead(key) - 1, what=(p, key))
        np.testing.assert_array_equal(_np(tc["conv_x"][0]),
                                      _np(jc["conv_x"][0]))
        assert float(taux) == pytest.approx(float(jaux), rel=1e-4)
        jx = jo


def test_forward_matches_reference(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    jcfg, tcfg = _wide(jcfg), _wide(tcfg)
    with torch.inference_mode(), hybrid_routes() as (port, ref):
        jx, _, jaux = jhybrid.forward(jcfg, jp, jnp.asarray(prompt, jnp.int32))
        tx, caches, taux = thybrid.forward(tcfg, tp, torch.as_tensor(prompt))
    assert caches is None and taux.dtype == torch.float32
    ex = _Excused()
    ex.add(route_flips(port, ref))
    _assert_logits(thybrid.logits_fn(tcfg, tp, tx),
                   jhybrid.logits_fn(jcfg, jp, jx), ex.mask(B, range(S)))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-3)


def test_prefill_and_decode_logits_match_reference(setup):
    """Prefill into a cache of MAX_LEN rows, then STEPS greedy decode steps
    fed the reference's tokens; router choices compared call by call."""
    jcfg, tcfg, jp, tp, prompt = setup
    jcfg, tcfg = _wide(jcfg), _wide(tcfg)
    ex = _Excused()
    with torch.inference_mode(), hybrid_routes() as (port, ref):
        jl, jc = jhybrid.prefill(jcfg, jp, jnp.asarray(prompt, jnp.int32),
                                 max_len=MAX_LEN)
        tl, tc = thybrid.prefill(tcfg, tp, torch.as_tensor(prompt),
                                 max_len=MAX_LEN)
    ex.add(route_flips(port, ref))
    assert tl.shape == tuple(jl.shape) == (B, 1, tcfg.padded_vocab())
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
    assert tc["ssm"].dtype == torch.float32 and tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tc["conv_x"][0, 0]),
                                  _np(jc["conv_x"][0, 0]))
    _assert_logits(tl, jl, ex.mask(B, [S - 1]))
    tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    for i in range(STEPS):
        with torch.inference_mode(), hybrid_routes() as (port, ref):
            jl, jc = jhybrid.decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                         jc, jnp.int32(S + i))
            tl, tc = thybrid.decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                         S + i)
        ex.add(route_flips(port, ref), S + i)
        _assert_logits(tl, jl, ex.mask(B, [S + i]))
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_prefill_and_decode_equal_reference_op_by_op(setup):
    """Prefill and STEPS greedy decode steps at the published
    ``capacity_factor``, against the reference's ``prefill`` /
    ``decode_step`` run op by op: every router choice equal, logits within
    BLOCK_STEPS bf16 steps, every cache leaf within STATE_OP_RTOL."""
    jcfg, tcfg, jp, tp, prompt = setup
    tok = prompt
    for i in range(STEPS + 1):
        with torch.inference_mode(), hybrid_routes() as (port, ref), \
                jax.disable_jit():
            if i == 0:
                jl, jc = jhybrid.prefill(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                         max_len=MAX_LEN)
                tl, tc = thybrid.prefill(tcfg, tp, torch.as_tensor(tok),
                                         max_len=MAX_LEN)
            else:
                pos = S + i - 1
                jl, jc = jhybrid.decode_step(
                    jcfg, jp, jnp.asarray(tok, jnp.int32), jc, jnp.int32(pos))
                tl, tc = thybrid.decode_step(tcfg, tp, torch.as_tensor(tok),
                                             tc, pos)
        assert len(port) == len(ref) == 4
        for (_, ti), ji in zip(port, ref):
            np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(
            _np(tl), _np(jl), rtol=0,
            atol=BLOCK_STEPS * _bf16_step(np.abs(_np(jl)).max()))
        for key in jc:
            assert_state_close(tc[key], jc[key], STATE_OP_RTOL,
                               lead=_lead(key), what=(i, key))
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_decode_step_matches_prefill_extension(setup):
    """The reference's check and tolerance; the cache the decode step
    leaves equal to the prefill's within STATE_OP_RTOL."""
    _, tcfg, _, tp, prompt = setup
    tcfg = _wide(tcfg)
    with torch.inference_mode():
        full, want = thybrid.prefill(tcfg, tp, torch.as_tensor(prompt))
        _, cache = thybrid.prefill(tcfg, tp, torch.as_tensor(prompt[:, :-1]),
                                   max_len=S)
        step, got = thybrid.decode_step(tcfg, tp,
                                        torch.as_tensor(prompt[:, -1:]),
                                        cache, S - 1)
    np.testing.assert_allclose(_np(full[:, -1]), _np(step[:, -1]),
                               atol=0.15, rtol=0.05)
    for key in want:
        assert_state_close(got[key], want[key], STATE_OP_RTOL,
                           lead=_lead(key), what=key)


def test_family_spec_keeps_ssm_tensors_fp32(setup):
    _, tcfg, *_ = setup
    assert_family_spec_keeps_ssm_tensors_fp32("hybrid", tcfg)
