"""Mamba-2 parity: the port's ``models/mamba2.py`` against the JAX
package's on the CPU, reduced mamba2-370m (4 layers, d_model 128, d_inner
256 in 16 SSD heads of 16, d_state 16, chunk 32, vocab 512, tied
embeddings).

The JAX package initialises the weights; they cross to the port as numpy
arrays (``convert.params_from_numpy``).

Tolerances.  The conv's state is bitwise and its output within one bf16
step (``exp`` of the two CPU libraries may differ in the last float32 bit
before the bf16 rounding).  The SSD pieces run in float32: ``_segsum``
within ``F32_ATOL`` = 1e-6, absolute and relative (XLA's cumsum sums in
another order), with its -inf entries equal; ``ssd_step`` likewise;
``ssd_chunked`` against the reference, and the port's chunked scan against
its own stepwise recurrence, to ``SSD_ATOL`` = 5e-5 (the JAX package
holds its own scan to it, ``tests/test_models_math.py``; the port loops
over chunks where the reference runs an associative scan).  One block run
op by op matches the reference's op-by-op run within ``BLOCK_STEPS`` = 2
bf16 steps at its largest magnitude.  Whole-model logits are held to
``ATOL`` = 2e-2 against the reference's compiled ``prefill`` /
``decode_step`` (XLA keeps fused bf16 chains in float32 under
``lax.scan``), greedy tokens must agree unless the reference's best two
logits are within ``NEAR_TIE_STEPS`` bf16 steps, and decode at S-1 must
match prefill over S within the reference's atol 0.15 / rtol 0.05
(``tests/test_arch_smoke.py``).

States are held relative to their size, layer by layer: the largest
|difference| of a layer's state may be at most ``rtol`` times the largest
|state| of the reference's (which must not be zero), so a state that is
dropped or never written misses by its whole size.  At the published init
the SSM state is about 2e-5 and its share of a block's output is below one
bf16 step, so no logit can see it: ``STATE_OP_RTOL`` = 1e-3 holds a block
run op by op and the port's decode against its own prefill (readings
below 2e-5); ``STATE_RTOL`` = 5e-2 holds the whole model against the
reference's compiled run, whose hidden state drifts by bf16 steps
(readings up to 1.4e-2).  The ``amplified`` weights (``in_bcdt`` and the
conv weights times ``AMP`` = 10) make the SSD term visible: zeroing the
SSM state before one decode step moves its logits by more than ten times
``ATOL``, and prefill / decode logits and states are held as above against
the reference run op by op (``jax.disable_jit``).
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import mamba2 as jmamba
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba

ATOL = 2e-2
STATE_OP_RTOL = 1e-3
STATE_RTOL = 5e-2
AMP = 10.0
F32_ATOL = 1e-6
SSD_ATOL = 5e-5
BLOCK_STEPS = 2
NEAR_TIE_STEPS = 2
B, S, STEPS = 2, 40, 3


@pytest.fixture(scope="module")
def setup():
    jcfg = jreg.reduced(jreg.get("mamba2-370m"))
    tcfg = treg.reduced(treg.get("mamba2-370m"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, S))
    return jcfg, tcfg, jp, tp, prompt


@pytest.fixture(scope="module")
def amplified(setup):
    """``setup``'s weights with ``in_bcdt`` and the conv weights times
    ``AMP``, in both packages: the SSM state reaches about 0.5 and its
    term shows in the logits."""
    jcfg, tcfg, jp, _, prompt = setup
    jp = dict(jp)
    for k in ("layers/in_bcdt", "layers/conv_x_w", "layers/conv_bc_w"):
        jp[k] = (jp[k].astype(jnp.float32) * AMP).astype(jp[k].dtype)
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, tcfg, jp, convert.params_from_numpy(tcfg, host, "cpu"), \
        prompt


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _bf16_step(v):
    return 2.0 ** (math.frexp(abs(float(v)))[1] - 8)


def _ssd_inputs(S_, H=3, P=8, N=16, B_=2, seed=0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(B_, S_, H, P)),
                dt=rng.uniform(0.01, 0.2, size=(B_, S_, H)),
                A=-rng.uniform(0.5, 4.0, size=(H,)),
                Bm=rng.normal(size=(B_, S_, N)),
                Cm=rng.normal(size=(B_, S_, N)),
                h0=rng.normal(size=(B_, H, P, N)))


def assert_state_close(got, want, rtol, lead=1, what=""):
    """Each of ``want``'s leading ``lead`` indices (a layer's state): the
    reference's largest |value| is not zero and the largest |difference|
    is at most ``rtol`` times it."""
    w, g = _np(want), _np(got)
    assert g.shape == w.shape, what
    w = w.reshape(int(np.prod(w.shape[:lead])), -1)
    g = g.reshape(w.shape)
    size = np.abs(w).max(axis=1)
    assert (size > 0).all(), (what, size)
    err = np.abs(g - w).max(axis=1)
    assert (err <= rtol * size).all(), (what, err / size)


def _both(a):
    return (jnp.asarray(a, jnp.float32),
            torch.from_numpy(np.asarray(a, np.float32)))


# ------------------------------------------------------------------ pieces

def test_schema_matches_reference(setup):
    jcfg, tcfg, *_ = setup
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for jc, tc in ((jcfg, tcfg), (jreg.get("mamba2-370m"),
                                  treg.get("mamba2-370m"))):
        js, ts = jmamba.schema(jc), tmamba.schema(tc)
        assert list(js) == list(ts)
        for name in js:
            assert js[name].shape == ts[name].shape, name
            assert js[name].axes == ts[name].axes, name
            assert js[name].init == ts[name].init, name
            assert dtypes[js[name].dtype] == ts[name].dtype, name
    assert tapi.build(tcfg) is tmamba
    assert "lm_head" not in tmamba.schema(tcfg)      # tied embeddings


def test_init_draws_a_log_and_dt_bias_in_range(setup):
    """``A = -exp(A_log)`` in [-16, -1] and ``softplus(dt_bias)`` in
    [1e-3, 1e-1], as the reference draws them; same seed, same draws."""
    _, tcfg, *_ = setup
    p = tmamba.init(tcfg, 3, torch.device("cpu"))
    a = -torch.exp(p["layers/A_log"])
    assert p["layers/A_log"].dtype == torch.float32
    assert bool(((a >= -16.0001) & (a <= -0.9999)).all())
    dt = tlayers.softplus(p["layers/dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    assert float(a.std()) > 0.5 and float(dt.std()) > 1e-3
    q = tmamba.init(tcfg, 3, torch.device("cpu"))
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001), [0.0, 20.0, 20.5, 90.0,
                                                     -90.0, np.nan]])
    jx, tx = _both(x)
    want, got = _np(jax.nn.softplus(jx)), _np(tlayers.softplus(tx))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-30)
    # past F.softplus's threshold of 20 the two differ by log1p(exp(-x))
    assert float(tlayers.softplus(torch.tensor(20.0, dtype=torch.float64))) \
        > 20.0


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    Bx, Sx, C, K = 2, 10, 48, 4
    x = rng.normal(size=(Bx, Sx, C))
    w = rng.normal(0, 0.3, size=(K, C))
    b = rng.normal(0, 0.1, size=(C,))
    st = rng.normal(size=(Bx, K - 1, C)) if with_state else None
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jst = None if st is None else jnp.asarray(st, jnp.bfloat16)
    tst = None if st is None else torch.from_numpy(st).to(torch.bfloat16)
    jy, js = jmamba._causal_conv(jx, jnp.asarray(w, jnp.float32),
                                 jnp.asarray(b, jnp.float32), jst)
    ty, ts = tmamba._causal_conv(tx, torch.from_numpy(w).float(),
                                 torch.from_numpy(b).float(), tst)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ts), _np(js))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0,
                               atol=_bf16_step(np.abs(_np(jy)).max()))


def test_causal_conv_streams():
    """Whole sequence ≡ two pieces with the state carried, bitwise."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 17, 32))).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(0, 0.3, size=(4, 32))).float()
    b = torch.from_numpy(rng.normal(0, 0.1, size=(32,))).float()
    y, st = tmamba._causal_conv(x, w, b)
    y1, s1 = tmamba._causal_conv(x[:, :9], w, b)
    y2, s2 = tmamba._causal_conv(x[:, 9:], w, b, state=s1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(s2, st) and torch.equal(st, x[:, -3:])
    # one token at a time, as decode runs it
    s, ys = None, []
    for t in range(x.shape[1]):
        yt, s = tmamba._causal_conv(x[:, t:t + 1], w, b, state=s)
        ys.append(yt)
    assert torch.equal(torch.cat(ys, 1), y)


def test_segsum_matches_reference():
    a = np.random.default_rng(5).uniform(-2, 0, size=(2, 3, 16))
    ja, ta = _both(a)
    want, got = _np(jmamba._segsum(ja)), _np(tmamba._segsum(ta))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()
    assert not np.isinf(got[..., 1, 0]).any()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=F32_ATOL,
                               atol=F32_ATOL)
    assert (np.exp(got[~fin]) == 0).all()


@pytest.mark.parametrize("use_h0", [False, True])
@pytest.mark.parametrize("S_,chunk", [(64, 16), (96, 32), (50, 32)])
def test_ssd_chunked_matches_reference(S_, chunk, use_h0):
    """With and without an initial state; S a multiple of the chunk and
    not (the padded tail of dt = 0)."""
    d = _ssd_inputs(S_, seed=S_)
    j = {k: _both(v)[0] for k, v in d.items()}
    t = {k: _both(v)[1] for k, v in d.items()}
    jy, jh = jmamba.ssd_chunked(j["x"], j["dt"], j["A"], j["Bm"], j["Cm"],
                                chunk, h0=j["h0"] if use_h0 else None)
    ty, th = tmamba.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                                chunk, h0=t["h0"] if use_h0 else None)
    assert tuple(ty.shape) == jy.shape and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=0, atol=SSD_ATOL)


def test_ssd_chunked_rounds_to_the_input_dtype():
    """bf16 inputs: the scan runs in float32 and rounds y to bf16, as the
    reference does; the state stays float32."""
    d = _ssd_inputs(40, seed=9)
    jx = jnp.asarray(d["x"], jnp.bfloat16)
    tx = torch.from_numpy(d["x"]).to(torch.bfloat16)
    rest = [d[k] for k in ("dt", "A", "Bm", "Cm")]
    jy, jh = jmamba.ssd_chunked(jx, *[_both(a)[0] for a in rest], 32)
    ty, th = tmamba.ssd_chunked(tx, *[_both(a)[1] for a in rest], 32)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0,
                               atol=_bf16_step(np.abs(_np(jy)).max()))
    np.testing.assert_allclose(_np(th), _np(jh), rtol=0, atol=SSD_ATOL)


def test_ssd_step_matches_reference():
    d = _ssd_inputs(1, seed=11)
    j = [_both(d[k][:, 0] if k in ("x", "dt", "Bm", "Cm") else d[k])[0]
         for k in ("x", "dt", "A", "Bm", "Cm", "h0")]
    t = [_both(d[k][:, 0] if k in ("x", "dt", "Bm", "Cm") else d[k])[1]
         for k in ("x", "dt", "A", "Bm", "Cm", "h0")]
    jy, jh = jmamba.ssd_step(*j)
    ty, th = tmamba.ssd_step(*t)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6, atol=F32_ATOL)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-6, atol=F32_ATOL)


@pytest.mark.parametrize("S_,chunk", [(64, 16), (96, 32), (50, 32)])
def test_port_chunked_matches_stepwise(S_, chunk):
    """The mirror of the JAX package's own ``test_ssd_chunked_matches_
    stepwise``, same inputs, same tolerance, on the port alone."""
    d = _ssd_inputs(S_, seed=S_)
    t = {k: _both(v)[1] for k, v in d.items()}
    y, h = tmamba.ssd_chunked(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"],
                              chunk, h0=t["h0"])
    hh, ys = t["h0"], []
    for i in range(S_):
        yt, hh = tmamba.ssd_step(t["x"][:, i], t["dt"][:, i], t["A"],
                                 t["Bm"][:, i], t["Cm"][:, i], hh)
        ys.append(yt)
    np.testing.assert_allclose(_np(y), _np(torch.stack(ys, 1)), atol=SSD_ATOL)
    np.testing.assert_allclose(_np(h), _np(hh), atol=SSD_ATOL)


# ------------------------------------------------------------------ the model

def _layer_j(jp, l):
    return {k.split("/", 1)[1]: v[l] for k, v in jp.items()
            if k.startswith("layers/")}


def test_blocks_equal_reference_op_by_op(setup):
    """The reference's scan body (``_mamba_block``) run layer by layer
    outside any compiled scan, and the port's: each layer's output within
    BLOCK_STEPS bf16 steps, on the same input; the conv states bitwise."""
    jcfg, tcfg, jp, tp, prompt = setup
    jx = jlayers.take_rows(jp["embed"], jnp.asarray(prompt, jnp.int32))
    for l in range(jcfg.n_layers):
        tx = torch.from_numpy(_np(jx)).to(torch.bfloat16)
        jo, ((jcx, jcbc), jh) = jmamba._mamba_block(jcfg, _layer_j(jp, l), jx)
        with torch.inference_mode():
            to, ((tcx, tcbc), th) = tmamba._mamba_block(
                tcfg, tmamba._layer(tp, l), tx)
        step = _bf16_step(np.abs(_np(jo)).max())
        np.testing.assert_allclose(_np(to), _np(jo), rtol=0,
                                   atol=BLOCK_STEPS * step, err_msg=str(l))
        np.testing.assert_array_equal(_np(tcx), _np(jcx))
        np.testing.assert_array_equal(_np(tcbc), _np(jcbc))
        assert_state_close(th, jh, STATE_OP_RTOL, lead=0, what=str(l))
        jx = jx + jo


def _assert_logits(tl, jl):
    t, j = _np(tl), _np(jl)
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    for b, s in np.ndindex(*j.shape[:2]):
        best = float(j[b, s].max())
        gap = best - float(j[b, s, t[b, s].argmax()])
        assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (b, s)


def test_forward_matches_reference(setup):
    jcfg, tcfg, jp, tp, prompt = setup
    jx, _ = jmamba.forward(jcfg, jp, jnp.asarray(prompt, jnp.int32))
    with torch.inference_mode():
        tx, caches = tmamba.forward(tcfg, tp, torch.as_tensor(prompt))
    assert caches is None
    _assert_logits(tmamba.logits_fn(tcfg, tp, tx),
                   jmamba.logits_fn(jcfg, jp, jx))


def test_prefill_and_decode_logits_match_reference(setup):
    """Prefill, then STEPS greedy decode steps fed the reference's tokens;
    the state cache's shapes and dtypes are the reference's."""
    jcfg, tcfg, jp, tp, prompt = setup
    jl, jc = jmamba.prefill(jcfg, jp, jnp.asarray(prompt, jnp.int32))
    with torch.inference_mode():
        tl, tc = tmamba.prefill(tcfg, tp, torch.as_tensor(prompt))
    assert tl.shape == tuple(jl.shape) == (B, 1, tcfg.padded_vocab())
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32}[jc[key].dtype] == \
            tc[key].dtype, key
    # layer 0's conv states come before any SSD: bitwise
    np.testing.assert_array_equal(_np(tc["conv_x"][0]), _np(jc["conv_x"][0]))
    _assert_logits(tl, jl)
    for key in jc:
        assert_state_close(tc[key], jc[key], STATE_RTOL, what=key)
    tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    for i in range(STEPS):
        jl, jc = jmamba.decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                    jc, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tmamba.decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                        S + i)
        _assert_logits(tl, jl)
        for key in jc:
            assert_state_close(tc[key], jc[key], STATE_RTOL, what=(key, i))
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def _assert_prefill_extension(tcfg, tp, prompt):
    with torch.inference_mode():
        full, want = tmamba.prefill(tcfg, tp, torch.as_tensor(prompt))
        _, cache = tmamba.prefill(tcfg, tp, torch.as_tensor(prompt[:, :-1]))
        step, got = tmamba.decode_step(tcfg, tp,
                                       torch.as_tensor(prompt[:, -1:]), cache,
                                       S - 1)
    np.testing.assert_allclose(_np(full[:, -1]), _np(step[:, -1]),
                               atol=0.15, rtol=0.05)
    for key in want:
        assert_state_close(got[key], want[key], STATE_OP_RTOL, what=key)


def test_decode_step_matches_prefill_extension(setup):
    """decode_step of the last token at S-1 after a prefill of S-1 tokens ≡
    prefill of all S tokens (the reference's check, its tolerance); the
    state it leaves equal to the prefill's (``STATE_OP_RTOL``)."""
    _assert_prefill_extension(*(setup[i] for i in (1, 3, 4)))


def test_ssd_term_visible_decode_matches_prefill_extension(amplified):
    _assert_prefill_extension(*(amplified[i] for i in (1, 3, 4)))


def test_ssd_term_visible_prefill_and_decode_match_reference(amplified):
    """With the SSD term visible: zeroing the SSM state before a decode
    step moves its logits by more than ten times ``ATOL``, while prefill
    and STEPS decode steps stay within ``ATOL`` of the reference run op by
    op and every state within ``STATE_RTOL``."""
    jcfg, tcfg, jp, tp, prompt = amplified
    with jax.disable_jit():
        jl, jc = jmamba.prefill(jcfg, jp, jnp.asarray(prompt, jnp.int32))
    with torch.inference_mode():
        tl, tc = tmamba.prefill(tcfg, tp, torch.as_tensor(prompt))
    _assert_logits(tl, jl)
    for key in jc:
        assert_state_close(tc[key], jc[key], STATE_RTOL, what=key)
    tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]
    with torch.inference_mode():
        blind = {k: v.clone() for k, v in tc.items()}   # updated in place
        blind["ssm"].zero_()
        bl, _ = tmamba.decode_step(tcfg, tp, torch.as_tensor(tok), blind, S)
    for i in range(STEPS):
        with jax.disable_jit():
            jl, jc = jmamba.decode_step(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                        jc, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tmamba.decode_step(tcfg, tp, torch.as_tensor(tok), tc,
                                        S + i)
        if i == 0:
            assert float(np.abs(_np(bl) - _np(tl)).max()) > 10 * ATOL
        _assert_logits(tl, jl)
        for key in jc:
            assert_state_close(tc[key], jc[key], STATE_RTOL, what=(key, i))
        tok = np.argmax(_np(jl)[:, -1], axis=-1)[:, None]


def test_state_cache_is_constant_in_length(setup):
    _, tcfg, *_ = setup
    a = tmamba.init_cache(tcfg, 2, 16, device="cpu")
    b = tmamba.init_cache(tcfg, 2, 4096, device="meta")
    assert {k: v.shape for k, v in a.items()} == \
        {k: v.shape for k, v in b.items()}
    assert a["ssm"].dtype == torch.float32 and \
        a["conv_x"].dtype == torch.bfloat16


def assert_family_spec_keeps_ssm_tensors_fp32(family, cfg):
    """``chip_smoke.py``'s spec for ``family``: the SSM's sensitive tensors
    (``A_log``, ``dt_bias``, ``D_skip``, the conv weights) and the norms
    stay float32, though a catch-all rule follows (a matching rule
    overrides the keep-fp32 predicate); every other tensor is quantized;
    the container holds Huffman-8 and rANS-4 groups; and the JAX package
    resolves every tensor under the same spec text the same way."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro.core.quant import Granularity as JGranularity
    from repro.core.spec import CompressionSpec as JSpec
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec
    from repro_torch.core.store import CompressedModel
    host = chip_smoke.family_host_weights(cfg)
    text = chip_smoke.FAMILY_SPEC[family]
    spec = CompressionSpec.parse(text,
                                 default_granularity=Granularity.PER_CHANNEL)
    cm = CompressedModel.compress(host, spec=spec)
    for key in ("A_log", "dt_bias", "D_skip", "conv_x_w", "conv_x_b",
                "conv_bc_w", "conv_bc_b"):
        names = [n for n in host if n.endswith("/" + key)]
        assert names and set(names) <= set(cm.unquantized), key
    assert set(cm.unquantized) == set(chip_smoke.carve_outs(host))
    assert {g.table_id for g in cm.stats().groups} == {"huffman8", "rans4"}
    jspec = JSpec.parse(text, default_granularity=JGranularity.PER_CHANNEL)
    for name, w in host.items():
        a, b = spec.resolve(name, w), jspec.resolve(name, w)
        assert (a.quantize, a.bits, a.codec) == (b.quantize, b.bits,
                                                 b.codec), name


def test_family_spec_keeps_ssm_tensors_fp32(setup):
    _, tcfg, *_ = setup
    assert_family_spec_keeps_ssm_tensors_fp32("ssm", tcfg)
