"""The port's AdamW (``training/optimizer.py``) and gradient compression
(``distributed/grad_compress.py``) against the JAX package's, run op by op
(not jitted), on the CPU.

Bitwise wherever the arithmetic is elementwise float32: ``_q8`` / ``_dq8``,
every parameter and moment ``apply_updates`` returns (f32 and Q8 moments)
while the gradient norm is under ``clip_norm`` (so the clip factor is
exactly 1), ``compress_decompress`` and ``ef_compress``.  Two things are not:

- ``Schedule``: the two CPU libraries' float32 ``cos`` differ by one ulp on
  a few inputs, so the learning rate is held to two ulps at every step
  (the products after the cos carry the one ulp on), and
  the first step where it differs on the test schedule is pinned.
- ``global_norm`` sums each leaf in the library's own order, so the
  gradient norm (and with clipping, every update) is held to a relative
  ``NORM_RTOL``.

The port's float32 square root goes through float64 on the CPU, because
``torch.sqrt`` there is not correctly rounded (``test_sqrt_is_correctly
_rounded``), where XLA's is.

The JAX package's jitted versions split from its op-by-op ones (XLA turns a
division by a constant into a multiply, and fuses the schedule); each split
is pinned by its own test, as ``test_reference_kv_quantize_jit_split``
pins the KV quantizer's (ROADMAP queue 3).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.distributed import grad_compress as jgc
from repro.training import optimizer as jopt
from repro_torch.checkpoint.checkpointer import flatten_with_path
from repro_torch.distributed import grad_compress as tgc
from repro_torch.training import optimizer as topt
from test_torch_train_loss import few_threads  # noqa: F401

NORM_RTOL = 1e-5
SCHEDULES = [dict(base_lr=1e-3, warmup_steps=2, total_steps=20), dict(),
             dict(base_lr=3e-4, warmup_steps=7, total_steps=123,
                  min_ratio=0.05)]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32).astype(np.int64)


def _j(x, dtype=None):
    return jnp.asarray(x, dtype)


def _t(x):
    return torch.from_numpy(np.asarray(x)).clone()


# ------------------------------------------------------------------- Schedule

@pytest.mark.parametrize("kw", SCHEDULES, ids=["smoke", "default", "odd"])
def test_schedule_within_two_ulps_of_reference(kw):
    js, ts = jopt.Schedule(**kw), topt.Schedule(**kw)
    steps = np.arange(0, 300, dtype=np.int32)
    want = np.array([np.asarray(js(jnp.int32(s))) for s in steps])
    got = np.array([ts(torch.tensor(int(s), dtype=torch.int32)).numpy()
                    for s in steps])
    ulps = np.abs(_bits(got) - _bits(want))
    assert ulps.max() <= 2
    assert (ulps > 0).sum() <= 3


def test_schedule_first_cos_split_is_pinned():
    """On the smoke's schedule the two libraries' cos differ first at step
    16 (prog 14/18): 0.00020527992 (reference) against 0.00020527995."""
    kw = SCHEDULES[0]
    js, ts = jopt.Schedule(**kw), topt.Schedule(**kw)
    diff = [s for s in range(300)
            if np.asarray(js(jnp.int32(s))).tobytes()
            != ts(torch.tensor(s, dtype=torch.int32)).numpy().tobytes()]
    assert diff == [16]
    assert float(np.asarray(js(jnp.int32(16)))) == np.float32(
        0.0002052799245575443)
    assert float(ts(torch.tensor(16, dtype=torch.int32))) == np.float32(
        0.00020527995366137475)


def test_reference_schedule_jit_split():
    """The reference's jitted schedule differs from its op-by-op one at 4
    of 300 steps on the smoke's schedule, first at step 4."""
    js = jopt.Schedule(**SCHEDULES[0])
    jj = jax.jit(js)
    diff = [s for s in range(300) if np.asarray(jj(jnp.int32(s))).tobytes()
            != np.asarray(js(jnp.int32(s))).tobytes()]
    assert len(diff) == 4 and diff[0] == 4


# --------------------------------------------------------------------- _q8

def _moment_rows(seed=0):
    x = np.random.default_rng(seed).normal(0, 1e-3, (64, 256)).astype(
        np.float32)
    x[3] = np.abs(x[3])            # one sign: symmetric
    x[4] = 0.0                     # all zero: scale 1
    x[5] = 7.0                     # constant
    x[6] = -np.abs(x[6])
    return x


def test_q8_and_dq8_bitwise():
    x = _moment_rows()
    want = jopt._q8(_j(x))
    got = topt._q8(_t(x))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert got[0].dtype == torch.uint8 and tuple(got[1].shape) == (64, 1)
    np.testing.assert_array_equal(
        np.asarray(jopt._dq8(*want, x.shape)),
        topt._dq8(*got).numpy())


def test_reference_q8_jit_split():
    """Jitted, the reference's ``_q8`` gives other scales in 42 of 64 rows
    (``absmax / 255`` becomes a multiply by the reciprocal); its symbols and
    zeros agree."""
    x = _moment_rows()
    eager = jopt._q8(_j(x))
    jit = jax.jit(jopt._q8)(_j(x))
    split = [int((np.asarray(a) != np.asarray(b)).sum())
             for a, b in zip(eager, jit)]
    assert split == [0, 42, 0]


@pytest.mark.parametrize("shape,want", [((256, 256), True), ((1024, 63),
                                                             False),
                                        ((255, 256), False),
                                        ((65536,), True)])
def test_use_q8_rule(shape, want):
    assert topt._use_q8(shape) == jopt._use_q8(shape) == want


def test_sqrt_is_correctly_rounded():
    x = np.random.default_rng(5).random(10 ** 6).astype(np.float32) * 1e-8
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(_j(x))), want)
    np.testing.assert_array_equal(topt._sqrt(_t(x)).numpy(), want)
    # the CPU library's own sqrt is not, which is why the port avoids it
    assert (torch.sqrt(_t(x)).numpy() != want).sum() > 0


# ------------------------------------------------------------ apply_updates

BF16 = ("layers/wq", "embed")


def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"layers/wq": r.normal(0, .02, (4, 128, 256)).astype(np.float32),
            "final_norm": (1 + r.normal(0, .01, 128)).astype(np.float32),
            "embed": r.normal(0, .02, (512, 128)).astype(np.float32),
            "small": r.normal(0, .02, (16, 32)).astype(np.float32),
            "conv_b": r.normal(0, .02, (96,)).astype(np.float32)}


def _both(tree):
    jt = {k: _j(v, jnp.bfloat16 if k in BF16 else jnp.float32)
          for k, v in tree.items()}
    tt = {k: _t(v).to(torch.bfloat16 if k in BF16 else torch.float32)
          for k, v in tree.items()}
    return jt, tt


def _leaves(tree):
    return [np.asarray(jnp.asarray(x).astype(jnp.float32))
            if not isinstance(x, torch.Tensor) else x.float().numpy()
            for _, x in flatten_with_path(tree)]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_apply_updates_bitwise_op_by_op(q8):
    """Four steps of small gradients (norm < clip_norm): every parameter,
    moment (Q8 symbols, scales and zeros) and the step bitwise; the grad
    norm within NORM_RTOL."""
    sched = dict(base_lr=1e-3, warmup_steps=2, total_steps=20)
    jc = jopt.AdamWConfig(schedule=jopt.Schedule(**sched), quantized_state=q8)
    tc = topt.AdamWConfig(schedule=topt.Schedule(**sched), quantized_state=q8)
    jp, tp = _both(_tree())
    js, ts = jopt.init_state(jc, jp), topt.init_state(tc, tp)
    for st in range(4):
        g = {k: np.random.default_rng(10 + st).normal(0, 1e-4, v.shape)
             .astype(np.float32) for k, v in _tree().items()}
        jg, tg = _both(g)
        jp, js, jm = jopt.apply_updates(jc, jp, jg, js)
        tp, ts, tm = topt.apply_updates(tc, tp, tg, ts)
        assert float(jm["grad_norm"]) < jc.clip_norm
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert float(tm["lr"]) == float(jm["lr"])
        for k in jp:
            assert tp[k].dtype == (torch.bfloat16 if k in BF16
                                   else torch.float32)
        for a, b in zip(_leaves((jp, js)), _leaves((tp, ts))):
            np.testing.assert_array_equal(a, b)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 4
    if q8:
        assert isinstance(ts.m["layers/wq"], topt.Q8Moment)
        assert not isinstance(ts.m["small"], topt.Q8Moment)


def test_apply_updates_with_clipping_matches_reference():
    """Gradients above clip_norm: the clip factor comes from the norm, so
    the updates are held to the norm's tolerance."""
    jc, tc = jopt.AdamWConfig(), topt.AdamWConfig()
    jp, tp = _both(_tree())
    g = {k: np.random.default_rng(3).normal(0, 0.5, v.shape).astype(
        np.float32) for k, v in _tree().items()}
    jg, tg = _both(g)
    jp2, js2, jm = jopt.apply_updates(jc, jp, jg, jopt.init_state(jc, jp))
    tp2, ts2, tm = topt.apply_updates(tc, tp, tg, topt.init_state(tc, tp))
    assert float(jm["grad_norm"]) > 10 * jc.clip_norm
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=NORM_RTOL)
    for a, b in zip(_leaves((jp2, js2.m)), _leaves((tp2, ts2.m))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-9)


def test_apply_updates_does_not_touch_its_inputs():
    tc = topt.AdamWConfig(quantized_state=True)
    _, tp = _both(_tree())
    _, tg = _both({k: v * 0.01 for k, v in _tree(1).items()})
    ts = topt.init_state(tc, tp)
    before = [x.clone() for _, x in flatten_with_path((tp, tg, ts))]
    topt.apply_updates(tc, tp, tg, ts)
    for a, (_, b) in zip(before, flatten_with_path((tp, tg, ts))):
        assert torch.equal(a, b)


def test_slices_give_the_unsliced_update_bitwise(monkeypatch):
    tc = topt.AdamWConfig(quantized_state=True)
    _, tp = _both(_tree())
    _, tg = _both({k: v * 0.01 for k, v in _tree(1).items()})
    whole = topt.apply_updates(tc, tp, tg, topt.init_state(tc, tp))[:2]
    monkeypatch.setattr(topt, "_SLICE_ELEMENTS", 3000)
    assert len(topt._slices((4, 128, 256))) == 4
    sliced = topt.apply_updates(tc, tp, tg, topt.init_state(tc, tp))[:2]
    for (_, a), (_, b) in zip(flatten_with_path(whole),
                              flatten_with_path(sliced)):
        assert torch.equal(a, b)


def test_moment_bytes():
    _, tp = _both(_tree())
    n = sum(v.numel() for v in tp.values())
    assert topt.moment_bytes(topt.init_state(topt.AdamWConfig(), tp)) \
        == 8 * n
    q8 = topt.moment_bytes(topt.init_state(
        topt.AdamWConfig(quantized_state=True), tp))
    big = 4 * 128 * 256 + 512 * 128        # layers/wq and embed
    assert q8 == 2 * (big + 2 * 4 * (4 * 128 + 512)) + 8 * (n - big)


@pytest.mark.parametrize("name,want", [("layers/wq", True),
                                       ("final_norm", False),
                                       ("layers/A_log", False),
                                       ("layers/dt_bias", False),
                                       ("layers/conv_bc_b", True)])
def test_decay_mask(name, want):
    assert topt.AdamWConfig.decay_mask(name) \
        == jopt.AdamWConfig.decay_mask(name) == want


# ------------------------------------------------------- gradient compression

def _grads(seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.normal(0, .01, (3, 1000)).astype(np.float32),
            "b": r.normal(0, 1, (100,)).astype(np.float32),
            "z": np.zeros((512,), np.float32)}


def test_compress_decompress_bitwise():
    g = _grads()
    want = jgc.compress_decompress({k: _j(v) for k, v in g.items()})
    got = tgc.compress_decompress({k: _t(v) for k, v in g.items()})
    for k in g:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())
    assert torch.equal(got["b"], _t(g["b"]))          # under one block
    q, s, z = tgc._q8_blockwise(_t(g["w"]))
    for a, b in zip(jgc._q8_blockwise(_j(g["w"])), (q, s, z)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tuple(q.shape) == (12, 256)


def test_reference_compress_decompress_jit_split():
    """Jitted, the reference's quantize-dequantize differs from its op-by-
    op run in 2,825 of the 3,000 elements of ``w`` (the scale's division
    becomes a multiply); the small leaf rides along unchanged."""
    g = {k: _j(v) for k, v in _grads().items()}
    eager = jgc.compress_decompress(g)
    jit = jax.jit(jgc.compress_decompress)(g)
    assert int((np.asarray(eager["w"]) != np.asarray(jit["w"])).sum()) \
        == 2825
    np.testing.assert_array_equal(np.asarray(eager["b"]),
                                  np.asarray(jit["b"]))


def test_ef_compress_bitwise_and_unbiased():
    """Error feedback over 30 steps: each step bitwise the reference's, and
    the mean compressed gradient within 1e-4 of the true one
    (``tests/test_integration.py:246``)."""
    g = np.random.default_rng(0).normal(0, 0.01, (4096,)).astype(np.float32)
    jr = tr = None
    acc = torch.zeros(4096)
    for _ in range(30):
        jc, jr = jgc.ef_compress({"w": _j(g)}, jr)
        tcg, tr = tgc.ef_compress({"w": _t(g)}, tr)
        np.testing.assert_array_equal(np.asarray(jc["w"]), tcg["w"].numpy())
        np.testing.assert_array_equal(np.asarray(jr["w"]), tr["w"].numpy())
        acc = acc + tcg["w"]
    assert float((acc / 30 - _t(g)).abs().max()) < 1e-4
    ratio = tgc.wire_bytes({"w": _t(g)}, compressed=True) / tgc.wire_bytes(
        {"w": _t(g)}, compressed=False)
    assert ratio < 0.3


def test_wire_bytes_equal_reference():
    g = _grads()
    for compressed in (False, True):
        assert tgc.wire_bytes({k: _t(v) for k, v in g.items()},
                              compressed=compressed) \
            == jgc.wire_bytes({k: _j(v) for k, v in g.items()},
                              compressed=compressed)
