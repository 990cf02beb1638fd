"""The port's train step and loop (``training/train_loop.py``) against the
JAX package's, and the JAX package's own training criteria
(``tests/test_integration.py``) on the port, on the CPU, reduced configs.

Tolerances.
- One step against the reference's jitted step, from the same weights and
  batch: the loss within ``LOSS_ATOL`` = 2e-3 (``test_torch_train_loss``),
  the gradient norm within 5e-2 relative, and every updated parameter
  within ``2.5 x lr`` of the reference's: the first Adam update is about
  ``lr`` times the sign of the gradient, so a gradient entry near zero whose
  sign differs moves by up to ``2 x lr``.
- Trajectories (``test_torch_train_q8_vocab``): the first steps' losses
  within ``TRAJ_ATOL`` = 2e-2 of the reference's (the bf16 weights drift
  apart by an update now and then).
- The reference's own criteria, as stated there, on 8 x 33-token batches
  (the reference's tests take 8 x 64): the loss falls by more than 0.05
  in 15 steps (``:33``); Q8 moments end within 0.15 of f32 ones
  (``:39``); 1 and 2 microbatches within 0.02 in loss and 5e-3 in every
  parameter (``:54``); 8- and 4-bit weight gathers end within 0.1 / 0.2
  (``:283``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop
from test_torch_train_loss import few_threads  # noqa: F401

LOSS_ATOL = 2e-3
TRAJ_ATOL = 2e-2
SCHED = dict(base_lr=1e-3, warmup_steps=2, total_steps=15)


def _tc(mod, steps=15, q8=False, **kw):
    return mod.TrainConfig(opt=mod.opt.AdamWConfig(
        schedule=mod.opt.Schedule(**dict(SCHED, total_steps=steps)),
        quantized_state=q8), **kw)


def _setup(arch="qwen3-1.7b", vocab=None):
    jcfg = jreg.reduced(jreg.get(arch))
    tcfg = treg.reduced(treg.get(arch))
    if vocab:
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
        tcfg = dataclasses.replace(tcfg, vocab=vocab)
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, tcfg, jp, convert.params_from_numpy(tcfg, host, "cpu")


def _src(cfg, seq_len=33):
    return DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=8,
                      seed=0)


def test_one_step_matches_reference():
    jcfg, tcfg, jp, tp = _setup()
    batch = SyntheticSource(_src(tcfg, 33)).batch(0)
    jtc, ttc = _tc(jloop), _tc(tloop)
    jp2, js2, jm = jax.jit(jloop.make_train_step(jcfg, jtc))(
        jp, jopt.init_state(jtc.opt, jp), {"tokens": jnp.asarray(
            batch["tokens"])})
    tp2, ts2, tm = tloop.make_train_step(tcfg, ttc)(
        tp, topt.init_state(ttc.opt, tp),
        tloop.to_device(batch, torch.device("cpu")))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-2)
    lr = float(jm["lr"])
    assert float(tm["lr"]) == lr
    assert int(ts2.step) == int(js2.step) == 1
    for k in jp:
        want = np.asarray(jp2[k], np.float32)
        got = tp2[k].float().numpy()
        assert tp2[k].dtype == tp[k].dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=2.5 * lr,
                                   err_msg=k)
        assert not np.array_equal(got, np.asarray(jp[k], np.float32)), k


def _train(cfg, tc, params, steps, src=None):
    src = src or SyntheticSource(_src(cfg))
    state = topt.init_state(tc.opt, params)
    return tloop.train(cfg, tc, params, state, iter(src), steps)


def test_fifteen_steps_reduce_loss():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, info = _train(cfg, _tc(tloop), params, 15)
    losses = [h["loss"] for h in info["history"]]
    assert losses[-1] < losses[0] - 0.05
    assert all(isinstance(v, float) for h in info["history"]
               for v in h.values())
    assert set(info["history"][0]) == {"loss", "grad_norm", "lr"}
    assert info["wall_s"] > 0 and info["steps_per_s"] > 0


def test_q8_moments_track_f32_moments():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    finals = {}
    for q8 in (False, True):
        _, state, info = _train(cfg, _tc(tloop, q8=q8), params, 15)
        finals[q8] = info["history"][-1]["loss"]
        assert isinstance(state.m["embed"], topt.Q8Moment) == q8
    assert abs(finals[True] - finals[False]) < 0.15


def test_microbatches_match_one_batch():
    cfg = treg.reduced(treg.get("glm4-9b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 65)).astype(np.int32))}
    outs = {}
    for mb in (1, 2):
        tc = tloop.TrainConfig(opt=topt.AdamWConfig(), microbatches=mb)
        p2, _, m = tloop.make_train_step(cfg, tc)(
            params, topt.init_state(tc.opt, params), batch)
        outs[mb] = (p2, float(m["loss"]))
    assert abs(outs[1][1] - outs[2][1]) < 0.02
    for k in params:
        np.testing.assert_allclose(outs[1][0][k].float().numpy(),
                                   outs[2][0][k].float().numpy(), atol=5e-3)


def test_microbatch_grads_are_the_mean_and_bf16_accumulation_runs():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 17)).astype(np.int32))}
    one = tloop.make_grad_fn(cfg, tloop.TrainConfig(remat=False))
    halves = [one(params, {"tokens": batch["tokens"][i:i + 2]})
              for i in (0, 2)]
    loss, grads = tloop.make_grad_fn(cfg, tloop.TrainConfig(
        microbatches=2, remat=False))(params, batch)
    assert float(loss) == float((halves[0][0] + halves[1][0]) * 0.5)
    for n in grads:
        assert grads[n].dtype == torch.float32
        want = ((torch.zeros_like(grads[n]) + halves[0][1][n].float())
                + halves[1][1][n].float()) * 0.5
        assert torch.equal(grads[n], want), n
    loss16, g16 = tloop.make_grad_fn(cfg, tloop.TrainConfig(
        microbatches=2, grad_accum_dtype="bf16"))(params, batch)
    assert all(g.dtype == torch.float32 for g in g16.values())
    assert abs(float(loss16) - float(loss)) < 1e-6


def test_ste_weight_gathers_converge():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    finals = {}
    for bits in (0, 8, 4):
        _, _, info = _train(cfg, _tc(tloop, steps=12, q8_gather=bits),
                            params, 12)
        finals[bits] = info["history"][-1]["loss"]
        assert finals[bits] < info["history"][0]["loss"] - 0.05
    assert abs(finals[8] - finals[0]) < 0.1
    assert abs(finals[4] - finals[0]) < 0.2


def test_grad_compression_converges():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, info = _train(cfg, _tc(tloop, grad_compress=True), params, 15)
    losses = [h["loss"] for h in info["history"]]
    assert losses[-1] < losses[0] - 0.05


def test_a_hook_that_returns_a_state_replaces_it():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    tc = _tc(tloop)
    state0 = topt.init_state(tc.opt, params)
    seen = []

    def hook(i, p, s, m):
        seen.append((i, int(s.step), m["loss"]))
        if i == 1:
            return params, state0                      # roll back
        return None

    p, s, info = tloop.train(cfg, tc, params, state0,
                             iter(SyntheticSource(_src(cfg, 17))), 3,
                             hooks=(hook,))
    assert [(i, st) for i, st, _ in seen] == [(0, 1), (1, 2), (2, 1)]
    assert int(s.step) == 1
    assert [h["loss"] for h in info["history"]] == [x for *_, x in seen]
    assert all(math.isfinite(x) for *_, x in seen)


def test_ste_quantize_params_matches_reference():
    jcfg, tcfg, jp, tp = _setup()
    from repro.models.layers import QTG as JQTG
    for bits in (8, 4):
        want = jloop.ste_quantize_params(jp, bits)
        got = tloop.ste_quantize_params(tp, bits)
        assert set(want) == set(got)
        for k in want:
            assert isinstance(want[k], JQTG) == hasattr(got[k], "master"), k
            if isinstance(want[k], JQTG):
                for a, b in zip(want[k][:3], got[k][:3]):
                    np.testing.assert_array_equal(np.asarray(a), b.numpy())
