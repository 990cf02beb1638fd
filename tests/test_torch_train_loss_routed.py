"""Training parity of the routed families: the port's MoE (qwen2-moe-a2.7b)
and hybrid (jamba-1.5-large-398b) losses and gradients against the JAX
package's, reduced, on the CPU, at ``capacity_factor`` 8.0 (no choice is
dropped, so a token's routing reaches no other token's output).

The JAX package's compiled forward flips router near-ties that its op-by-op
run does not (ROADMAP queue 3 items 5-6), and ``value_and_grad`` runs the
layer scan compiled.  So both packages' router choices are recorded call
by call, and every choice that differs must be a near-tie (two bf16 steps
of the port's probabilities).  A flipped choice at (row, position) changes
that token's expert outputs, which reach:

- the cross-entropy of that row from that position on (its own output and,
  through causal attention in later layers, the later positions' outputs);
- the load-balance aux term (its expert counts), and through the aux's
  gradient the router and every leaf upstream of it.

So the comparison masks the labels of each flipped row from the flip on
(labels >= vocab are masked by ``softmax_xent``), and keeps the aux term:
the loss within ``LOSS_ATOL`` and every gradient within ``GRAD_REL_L2`` /
``GRAD_COS``, the tolerances of ``test_torch_train_loss.py``.  The masked
loss is each package's ``loss_fn`` with other labels (the same forward,
logits, ``softmax_xent`` and ``0.01 * aux``); the port's is held bitwise to
its ``loss_fn`` on the unmasked labels.  On this seed the reference's
compiled run flips one MoE choice (layer 3, row 0, position 7, which moves
the unmasked loss by 2.03e-3) and four of the hybrid's.  The port run op by
op equals the reference run op by op (``jax.disable_jit``; not run here, it
takes ~30 s a family): the same loss to 6e-7, gradients within 2.5e-2.

Dropping the aux term fails the loss check: 0.01 x aux is ~1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.models import dense as jdense
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.models import api as tapi
from repro_torch.models import dense as tdense
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

from test_torch_moe import NEAR_TIE_STEPS, _bf16_step
from test_torch_train_loss import (GRAD_COS, GRAD_REL_L2, LOSS_ATOL,
                                   assert_grads_close, build, make_batch,
                                   port_grads)
from test_torch_train_loss import few_threads  # noqa: F401

AUX_COEF = 0.01
EXPECTED_FLIPS = {"qwen2-moe-a2.7b": [(3, 0, 7)],
                  "jamba-1.5-large-398b": [(0, 0, 7), (0, 1, 6), (2, 1, 2),
                                           (2, 1, 5)]}


def _wide(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))


def _logits_fn(mod):
    return getattr(mod, "logits_fn", None) or jdense.logits_fn


def reference_loss(jcfg):
    """The reference's ``loss_fn`` with labels as an argument (its
    ``moe.py:266`` / ``hybrid.py:211``, forward run without remat)."""
    jm = japi.build(jcfg)
    logits_fn = getattr(jm, "logits_fn", jdense.logits_fn)

    def loss(p, tokens, labels):
        x, _, aux = jm.forward(jcfg, p, tokens[:, :-1], remat=False)
        return jlayers.softmax_xent(logits_fn(jcfg, p, x), labels,
                                    jcfg.vocab) + AUX_COEF * aux
    return jax.jit(jax.value_and_grad(loss))


def port_loss(tcfg, labels):
    tm = tapi.build(tcfg)
    logits_fn = getattr(tm, "logits_fn", tdense.logits_fn)

    def loss(cfg, params, batch, *, remat):
        x, _, aux = tm.forward(cfg, params, batch["tokens"][:, :-1],
                               remat=remat)
        return tlayers.softmax_xent(logits_fn(cfg, params, x), labels,
                                    cfg.vocab) + AUX_COEF * aux
    return loss


def recording():
    """Patches each package's router to record its choices in call order;
    returns (port, reference, undo)."""
    port, ref = [], []
    t_route, j_mlp, h_mlp = tmoe.route, jmoe.moe_mlp, jhybrid.moe_mlp

    def t_recording(x, router, k):
        out = t_route(x, router, k)
        port.append((out[0].detach().float().numpy(), out[2].numpy()))
        return out

    def j_recording(x, wts, mcfg, E):
        probs = jax.nn.softmax(jlayers.matmul(x, wts["router"]).astype(
            jnp.float32), axis=-1)
        jax.debug.callback(lambda i: ref.append(np.asarray(i)),
                           jax.lax.top_k(probs, mcfg.top_k)[1], ordered=True)
        return j_mlp(x, wts, mcfg, E)

    tmoe.route, jmoe.moe_mlp, jhybrid.moe_mlp = (t_recording, j_recording,
                                                 j_recording)

    def undo():
        tmoe.route, jmoe.moe_mlp, jhybrid.moe_mlp = t_route, j_mlp, h_mlp
    return port, ref, undo


def flips_of(port, ref):
    """(call, row, position) of every choice that differs, each asserted a
    near-tie of the port's probabilities."""
    assert len(port) == len(ref)
    flips = []
    for c, ((probs, tidx), jidx) in enumerate(zip(port, ref)):
        for b, s in zip(*np.nonzero((np.sort(tidx, -1) != np.sort(jidx, -1))
                                    .any(-1))):
            p = probs[b, s]
            gap = abs(float(p[np.setdiff1d(tidx[b, s], jidx[b, s])].min()
                            - p[np.setdiff1d(jidx[b, s], tidx[b, s])].max()))
            assert gap <= NEAR_TIE_STEPS * _bf16_step(
                np.sort(p)[-tidx.shape[-1]]), (c, b, s, gap)
            flips.append((c, int(b), int(s)))
    return flips


@pytest.fixture(scope="module", params=sorted(EXPECTED_FLIPS))
def routed(request):
    jcfg, tcfg, jp, tp = build(request.param)
    return request.param, _wide(jcfg), _wide(tcfg), jp, tp


def test_loss_and_grads_match_reference(routed):
    arch, jcfg, tcfg, jp, tp = routed
    host, _, tb = make_batch(jcfg)
    tokens = host["tokens"]
    ref_fn = reference_loss(jcfg)
    port, ref, undo = recording()
    try:
        ref_fn(jp, jnp.asarray(tokens), jnp.asarray(tokens[:, 1:]))
        port_loss_fn = tapi.build(tcfg).loss_fn
        with torch.no_grad():
            whole = port_loss_fn(tcfg, tp, tb, remat=False)
    finally:
        undo()
    flips = flips_of(port, ref)
    assert flips == EXPECTED_FLIPS[arch]
    labels = tokens[:, 1:].copy()
    for _, b, s in flips:
        labels[b, s:] = jcfg.vocab
    jl, jg = ref_fn(jp, jnp.asarray(tokens), jnp.asarray(labels))
    fn = port_loss(tcfg, torch.from_numpy(tokens[:, 1:]))
    with torch.no_grad():
        assert torch.equal(fn(tcfg, tp, tb, remat=False), whole)
    tl, tg = port_grads(tcfg, tp, tb,
                        loss_fn=port_loss(tcfg, torch.from_numpy(labels)))
    tl = float(tl.detach())
    assert abs(tl - float(jl)) <= LOSS_ATOL, (tl, float(jl))
    assert_grads_close(tg, jg)


def test_dropping_the_aux_term_fails_the_loss_check(routed):
    arch, jcfg, tcfg, jp, tp = routed
    _, _, tb = make_batch(jcfg)
    with torch.no_grad():
        x, _, aux = tapi.build(tcfg).forward(tcfg, tp, tb["tokens"][:, :-1])
    assert AUX_COEF * float(aux) > 2 * LOSS_ATOL
