"""The MoE feed-forward on the card against the same port on the CPU.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Reduced qwen2-moe-a2.7b (d_model 128, 16 padded experts, top-2, one shared
expert), seeded weights, 4 x 16 tokens.  The router's bf16 product on the
card may land a logit one bf16 step from the CPU's, so a router choice may
differ where the two probabilities are a near-tie: every choice that
differs must be within ``NEAR_TIE_STEPS`` bf16 steps of the CPU's
probabilities.  Where the choices agree the capacity slots are equal
bitwise, and the output is within ``Y_STEPS`` bf16 steps at its largest
magnitude (cuBLAS sums the experts' products in another order than the
CPU); with ``capacity_factor`` 8.0 (no choice dropped) a token whose choice
differs is left out and the others are compared, while at the published
1.25 a differing choice can move any token through the shared capacity, so
there the output is compared only when every choice agrees.
"""
import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import moe

NEAR_TIE_STEPS = 2
Y_STEPS = 2
CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_step(v):
    return 2.0 ** (math.frexp(abs(float(v)))[1] - 8)


@contextlib.contextmanager
def _routes():
    """Records each ``moe.route`` call's (probs, idx) on the host."""
    got = []
    orig = moe.route

    def recording(x, router, k):
        out = orig(x, router, k)
        got.append((out[0].float().cpu().numpy(), out[2].cpu().numpy()))
        return out

    moe.route = recording
    try:
        yield got
    finally:
        moe.route = orig


def routing_flips(card_routes, cpu_routes):
    """(row, position) of every choice that differs between the two runs,
    each asserted a near-tie of the CPU's probabilities."""
    flips = []
    for (_, a), (probs, b) in zip(card_routes, cpu_routes):
        for r, s in zip(*np.nonzero((np.sort(a, -1) != np.sort(b, -1))
                                    .any(-1))):
            p = probs[r, s]
            gap = abs(float(p[np.setdiff1d(a[r, s], b[r, s])].min()
                            - p[np.setdiff1d(b[r, s], a[r, s])].max()))
            assert gap <= NEAR_TIE_STEPS * _bf16_step(
                np.sort(p)[-b.shape[-1]]), (r, s, gap)
            flips.append((int(r), int(s)))
    return flips


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_mlp_on_card_equals_cpu(card, cf):
    cfg = registry.reduced(registry.get("qwen2-moe-a2.7b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    E, K = moe._padded_experts(cfg), cfg.moe.top_k
    params = moe.init(cfg, 0, CPU)
    wts = {k[len("layers/moe/"):]: v[0] for k, v in params.items()
           if k.startswith("layers/moe/")}
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32)).bfloat16()
    runs = []
    for dev in (card, CPU):
        with torch.inference_mode(), _routes() as routes:
            y, aux = moe.moe_mlp(x.to(dev), {k: v.to(dev)
                                             for k, v in wts.items()},
                                 cfg.moe, E)
        assert y.device.type == dev.type and y.dtype == torch.bfloat16
        runs.append((y.float().cpu().numpy(), float(aux), routes))
    (yc, auxc, rc), (yh, auxh, rh) = runs
    flips = routing_flips(rc, rh)
    C = moe._capacity(x.shape[0] * x.shape[1], K, E, cf)
    if not flips:
        got = moe._assign_slots(torch.from_numpy(rc[0][1].reshape(-1)).to(
            card), 0, E, C)
        want = moe._assign_slots(torch.from_numpy(rh[0][1].reshape(-1)), 0,
                                 E, C)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    elif cf < 8.0:
        # the shared capacity couples every token to a differing choice:
        # the near-ties are asserted above, the outputs only finite
        assert np.isfinite(yc).all()
        return
    keep = np.ones(yh.shape[:2], bool)
    for r, s in flips:
        keep[r, s] = False
    step = _bf16_step(np.abs(yh).max())
    np.testing.assert_allclose(yc[keep], yh[keep], rtol=0,
                               atol=Y_STEPS * step)
    assert auxc == pytest.approx(auxh, rel=1e-3)


@pytest.mark.cuda
def test_trash_slot_duplicates_leave_live_slots_alone(card):
    """A zero router sends every token to experts 0..K-1, so most choices
    overflow onto the one trash slot (index_put_ on the card keeps any of
    the duplicate writes); the live slots and the output equal the CPU's."""
    cfg = registry.reduced(registry.get("qwen2-moe-a2.7b"))
    E = moe._padded_experts(cfg)
    params = moe.init(cfg, 1, CPU)
    wts = {k[len("layers/moe/"):]: v[0] for k, v in params.items()
           if k.startswith("layers/moe/")}
    wts["router"] = torch.zeros_like(wts["router"])
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32)).bfloat16()
    out = []
    for dev in (card, CPU):
        with torch.inference_mode():
            y, _ = moe.moe_mlp(x.to(dev), {k: v.to(dev)
                                           for k, v in wts.items()},
                               cfg.moe, E)
        out.append(y.float().cpu().numpy())
    step = _bf16_step(np.abs(out[1]).max())
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=Y_STEPS * step)
