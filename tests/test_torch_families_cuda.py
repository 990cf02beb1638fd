"""The ssm, hybrid and encdec families on the card against the same port on
the CPU, and the chunked SSD scan on the card against its own recurrence.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_families_cuda.py

Tolerances.  ``ssd_chunked`` against a loop of ``ssd_step``, float32: the
JAX package's own ``SSD_ATOL`` = 5e-5 at its test shapes
(``tests/test_models_math.py``), and at mamba2-370m's head shapes (H 32,
P 64, N 128, 600 positions) ``FULL_TOL``, |diff| <= 5e-4 + 1e-5 |want|
(outputs reach |y| ~ 35 there; a CPU run gives 5.1e-5).  The card and the
CPU sum the float32 products in other orders, so the scan's outputs are
held to ``FULL_TOL`` between them, and the conv (K shifted float32 adds,
then bf16) to one bf16 step.  Whole reduced models: prefill and decode
logits within ``REF_ATOL`` = 5e-2 (a few bf16 steps of cuBLAS against the
CPU); the hybrid's router runs at ``capacity_factor`` 8.0, and a row whose
router choice differs (a near-tie of two bf16 steps, asserted as
``tests/test_torch_moe_cuda.py`` does) is not compared.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import api, mamba2
from test_torch_moe_cuda import _routes, routing_flips

SSD_ATOL = 5e-5
FULL_TOL = dict(atol=5e-4, rtol=1e-5)
REF_ATOL = 5e-2
CPU = torch.device("cpu")
ARCHS = ("mamba2-370m", "jamba-1.5-large-398b", "seamless-m4t-medium")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (f(rng.normal(size=(B, S, H, P))),
            f(rng.uniform(0.01, 0.2, size=(B, S, H))),
            f(-rng.uniform(0.5, 4.0, size=(H,))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(rng.normal(size=(B, H, P, N))))


def _stepwise(x, dt, A, Bm, Cm, h):
    ys = []
    for t in range(x.shape[1]):
        y, h = mamba2.ssd_step(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        ys.append(y)
    return torch.stack(ys, 1), h


def _within(got, want, atol, rtol=0.0):
    got, want = got.float().cpu(), want.float().cpu()
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk,shape", [
    (64, 16, (2, 3, 8, 16)), (96, 32, (2, 3, 8, 16)), (50, 32, (2, 3, 8, 16)),
    (600, 256, (2, 32, 64, 128))])
def test_ssd_chunked_on_card_matches_stepwise(card, S, chunk, shape):
    """The port's chunked scan ≡ its O(1) recurrence, on the card, with an
    initial state; with TF32 asked for by the caller, which the scan must
    not take."""
    B, H, P, N = shape
    args = [t.to(card) for t in _ssd_inputs(B, S, H, P, N, S)]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y, h = mamba2.ssd_chunked(*args[:5], chunk=chunk, h0=args[5])
        ys, hs = _stepwise(*args)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tol = FULL_TOL if N > 16 else dict(atol=SSD_ATOL)
    _within(y, ys, **tol)
    _within(h, hs, **tol)


@pytest.mark.cuda
def test_ssd_chunked_on_card_equals_cpu(card):
    args = _ssd_inputs(1, 600, 32, 64, 128, 7)
    y, h = mamba2.ssd_chunked(*[t.to(card) for t in args[:5]], chunk=256,
                              h0=args[5].to(card))
    yc, hc = mamba2.ssd_chunked(*args[:5], chunk=256, h0=args[5])
    _within(y, yc, **FULL_TOL)
    _within(h, hc, **FULL_TOL)


@pytest.mark.cuda
def test_causal_conv_streams_on_card(card):
    """The conv over a whole sequence equals the conv over its pieces with
    the state carried, on the card, and the CPU's within a bf16 step."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 20, 48)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.3, size=(4, 48)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, size=(48,)).astype(np.float32))
    xc, wc, bc = x.to(card), w.to(card), b.to(card)
    y, st = mamba2._causal_conv(xc, wc, bc)
    y1, s1 = mamba2._causal_conv(xc[:, :13], wc, bc)
    y2, s2 = mamba2._causal_conv(xc[:, 13:], wc, bc, state=s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, st)
    assert torch.equal(st, xc[:, -3:])
    ycpu, _ = mamba2._causal_conv(x, w, b)
    step = 2.0 ** (math.frexp(float(ycpu.float().abs().max()))[1] - 8)
    _within(y, ycpu, atol=step)


def _cfg(arch):
    cfg = registry.reduced(registry.get(arch))
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def _batch(cfg, B, S, dev, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)
    if cfg.family != "encdec":
        return toks
    return {"tokens": toks, "src_embeds": torch.from_numpy(rng.normal(
        size=(B, 12, cfg.d_model)).astype(np.float32)).bfloat16().to(dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_family_on_card_equals_cpu(card, arch):
    """Prefill and two decode steps of the reduced model, card against CPU,
    from the same seeded weights."""
    cfg = _cfg(arch)
    mod = api.build(cfg)
    params = mod.init(cfg, 0, CPU)
    B, S = 2, 40
    out = []
    for dev in (card, CPU):
        p = {k: v.to(dev) for k, v in params.items()}
        batch = _batch(cfg, B, S, dev)
        toks = batch["tokens"] if isinstance(batch, dict) else batch
        logits = []
        with torch.inference_mode(), _routes() as routes:
            lg, cache = mod.prefill(cfg, p, batch, max_len=S + 2)
            logits.append(lg)
            for i in range(2):
                tok = toks[:, i:i + 1]
                lg, cache = mod.decode_step(cfg, p, tok, cache, S + i)
                logits.append(lg)
        assert all(lg.device.type == dev.type for lg in logits)
        out.append((routes, [lg.float().cpu() for lg in logits]))
    skip = {r for r, _ in routing_flips(out[0][0], out[1][0])}
    keep = [r for r in range(B) if r not in skip]
    assert keep, "every row's router choices differ"
    for a, b in zip(out[0][1], out[1][1]):
        assert bool(torch.isfinite(a).all())
        _within(a[keep], b[keep], atol=REF_ATOL)
