"""Training parity, losses and gradients: the port's ``loss_fn`` of the
dense, ssm and encdec families against the JAX package's on the CPU, the
straight-through dequant, remat, and a train step of every reduced arch.

The JAX package initialises the weights; they cross to the port as numpy
arrays (``convert.params_from_numpy``).  The batch is 2 x 9 seeded tokens
(8 predicted), and the encdec family's source is 2 x 8 bf16 frames.

Tolerances.
- ``loss_fn`` within ``LOSS_ATOL`` = 2e-3 of the reference's: the
  attention scores and the CPU library's float32 sums are not bitwise
  between the packages (ROADMAP queue 3 item 1), and a loss near ln(512)
  ends within ~2e-4 of the reference's.
- Every gradient within ``GRAD_REL_L2`` = 5e-2 relative L2 and
  ``GRAD_COS`` = 0.995 cosine of ``jax.value_and_grad(mod.loss_fn)``'s,
  leaf by leaf (the worst leaf is printed).  The bf16 products round the
  backward's intermediates, so a gradient is ~1-2.5e-2 from the
  reference's at these widths.
- Remat on and off give bitwise equal gradients on the CPU: the replay
  runs the same ops on the same inputs; so do the hybrid's nested
  checkpoints (a period's and, inside it, each sub-block's) and the
  period's alone.

The reference runs compiled with ``remat=False``: under ``jax.checkpoint``
its compiled backward replays the MoE router, and the replay can route a
token otherwise than its own forward did (``test_torch_train_loss_routed``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import api as japi
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

LOSS_ATOL = 2e-3
GRAD_REL_L2 = 5e-2
GRAD_COS = 0.995
B, S = 2, 9
FAMILIES = ("qwen3-1.7b", "mamba2-370m", "seamless-m4t-medium")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """One intra-op thread a test process: the suite runs several test
    processes on the host's cores at once, and more threads a process only
    spin against each other and slow the other processes down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(cfg, seed=0, b=B, s=S):
    """Seeded numpy tokens (and bf16-valued source frames for encdec), as
    each package's batch."""
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        src = rng.standard_normal((b, s - 1, cfg.d_model)).astype(np.float32)
        host["src_embeds"] = np.asarray(jnp.asarray(src, jnp.bfloat16),
                                        np.float32)
    jb = {k: jnp.asarray(v, jnp.bfloat16 if k == "src_embeds" else None)
          for k, v in host.items()}
    tb = {k: (torch.from_numpy(v).to(torch.bfloat16) if k == "src_embeds"
              else torch.from_numpy(v)) for k, v in host.items()}
    return host, jb, tb


def build(arch, **replace):
    jcfg = jreg.reduced(jreg.get(arch))
    tcfg = treg.reduced(treg.get(arch))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    return jcfg, tcfg, jp, convert.params_from_numpy(tcfg, host, "cpu")


def port_grads(tcfg, tp, tb, *, remat=False, loss_fn=None):
    leaves = {n: p.detach().requires_grad_(True) for n, p in tp.items()}
    fn = loss_fn or tapi.build(tcfg).loss_fn
    loss = fn(tcfg, leaves, tb, remat=remat)
    names = sorted(leaves)
    return loss, dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))


def assert_grads_close(got, want, skip=()):
    """Every leaf within GRAD_REL_L2 / GRAD_COS; returns the worst."""
    assert set(got) == set(want)
    rows = []
    for n in sorted(want):
        a = got[n].double().numpy()
        b = np.asarray(want[n], np.float64)
        nb = np.linalg.norm(b)
        assert nb > 0, n
        rel = np.linalg.norm(a - b) / nb
        cos = float((a * b).sum() / (np.linalg.norm(a) * nb))
        rows.append((rel, cos, n))
    worst = max(rows)
    print("worst leaf (rel L2, cosine, name):", worst)
    bad = [r for r in rows if r[0] > GRAD_REL_L2 or r[1] < GRAD_COS]
    assert not bad, bad
    return worst


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return build(request.param)


def test_loss_and_grads_match_reference(family):
    jcfg, tcfg, jp, tp = family
    _, jb, tb = make_batch(jcfg)
    jm = japi.build(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(jcfg, p, b, remat=False)))(jp, jb)
    tl, tg = port_grads(tcfg, tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    tl = float(tl.detach())
    assert abs(tl - float(jl)) <= LOSS_ATOL, (tl, float(jl))
    for n, g in tg.items():
        assert g.dtype == tp[n].dtype, n
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("arch", FAMILIES + ("qwen2-moe-a2.7b",
                                             "jamba-1.5-large-398b"))
def test_remat_equals_no_remat_bitwise(arch):
    cfg = treg.reduced(treg.get(arch))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, tb = make_batch(cfg, seed=1)
    l0, g0 = port_grads(cfg, params, tb, remat=False)
    l1, g1 = port_grads(cfg, params, tb, remat=True)
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_hybrid_nested_remat_equals_period_remat_bitwise(monkeypatch):
    """The hybrid checkpoints each sub-block inside the checkpointed period
    (the JAX package's ``remat_inner``): one device's loss and every
    gradient are bitwise those of the period's checkpoint alone, and the
    nesting is in effect (its backward replays the router more often)."""
    from repro_torch.models import hybrid, moe
    cfg = treg.reduced(treg.get("jamba-1.5-large-398b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, tb = make_batch(cfg, seed=1)
    real_route, real_body, calls = moe.route, hybrid._period_body, []

    def route(*args):
        calls.append(1)
        return real_route(*args)
    monkeypatch.setattr(moe, "route", route)
    l1, g1 = port_grads(cfg, params, tb, remat=True)
    nested = len(calls)
    monkeypatch.setattr(hybrid, "_period_body", lambda *a, **k: real_body(
        *a, **dict(k, remat_inner=False)))
    calls.clear()
    l0, g0 = port_grads(cfg, params, tb, remat=True)
    assert nested > len(calls) > 0, (nested, len(calls))
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_q_block_is_refused():
    """Query blocks that do not tile the sequence are refused (blocks that
    do are held to the reference in tests/test_torch_dryrun.py)."""
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, tb = make_batch(cfg)
    with pytest.raises(ValueError, match="q_block 3 does not divide"):
        tapi.build(cfg).loss_fn(cfg, params, tb, q_block=3)


# ------------------------------------------------------------------ the STE

@pytest.mark.parametrize("bits", [8, 4])
def test_ste_forward_is_deq_of_the_symbols_bitwise(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 0.02, (3, 64, 48)).astype(np.float32)
    master = torch.from_numpy(w).to(torch.bfloat16)
    qtg = tloop.ste_quantize_params({"layers/wq": master}, bits)["layers/wq"]
    assert isinstance(qtg, tlayers.QTG) and qtg.master is master
    assert qtg.q.shape[-1] == (48 if bits == 8 else 24)
    sym = tlayers._unpack4(qtg.q) if bits == 4 else qtg.q
    got = tlayers.deq(qtg)
    assert torch.equal(got, tlayers.deq(tlayers.QT(sym, qtg.scale,
                                                   qtg.zero)))
    # the JAX package's straight-through dequant of the same tuple
    want = jlayers.deq(jlayers.QTG(*(jnp.asarray(t.float().numpy()
                                                 if t.dtype == torch.bfloat16
                                                 else t.numpy())
                                     for t in qtg[:3]),
                                   jnp.asarray(w, jnp.bfloat16)))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_ste_backward_sends_the_gradient_to_the_master_only():
    rng = np.random.default_rng(0)
    master = torch.from_numpy(rng.normal(0, 0.02, (64, 96)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    q, scale, zero = tloop.ste_quantize_params({"w_up": master},
                                               8)["w_up"][:3]
    assert q.dtype == torch.uint8 and tuple(scale.shape) == (64, 1)
    scale.requires_grad_(True)
    zero.requires_grad_(True)
    c = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    out = tlayers.deq(tlayers.QTG(q, scale, zero, master), torch.float32)
    gm, gs, gz = torch.autograd.grad((out * c).sum(), [master, scale, zero],
                                     allow_unused=True)
    assert gm.dtype == torch.bfloat16
    assert torch.equal(gm, c.to(torch.bfloat16))
    assert gs is None and gz is None


def test_ste_take_rows_gathers_rows_and_scatters_their_gradient():
    rng = np.random.default_rng(1)
    master = torch.from_numpy(rng.normal(0, 0.02, (64, 64)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    qtg = tloop.ste_quantize_params({"embed": master}, 8)["embed"]
    assert isinstance(qtg, tlayers.QTG)
    idx = torch.tensor([[3, 3, 0], [63, 2, 3]])
    rows = tlayers.take_rows(qtg, idx)
    assert torch.equal(rows, tlayers.deq(qtg)[idx])
    (g,) = torch.autograd.grad(rows.float().sum(), [master])
    counts = torch.bincount(idx.reshape(-1), minlength=64).to(torch.bfloat16)
    assert torch.equal(g, counts[:, None].expand(64, 64))


# --------------------------------------------------- every reduced arch

@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_every_arch_loss_near_ln_vocab_and_a_step_updates(arch):
    """The JAX package's ``test_arch_smoke`` checks (``:25-57``) on the
    port alone: the loss at init is finite and within 1.5 of ln(vocab), and
    one train step leaves finite metrics and changes a parameter."""
    cfg = treg.reduced(treg.get(arch))
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    _, _, tb = make_batch(cfg, seed=1, s=33)
    loss = tapi.build(cfg).loss_fn(cfg, params, tb)
    assert loss.shape == () and math.isfinite(float(loss))
    assert abs(float(loss) - math.log(cfg.vocab)) < 1.5
    tc = tloop.TrainConfig(opt=topt.AdamWConfig(schedule=topt.Schedule(
        base_lr=1e-3, warmup_steps=1, total_steps=10)))
    p2, s2, m = tloop.make_train_step(cfg, tc)(
        params, topt.init_state(tc.opt, params), tb)
    assert math.isfinite(float(m["loss"]))
    assert math.isfinite(float(m["grad_norm"]))
    assert int(s2.step) == 1 and s2.step.dtype == torch.int32
    assert any(not torch.equal(params[k], p2[k]) for k in params)
