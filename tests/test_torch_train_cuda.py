"""The training path on the card against the same port on the CPU.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances are the CPU parity tests' (``test_torch_train_loss``): one
train step of the reduced qwen3-1.7b gives the loss within 2e-3, every
gradient within 5e-2 relative L2 and 0.995 cosine, every updated parameter
within 2.5 x lr (the MoE family's step, with its router choices compared,
is ``chip_smoke.py``'s ``train`` ``reference`` run).
An EntroLLM-compressed checkpoint restores on the card through the decode
kernels bitwise the CPU restore.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                 Checkpointer,
                                                 flatten_with_path,
                                                 unflatten_like)
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.models import api
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop

CPU = torch.device("cpu")
LOSS_ATOL, REL_L2, COS = 2e-3, 5e-2, 0.995
SCHED = dict(base_lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tc(**kw):
    return train_loop.TrainConfig(opt=opt.AdamWConfig(
        schedule=opt.Schedule(**SCHED)), **kw)


def _one_step(cfg, host, batch, device, remat):
    params = {k: v.to(device) for k, v in host.items()}
    tc = _tc(remat=remat)
    loss, grads = train_loop.make_grad_fn(cfg, tc)(
        params, train_loop.to_device(batch, device))
    new, state, m = opt.apply_updates(tc.opt, params, grads,
                                      opt.init_state(tc.opt, params))
    return float(loss), grads, new, float(m["lr"])


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_train_step_card_vs_cpu(card, remat):
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    host = api.build(cfg).init(cfg, 1, CPU)
    batch = SyntheticSource(DataConfig(vocab=cfg.vocab, seq_len=17,
                                       global_batch=4, seed=1)).batch(0)
    lc, gc, nc, lr = _one_step(cfg, host, batch, card, remat)
    lp, gp, np_, _ = _one_step(cfg, host, batch, CPU, remat)
    assert abs(lc - lp) <= LOSS_ATOL
    for n in gp:
        a, b = gc[n].double().cpu(), gp[n].double()
        assert gc[n].device.type == "cuda" and gc[n].dtype == gp[n].dtype
        rel = float((a - b).norm() / b.norm())
        cos = float((a * b).sum() / (a.norm() * b.norm()))
        assert rel <= REL_L2 and cos >= COS, (n, rel, cos)
        assert float((nc[n].float().cpu() - np_[n].float()).abs().max()) \
            <= 2.5 * lr, n


@pytest.mark.cuda
def test_entro_restore_on_the_card_is_the_cpu_restore(card, tmp_path):
    from repro_torch.kernels import build
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    params = api.build(cfg).init(cfg, 0, card)
    tc = _tc()
    state = opt.init_state(tc.opt, params)
    src = SyntheticSource(DataConfig(vocab=cfg.vocab, seq_len=33,
                                     global_batch=4))
    params, state, _ = train_loop.train(cfg, tc, params, state, iter(src), 2)
    ck = Checkpointer(CheckpointConfig(
        root=str(tmp_path), compress="entro",
        entro_spec="*norm*:fp32; */0/*:bits=8,codec=huffman; "
                   "*/1/*:bits=8,codec=rans"))
    ck.save(2, (params, state))
    for k in build.launches:
        build.launches[k] = 0
    _, got = ck.restore(like=(params, state), device=card)
    torch.cuda.synchronize()
    assert build.launches["huffman_decode"] > 0
    assert build.launches["ans_decode"] > 0
    _, want = ck.restore(like=(params, state), device=CPU)
    for (path, a), (_, b) in zip(flatten_with_path(got),
                                 flatten_with_path(want)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b), path


@pytest.mark.cuda
def test_sqrt_on_the_card_is_correctly_rounded(card):
    """The optimizer takes the card's float32 sqrt as it is (and goes
    through float64 on the CPU): it must be correctly rounded."""
    x = np.random.default_rng(5).random(10 ** 6).astype(np.float32) * 1e-8
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = opt._sqrt(torch.from_numpy(x).to(card)).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_apply_updates_card_vs_cpu(card, q8):
    """Three steps, each from the same inputs on both devices (the CPU's
    state of the step before, copied to the card): elementwise float32 on
    the two devices may differ in the last bit (``pow``, ``cos``), which
    can move a bf16 parameter one step and a Q8 symbol by one."""
    rng = np.random.default_rng(0)
    shapes = {"layers/wq": (4, 128, 256), "final_norm": (128,),
              "embed": (512, 128)}
    p = {k: torch.from_numpy(rng.normal(0, .02, s).astype(np.float32))
         .to(torch.bfloat16 if len(s) > 1 else torch.float32)
         for k, s in shapes.items()}
    cfg = opt.AdamWConfig(schedule=opt.Schedule(**SCHED), quantized_state=q8)
    s = opt.init_state(cfg, p)
    for step in range(3):
        g = {k: torch.from_numpy(np.random.default_rng(step).normal(
            0, 1e-4, v.shape).astype(np.float32)).to(v.dtype)
             for k, v in p.items()}
        moved = [unflatten_like(tree, iter([x.to(card) for _, x in
                                            flatten_with_path(tree)]))
                 for tree in (p, g, s)]
        got = opt.apply_updates(cfg, *moved)[:2]
        p, s, _ = opt.apply_updates(cfg, p, g, s)
        for (path, a), (_, b) in zip(flatten_with_path(got),
                                     flatten_with_path((p, s))):
            assert a.device.type == card.type, path
            a = a.cpu()
            if a.dtype == torch.uint8:
                assert int((a.int() - b.int()).abs().max()) <= 1, path
            elif a.dtype == torch.bfloat16:
                assert torch.allclose(a.float(), b.float(), rtol=2 ** -7,
                                      atol=0), path
            else:
                assert torch.allclose(a, b, rtol=1e-5, atol=1e-9), path
