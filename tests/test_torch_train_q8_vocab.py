"""ROADMAP queue 3: the JAX package's EntroLLM-quantized AdamW moments at
qwen3's published vocabulary (151,936; reduced widths otherwise), on the
CPU, against the port's.  Its own criterion (Q8 within 0.15 of f32
moments, ``tests/test_integration.py:39``) holds at the reduced
vocabulary of 512 (``test_torch_train_loop``) and fails here, in both
packages."""
import jax  # noqa: F401  (the reference trains through it)
import numpy as np

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticSource as JSource
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

from test_torch_train_loop import TRAJ_ATOL, _setup, _tc
from test_torch_train_loss import few_threads  # noqa: F401


def test_reference_q8_moments_rise_at_the_published_vocabulary():
    """ROADMAP queue 3: at qwen3's published vocabulary (151,936) the Q8
    moments' per-row grid over ``lm_head``'s vocabulary axis rounds most
    of sqrt(v) to 0 while m keeps a residue, so ``m / (sqrt(v) + eps)``
    blows up: the reference's loss rises above its first value (its own
    0.15 criterion fails there), and the port's trajectory follows it."""
    jcfg, tcfg, jp, tp = _setup(vocab=151936)
    src = DataConfig(vocab=jcfg.vocab, seq_len=17, global_batch=4, seed=0)
    jtc = _tc(jloop, steps=20, q8=True)
    _, _, jinfo = jloop.train(jcfg, jtc, jp, jopt.init_state(jtc.opt, jp),
                              iter(JSource(JDataConfig(**vars(src)))), 5)
    tc = _tc(tloop, steps=20, q8=True)
    _, _, info = tloop.train(tcfg, tc, tp, topt.init_state(tc.opt, tp),
                             iter(SyntheticSource(src)), 5)
    want = [h["loss"] for h in jinfo["history"]]
    got = [h["loss"] for h in info["history"]]
    # the first two steps agree; from the third the blow-up amplifies the
    # packages' last-bit differences, and both rise
    np.testing.assert_allclose(got[:2], want[:2], rtol=0, atol=TRAJ_ATOL)
    assert want[-1] > want[0] + 0.2 and got[-1] > got[0] + 0.2, (got, want)


