"""The production dry-run held against the card (``dryrun.run_on_device``):
qwen3-1.7b whole, one data rank's share of a 16 x 16 cell with ``model``
at 1 — ``prefill_32k`` at one row (query blocks of 1,024) and
``decode_32k`` at 8 rows over a 32,768-row cache — dry-run on ``meta``,
then run on the card with random arguments of the same shapes.  The
predicted peak must be within ``PEAK_RTOL`` of the bytes the card's
allocator held at its peak, and the logits finite.  Then the train step on
a 1 x 2 mesh of ranks sharing the card (gloo) against the card's single
device, reduced qwen3.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_production_cuda.py
"""
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api

PEAK_RTOL = 0.15
CELLS = [("prefill_32k", 1), ("decode_32k", 8)]
RTOL = 2e-3
UPDATE_RTOL = 0.1

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape,batch", CELLS, ids=[c[0] for c in CELLS])
def test_predicted_peak_matches_the_card(card, shape, batch):
    torch.cuda.empty_cache()
    d = dryrun.run_on_device("qwen3-1.7b", shape, device=card, batch=batch)
    pred = d["memory_analysis"]["peak"]
    got = d["measured_peak"]
    assert abs(pred - got) <= PEAK_RTOL * got, (pred, got)
    assert d["logits_finite"]
    assert d["logits_shape"] == (batch, 1, registry.get(
        "qwen3-1.7b").padded_vocab())
    if shape == "prefill_32k":
        assert d["meta"]["q_block"] == 1024


def test_train_step_on_a_mesh_of_ranks_sharing_the_card(card):
    cfg = cases.narrow(registry, "qwen3-1.7b")
    params = api.build(cfg).init(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32))}
        for _ in range(2)]
    run = dict(mb=1, q8=False)
    on_card = {n: p.to(card) for n, p in params.items()}
    card_batches = [{k: v.to(card) for k, v in b.items()} for b in batches]
    want_loss, want_norm, want, _ = cases.train_steps(cfg, on_card,
                                                      card_batches, run)
    world = tmesh.spawn(cases.train_world, 1, 2, backend="gloo",
                        device="cuda", timeout_s=300,
                        args=(cfg, params, batches, [run]))
    for (loss, norm, got, _), in world:
        np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
        np.testing.assert_allclose(norm, want_norm, rtol=RTOL)
        for n in want:
            init = params[n].float().numpy()
            rel = np.linalg.norm(got[n] - want[n]) \
                / np.linalg.norm(want[n] - init)
            assert rel <= UPDATE_RTOL, (n, rel)
