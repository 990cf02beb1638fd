"""The train step on a mesh (``train_loop.make_train_step(..., mesh=)``)
against the single-device port: one 2 x 2 gloo world (a process a rank)
trains reduced qwen3 two steps from the same weights and batches, with
float32 moments and two microbatches, then with EntroLLM-quantized moments.

Each rank holds its ZeRO blocks of the params and moments and its rows of
the batch; weights are gathered at use, their gradients summed over data.
The sums over data are float sums in another order than one device's, so
the comparison holds to tolerances:

* the loss and the gradient norm of each step within ``RTOL`` relative;
* float32 moments: each parameter's update (after minus before) within
  ``UPDATE_RTOL`` of one device's, in L2.  Adam moves an element whose
  gradient is within rounding of zero by about the learning rate either
  way, so a few elements differ by that much (measured: at most 0.062, in
  ``final_norm``).  The control: a step that lost the other data rank's
  rows differs by 1.03;
* quantized moments: each row's scale of ``m`` and ``sqrt(v)`` within
  ``SCALE_RTOL`` of one device's.  A row split over model ranks takes its
  range over the whole row, so the scales follow; a block's own range
  would be the row's only where that block holds its largest value.  The
  parameters are not compared: an element whose ``sqrt(v)`` rounds to
  symbol 0 takes a step of ``m / eps`` (the quantized moments' divergence,
  the same on one device), and which elements do depends on rounding.
"""
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi

RTOL = 2e-3
UPDATE_RTOL = 0.1
SCALE_RTOL = 2e-2
RUNS = [dict(mb=2, q8=False), dict(mb=1, q8=True)]
B, S, STEPS = 4, 16, 2
WORLD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def setup():
    cfg = cases.narrow(treg, "qwen3-1.7b")
    params = tapi.build(cfg).init(cfg, 0, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32))}
        for _ in range(STEPS)]
    return cfg, params, batches


@pytest.fixture(scope="module")
def world(setup):
    cfg, params, batches = setup
    return tmesh.spawn(cases.train_world, 2, 2, backend="gloo", device="cpu",
                       timeout_s=WORLD_TIMEOUT_S,
                       args=(cfg, params, batches, RUNS))


@pytest.fixture(scope="module")
def single(setup):
    cfg, params, batches = setup
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return [cases.train_steps(cfg, params, batches, run) for run in RUNS]
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("run", range(len(RUNS)),
                         ids=[f"mb{r['mb']}-q8{int(r['q8'])}" for r in RUNS])
def test_loss_and_grad_norm_match_one_device(world, single, run):
    want_loss, want_norm = single[run][:2]
    for rank in world:
        loss, norm = rank[run][:2]
        np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
        np.testing.assert_allclose(norm, want_norm, rtol=RTOL)


def test_f32_updates_match_one_device(setup, world, single):
    _, params, _ = setup
    want = single[0][2]
    for rank in world:
        got = rank[0][2]
        for n in want:
            init = params[n].float().numpy()
            rel = np.linalg.norm(got[n] - want[n]) \
                / np.linalg.norm(want[n] - init)
            assert rel <= UPDATE_RTOL, (n, rel)


def test_q8_row_scales_match_one_device(world, single):
    want = single[1][3]
    assert want, "no quantized moment at this size"
    for rank in world:
        got = rank[1][3]
        assert sorted(got) == sorted(want)
        for n in want:
            for g, w in zip(got[n], want[n]):
                np.testing.assert_allclose(g, w, rtol=SCALE_RTOL,
                                           err_msg=n)


def test_every_rank_holds_the_same_params(world):
    for run in range(len(RUNS)):
        first = world[0][run][2]
        for rank in world[1:]:
            for n, v in rank[run][2].items():
                assert np.array_equal(v, first[n]), (run, n)
