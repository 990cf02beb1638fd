"""Multi-device serving on the card: ranks sharing one card over ``gloo``.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

The machine has one card, and NCCL refuses two ranks on one device, so the
ranks of these worlds share ``cuda:0`` over ``gloo``, which takes card
tensors for every collective of the path.  A reduced qwen3-1.7b cut to 2
layers, its container written by the port:

* 2 ranks (1x2: the weights split over the model axis, gathered at use,
  and the 2 KV heads, one a rank) and 2 ranks (2x1: the batch rows split
  over data) give greedy tokens bitwise the card's single engine, each
  rank holding half the lockstep cache;
* the collectives of the path, on card tensors, move the same values as
  on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.quant import Granularity
from repro_torch.core.store import CompressedModel
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api

import torch_mesh_cases as cases

B, PROMPT, GEN, MAX_LEN = 4, 8, 10, 24
TIMEOUT_S = 300

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def container(card, tmp_path_factory):
    cfg = cases.narrow(registry, "qwen3-1.7b")
    params = api.build(cfg).init(cfg, 0, "cpu")
    host = {k: v.float().numpy() for k, v in params.items()}
    cm = CompressedModel.compress(host, bits=8,
                                  granularity=Granularity.PER_CHANNEL)
    path = str(tmp_path_factory.mktemp("mesh") / "model.npz")
    cm.save(path)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (B, PROMPT))
    single, _ = cases.lockstep_tokens(cfg, path, prompt, GEN, MAX_LEN, card)
    return cfg, path, prompt, single


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_lockstep_tokens_bitwise_the_single_engine(container, data, model):
    cfg, path, prompt, single = container
    got = tmesh.spawn(cases.serve_world, data, model, backend="gloo",
                      device="cuda", timeout_s=TIMEOUT_S,
                      args=(cfg, path, prompt, GEN, MAX_LEN))
    full = 2 * 2 * cfg.n_layers * B * MAX_LEN * cfg.n_kv_heads * cfg.hd
    for r in got:
        np.testing.assert_array_equal(r["tokens"], single)
        assert r["cache_bytes"] * 2 == full
    bytes_ = got[0]["weight_bytes"]
    assert len(bytes_) == 2
    if model == 2:       # the output channels split: less than one copy
        assert max(bytes_.values()) < sum(bytes_.values())


def test_collectives_on_card_tensors(card):
    got = tmesh.spawn(cases.collectives_world, 2, 2, backend="gloo",
                      device="cuda", timeout_s=TIMEOUT_S)
    for rank, (g, s, p, counts) in enumerate(got):
        d, m = divmod(rank, 2)
        np.testing.assert_array_equal(
            g, np.repeat(np.arange(4, dtype=np.float32), 2)[:, None]
            * np.ones((1, 3), np.float32))
        np.testing.assert_array_equal(s, np.full((2, 3), 4.0 * d + 1))
        assert p == m
        assert counts["all_gather"] == 3 and counts["all_reduce"] == 1
