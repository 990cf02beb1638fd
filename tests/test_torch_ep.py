"""Expert parallelism and the sharded state helpers of the port on the CPU,
in ``gloo`` worlds (``repro_torch.launch.mesh.spawn``).

* **EP** — ``moe.moe_mlp`` under an ``EPContext``: every rank of the model
  axis runs the dispatch of its ``E / |model|`` experts and the partial
  outputs are summed over the model axis (and the data axes in the
  weight-stationary layout).  At 1x4 and 2x4 (both layouts), capacity
  factor 8.0 (no token drops), the outputs match the port's single device
  and the reference's ``moe_mlp`` under its own ``EPContext`` on the forced
  CPU devices within ``EP_TOL``.  The tolerance: the sum over ranks is a
  float reduction in another order than one device's, and in the
  stationary layout each rank's down projection sums half the hidden dim,
  so an output may move by a few bf16 steps; ``EP_TOL`` is 4 bf16 steps of
  the largest output (``2 ** -6`` of it).
* **reshard restore** — a checkpoint saved once is restored onto a 1x1 and
  a 2x1 world by the train rules' specs: each rank keeps its block of every
  leaf, and the blocks put together are the saved leaves bit for bit.
* **collectives** — the all-gather, sum and pick of the mesh path on a
  2x2 world; ``spawn`` reporting a failed rank and stopping a hung one.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch import mesh as jmesh
from repro.models import moe as jmoe
from repro_torch.launch import mesh as tmesh

import torch_mesh_cases as cases

B, S, D, F, E, K, CF = 4, 6, 64, 32, 16, 2, 8.0
EP_TOL = 2.0 ** -6          # of max |y|: 4 bf16 steps
TIMEOUT_S = 180


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    w = {"router": (0.2 * rng.standard_normal((D, E))).astype(np.float32),
         "w_gate": bf(0.1 * rng.standard_normal((E, D, F))),
         "w_up": bf(0.1 * rng.standard_normal((E, D, F))),
         "w_down": bf(0.1 * rng.standard_normal((E, F, D)))}
    x = bf(rng.standard_normal((B, S, D)))
    return w, x


def _single(w, x):
    import torch
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    wts = {k: torch.from_numpy(v) if k == "router"
           else torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}
    y, aux = moe.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), wts,
                         MoEConfig(num_experts=E, top_k=K,
                                   capacity_factor=CF), E)
    return y.float().numpy(), float(aux)


def _reference(w, x, data, model, batch_sharded):
    m = jmesh.make_serve_mesh(data, model)
    wts = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
           for k, v in w.items()}
    jmoe.set_ep_context(jmoe.EPContext(m, batch_sharded=batch_sharded))
    try:
        y, aux = jmoe.moe_mlp(jnp.asarray(x, jnp.bfloat16), wts,
                              JMoEConfig(num_experts=E, top_k=K,
                                         capacity_factor=CF), E)
    finally:
        jmoe.set_ep_context(None)
    return np.asarray(y, np.float32), float(aux)


def _whole(ranks, data, model, batch_sharded):
    """The ranks' outputs put together: the data groups' row blocks in
    order (every rank of a group holds the same rows)."""
    ys = [ranks[d * model][0] for d in range(data)]
    for d in range(data):
        for m in range(1, model):
            np.testing.assert_array_equal(ranks[d * model + m][0], ys[d])
    return np.concatenate(ys) if batch_sharded else ys[0]


@pytest.mark.parametrize("data,model,layouts", [
    (1, 4, (True,)),
    (2, 4, (True, False)),
])
def test_ep_matches_single_device_and_reference(problem, data, model,
                                                 layouts):
    w, x = problem
    got = tmesh.spawn(cases.ep_worlds, data, model, backend="gloo",
                      device="cpu", timeout_s=TIMEOUT_S,
                      args=(w, x, K, CF, layouts))
    want, aux = _single(w, x)
    tol = EP_TOL * float(np.abs(want).max())
    for i, bs in enumerate(layouts):
        ranks = [g[i] for g in got]
        y = _whole(ranks, data, model, bs)
        assert y.shape == (B, S, D)
        err = float(np.abs(y - want).max())
        assert err <= tol, (bs, err, tol)
        ref, ref_aux = _reference(w, x, data, model, bs)
        err_ref = float(np.abs(y - ref).max())
        assert err_ref <= tol, (bs, err_ref, tol)
        # the router and its aux are replicated math: the local batch's
        # aux where the batch is sharded, the whole one's elsewhere
        if not bs or data == 1:
            assert abs(ranks[0][1] - aux) <= 1e-6 * max(1.0, abs(aux))
        # EP is exact where no partial sums meet: with top-2 over
        # experts on different ranks the sum adds one value to zeros
        assert np.isfinite(y).all()


def test_ep_weight_specs():
    from repro_torch.models import moe
    ctx = moe.EPContext(mesh=None, batch_sharded=True)
    assert moe.ep_weight_specs(ctx) == {
        "w_gate": ("model", None, None), "w_up": ("model", None, None),
        "w_down": ("model", None, None)}
    ctx = moe.EPContext(mesh=None, batch_sharded=False)
    assert moe.ep_weight_specs(ctx)["w_down"] == ("model", ("data",), None)


# ------------------------------------------------------------ reshard restore

@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    import torch
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    root = str(tmp_path_factory.mktemp("ckpt"))
    g = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn(16, 8, generator=g).to(torch.bfloat16),
            "layers/wq": torch.randn(2, 8, 12, generator=g),
            "norm": torch.randn(8, generator=g)}
    Checkpointer(CheckpointConfig(root=root)).save(3, tree, blocking=True)
    return root, tree


@pytest.mark.parametrize("data", [1, 2])
def test_reshard_restore_across_worlds(saved, data):
    import torch
    from repro_torch.distributed import sharding as shd
    root, tree = saved
    axes = {"embed": ("vocab", "embed"), "layers/wq": ("layers", "embed",
                                                       "heads"),
            "norm": (None,)}

    class M:
        shape = {"data": data, "model": 1}
    rules = shd.train_rules(M)
    specs = {k: shd.resolve_spec(axes[k], tuple(v.shape), rules, M)
             for k, v in tree.items()}
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    got = tmesh.spawn(cases.restore_world, data, 1, backend="gloo",
                      device="cpu", timeout_s=TIMEOUT_S,
                      args=(root, like, specs))
    names = sorted(tree)
    for step, coord, leaves in got:
        assert step == 3
        assert [n for n, _, _ in leaves] == names
    for i, n in enumerate(names):
        spec = specs[n].padded(tree[n].dim())
        full = tree[n].float().numpy()
        blocks = [leaves[i][1] for _, _, leaves in got]
        if all(e is None for e in spec):
            for b in blocks:
                np.testing.assert_array_equal(b, full)
            continue
        # the model axis has one rank: only the data entry splits
        (d,) = [j for j, e in enumerate(spec) if e == "data"]
        assert [leaves[i][2] for _, _, leaves in got] == [spec] * data
        np.testing.assert_array_equal(np.concatenate(blocks, axis=d), full)


# ------------------------------------------------------------- collectives

def test_collectives_on_a_2x2_world():
    got = tmesh.spawn(cases.collectives_world, 2, 2, backend="gloo",
                      device="cpu", timeout_s=TIMEOUT_S)
    for rank, (g, s, p, counts) in enumerate(got):
        d, m = divmod(rank, 2)
        # every rank's (2, 3) block, rank-major
        np.testing.assert_array_equal(
            g, np.repeat(np.arange(4, dtype=np.float32), 2)[:, None]
            * np.ones((1, 3), np.float32))
        np.testing.assert_array_equal(s, np.full((2, 3), 2 * d * 2 + 1.0))
        assert p == m           # rank (0, m) holds rank number m
        assert counts["all_gather"] == 3 and counts["all_reduce"] == 1


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1:"):
        tmesh.spawn(cases.fail_on_rank, 1, 2, backend="gloo", device="cpu",
                    timeout_s=TIMEOUT_S, args=(1,))


def test_spawn_stops_a_hung_world():
    with pytest.raises(RuntimeError, match="no result"):
        tmesh.spawn(cases.hang_on_rank, 1, 2, backend="gloo", device="cpu",
                    timeout_s=8, args=(0,))
