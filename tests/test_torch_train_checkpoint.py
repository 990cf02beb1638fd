"""The port's checkpointer (``checkpoint/checkpointer.py``) and fault
tolerance (``distributed/fault_tolerance.py``) against the JAX package's,
on the CPU.

The format is the hand-off seam: from the same leaves, both packages write
plain and EntroLLM-compressed checkpoints whose npz members are equal
(keys, dtypes, shapes and bytes) and whose manifests are equal except
``treedef`` (each package's own structure string) and ``time``; each
package restores the other's and trains on.  The tree is the train loop's
``(params, OptState(step, m, v))`` of the reduced qwen3-1.7b, with f32 and
Q8 moments.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jck
from repro.configs import registry as jreg
from repro.distributed import fault_tolerance as jft
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro.training import train_loop as jloop
from repro_torch import convert
from repro_torch.checkpoint import checkpointer as tck
from repro_torch.configs import registry as treg
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop
from test_torch_train_loss import few_threads  # noqa: F401

CPU = torch.device("cpu")
STEP = 7
SPEC = "*norm*:fp32; */0/*:bits=8,codec=huffman; */1/*:bits=8,codec=rans"


def _trees(q8):
    """The same (params, OptState) in each package: reduced qwen3 weights
    and seeded moments (Q8 symbols, scales and zeros where ``_use_q8``)."""
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, CPU)
    rng = np.random.default_rng(3)
    jm, tm = {}, {}
    for half in ("m", "v"):
        jd, td = {}, {}
        for n in sorted(host):
            shape = host[n].shape
            if q8 and topt._use_q8(shape):
                s1 = tuple(shape[:-1]) + (1,)
                parts = (rng.integers(0, 256, shape).astype(np.uint8),
                         rng.random(s1).astype(np.float32) * 1e-3,
                         rng.normal(0, 1e-3, s1).astype(np.float32))
                jd[n] = jopt.Q8Moment(*(jnp.asarray(x) for x in parts))
                td[n] = topt.Q8Moment(*(torch.from_numpy(x) for x in parts))
            else:
                x = rng.normal(0, 1e-3, shape).astype(np.float32)
                jd[n], td[n] = jnp.asarray(x), torch.from_numpy(x)
        jm[half], tm[half] = jd, td
    jtree = (jp, jopt.OptState(jnp.int32(STEP), jm["m"], jm["v"]))
    ttree = (tp, topt.OptState(torch.tensor(STEP, dtype=torch.int32),
                               tm["m"], tm["v"]))
    return jcfg, tcfg, jtree, ttree


def _members(path):
    z = np.load(path)
    return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        m = json.load(f)
    m.pop("time")
    m.pop("treedef")
    return m


def _assert_same_tree(jtree, ttree):
    jl = [np.asarray(jnp.asarray(x).astype(jnp.float32))
          for x in jax.tree.leaves(jtree)]
    tl = [x for _, x in tck.flatten_with_path(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.device == CPU
        np.testing.assert_array_equal(a, b.float().numpy())


def test_flatten_order_and_paths_are_jax_s():
    _, _, jtree, ttree = _trees(q8=True)
    pairs, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = [jck._path_str(p) for p, _ in pairs]
    got = ["/".join(p) for p, _ in tck.flatten_with_path(ttree)]
    assert got == want
    assert "1/m/embed/q" in got and got[0] == "0/embed"


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_plain_checkpoints_equal_member_by_member(tmp_path, q8):
    _, _, jtree, ttree = _trees(q8)
    jc = jck.Checkpointer(jck.CheckpointConfig(root=str(tmp_path / "j")))
    tc = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path / "t")))
    jc.save(STEP, jtree)
    tc.save(STEP, ttree)
    name = f"step_{STEP:09d}"
    a, b = tmp_path / "j" / name, tmp_path / "t" / name
    assert _members(a / "shard_00000.npz") == _members(b /
                                                        "shard_00000.npz")
    assert _manifest(a) == _manifest(b)
    assert "bfloat16" in _manifest(b)["dtypes"]
    assert os.path.exists(str(b) + ".COMMIT")


@pytest.mark.parametrize("spec", [None, SPEC], ids=["bits8", "spec"])
def test_entro_checkpoints_equal_member_by_member(tmp_path, spec):
    _, _, jtree, ttree = _trees(q8=True)
    kw = dict(compress="entro", entro_spec=spec)
    jck.Checkpointer(jck.CheckpointConfig(root=str(tmp_path / "j"), **kw)
                     ).save(STEP, jtree)
    tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path / "t"), **kw)
                     ).save(STEP, ttree)
    name = f"step_{STEP:09d}"
    a, b = tmp_path / "j" / name, tmp_path / "t" / name
    for f in ("shard_00000_entro.npz", "shard_00000_raw.npz"):
        assert _members(a / f) == _members(b / f), f
    assert _manifest(a) == _manifest(b)


@pytest.mark.parametrize("compress", [None, "entro"])
def test_each_package_restores_the_others_and_trains_on(tmp_path, compress):
    jcfg, tcfg, jtree, ttree = _trees(q8=True)
    cfg = dict(compress=compress)
    jck.Checkpointer(jck.CheckpointConfig(root=str(tmp_path / "j"), **cfg)
                     ).save(STEP, jtree)
    tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path / "t"), **cfg)
                     ).save(STEP, ttree)
    # the port restores the reference's, the reference the port's
    step, got = tck.Checkpointer(tck.CheckpointConfig(
        root=str(tmp_path / "j"))).restore(like=ttree, device=CPU)
    jstep, jgot = jck.Checkpointer(jck.CheckpointConfig(
        root=str(tmp_path / "t"))).restore(like=jtree)
    assert step == jstep == STEP
    if compress is None:
        _assert_same_tree(jtree, got)
        _assert_same_tree(jgot, ttree)
    else:
        # lossy leaves: each package's restore of the other's checkpoint
        # equals its restore of its own
        _, own = tck.Checkpointer(tck.CheckpointConfig(
            root=str(tmp_path / "t"))).restore(like=ttree, device=CPU)
        for (_, a), (_, b) in zip(tck.flatten_with_path(got),
                                  tck.flatten_with_path(own)):
            assert torch.equal(a, b)
        _assert_same_tree(jgot, own)
    assert isinstance(got[1], topt.OptState)
    assert isinstance(got[1].m["embed"], topt.Q8Moment)
    assert got[0]["embed"].dtype == torch.bfloat16
    assert got[1].step.dtype == torch.int32
    # and each trains on from the other's state
    batch = SyntheticSource(DataConfig(vocab=tcfg.vocab, seq_len=17,
                                       global_batch=2)).batch(STEP)
    ttc = tloop.TrainConfig(opt=topt.AdamWConfig(quantized_state=True))
    _, s2, m = tloop.make_train_step(tcfg, ttc)(
        *got, tloop.to_device(batch, CPU))
    assert int(s2.step) == STEP + 1 and np.isfinite(float(m["loss"]))
    if compress is None:
        jtc = jloop.TrainConfig(opt=jopt.AdamWConfig(quantized_state=True))
        _, js2, jm = jax.jit(jloop.make_train_step(jcfg, jtc))(
            *jgot, {"tokens": jnp.asarray(batch["tokens"])})
        assert int(js2.step) == STEP + 1 and np.isfinite(float(jm["loss"]))
        assert abs(float(jm["loss"]) - float(m["loss"])) < 2e-3


def test_restore_needs_a_committed_step(tmp_path):
    _, _, _, ttree = _trees(q8=False)
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        ck.restore(like=ttree, device=CPU)
    ck.save(1, ttree)
    os.remove(str(tmp_path / "step_000000001.COMMIT"))
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        ck.restore(1, like=ttree, device=CPU)


def test_commit_order_and_gc(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path), keep=2))
    os.makedirs(tmp_path / "step_000000099.tmp")        # a crashed save
    os.makedirs(tmp_path / "step_000000098")            # renamed, no marker
    for s in (1, 2, 3):
        ck.save(s, {"w": tree["w"] + s})
    assert sorted(os.listdir(tmp_path)) == [
        "step_000000002", "step_000000002.COMMIT",
        "step_000000003", "step_000000003.COMMIT"]
    assert ck.latest_step() == 3
    _, got = ck.restore(like=tree, device=CPU)
    assert torch.equal(got["w"], tree["w"] + 3)
    _, got = ck.restore(2, like=tree, device=CPU)
    assert torch.equal(got["w"], tree["w"] + 2)


def test_async_save_snapshots_at_the_call(tmp_path):
    w = torch.zeros(4, 4)
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path)))
    ck.save_async(5, {"w": w})
    w += 1                                   # after the snapshot
    ck.wait()
    _, got = ck.restore(like={"w": w}, device=CPU)
    assert torch.equal(got["w"], torch.zeros(4, 4))


def test_async_write_failure_surfaces_on_wait(tmp_path):
    ck = tck.Checkpointer(tck.CheckpointConfig(
        root=str(tmp_path), compress="entro", entro_spec="*:bits=99"))
    ck.save_async(1, {"w": torch.zeros(64, 64)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()


def test_nan_watchdog_rolls_back(tmp_path):
    _, _, _, (params, state) = _trees(q8=False)
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path)))
    ck.save(1, (params, state))
    wd = tft.NanWatchdog(ck, (params, state), device=CPU)
    out = wd(5, params, state, {"loss": float("nan"), "grad_norm": 1.0})
    assert out is not None and wd.rollbacks == [5]
    assert torch.equal(out[0]["embed"], params["embed"])
    assert wd(6, params, state, {"loss": 2.0, "grad_norm": 1.0}) is None
    assert wd(7, params, state, {"loss": 2.0,
                                 "grad_norm": float("inf")}) is not None


def test_checkpoint_hook_saves_every_n_steps(tmp_path):
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path), keep=5))
    hook = tft.CheckpointHook(ck, 2)
    for i in range(5):
        assert hook(i, {"w": torch.full((2,), float(i))}, None, {}) is None
    ck.wait()
    assert sorted(ck.latest_steps()) == [2, 4]


def test_straggler_watchdog_and_rebalance_match_reference():
    times = [0.1] * 10 + [0.5, 0.1, 0.35, 0.1]
    got = tft.StepTimeWatchdog(threshold=2.0)
    want = jft.StepTimeWatchdog(threshold=2.0)
    flags = [(got.observe(i, t), want.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert got.flagged == want.flagged == [10, 12]
    shards = {0: 1.0, 1: 5.0, 2: 1.2, 3: 0.9, 4: 2.2}
    for hosts in (2, 3):
        assert tft.suggest_rebalance(shards, hosts) \
            == jft.suggest_rebalance(shards, hosts)
    assign = tft.suggest_rebalance({0: 1.0, 1: 5.0, 2: 1.2, 3: 0.9}, 2)
    loads = [sum(t for s, t in {0: 1.0, 1: 5.0, 2: 1.2, 3: 0.9}.items()
                 if assign[s] == h) for h in range(2)]
    assert max(loads) <= 5.1
    tick = tft.StepTimeWatchdog()
    assert tick.tick(0) is None and tick.tick(1) is None
    assert len(tick.times) == 1


def test_entro_round_trip_is_within_half_a_step(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(0, 0.02, (64, 512)).astype(
        np.float32))}
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path),
                                               compress="entro"))
    ck.save(1, tree)
    _, out = ck.restore(like=tree, device=CPU)
    err = float((out["w"] - tree["w"]).abs().max())
    assert err < 0.02 * 256 / 255 / 2 + 1e-5


def test_entro_spec_patterns_match_tree_paths(tmp_path):
    from repro_torch.core.store import CompressedModel
    rng = np.random.default_rng(1)
    tree = {"params": {"wq": torch.from_numpy(rng.normal(
        0, 0.02, (64, 256)).astype(np.float32))},
            "opt": {"mu": {"wq": torch.from_numpy(rng.normal(
                0, 0.001, (64, 256)).astype(np.float32))}}}
    ck = tck.Checkpointer(tck.CheckpointConfig(
        root=str(tmp_path), compress="entro",
        entro_spec="*/mu/*:fp32; */params/*:bits=8,codec=rans"))
    ck.save(1, tree)
    cm = CompressedModel.load(str(tmp_path / "step_000000001" /
                                  "shard_00000_entro.npz"))
    assert any("opt/mu/wq" in n for n in cm.unquantized), cm.unquantized
    assert any("params/wq" in n for n in cm.qmeta), list(cm.qmeta)
    _, out = ck.restore(like=tree, device=CPU)
    assert torch.equal(out["opt"]["mu"]["wq"], tree["opt"]["mu"]["wq"])


def test_restart_resumes_bitwise(tmp_path):
    """Kill and restart (``tests/test_integration.py:78``): 3 steps, a
    checkpoint, a restore into fresh trees and 3 more steps give every
    parameter and moment of the uninterrupted 6 steps bitwise."""
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    mod = tapi.build(cfg)
    tc = tloop.TrainConfig(opt=topt.AdamWConfig(
        schedule=topt.Schedule(base_lr=1e-3, warmup_steps=2, total_steps=20),
        quantized_state=True))
    src = SyntheticSource(DataConfig(vocab=cfg.vocab, seq_len=33,
                                     global_batch=4, seed=0))
    step = tloop.make_train_step(cfg, tc)

    def run(p, s, lo, hi):
        for i in range(lo, hi):
            p, s, _ = step(p, s, tloop.to_device(src.batch(i), CPU))
        return p, s

    p0 = mod.init(cfg, 0, CPU)
    want = run(p0, topt.init_state(tc.opt, p0), 0, 6)
    ck = tck.Checkpointer(tck.CheckpointConfig(root=str(tmp_path)))
    p, s = run(p0, topt.init_state(tc.opt, p0), 0, 3)
    ck.save(3, (p, s))
    del p, s
    fresh = mod.init(cfg, 1, CPU)
    start, (p, s) = ck.restore(like=(fresh, topt.init_state(tc.opt, fresh)),
                               device=CPU)
    assert start == 3 and int(s.step) == 3
    got = run(p, s, 3, 6)
    for (path, a), (_, b) in zip(tck.flatten_with_path(got),
                                 tck.flatten_with_path(want)):
        assert torch.equal(a, b), path
