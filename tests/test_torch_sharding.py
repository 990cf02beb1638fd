"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's: the ports of ``tests/test_sharding.py`` on the port's
own spec type, and resolved specs equal to the reference's entry by entry
for every registry config's full schema, every rule profile and five mesh
shapes (the production 16x16 and 2x16x16 among them), for the cache in the
``batch`` and ``slot`` layouts, and for the optimizer state.  Pure: no
process group, no collective."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.models import api as tapi
from repro_torch.training import optimizer as topt


class FakeMesh:
    """Duck-typed mesh exposing .shape only (resolve_spec needs nothing
    else)."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {
    "2x4": dict(data=2, model=4),
    "1x8": dict(data=1, model=8),
    "8x1": dict(data=8, model=1),
    "16x16": dict(data=16, model=16),
    "pod2x16x16": dict(pod=2, data=16, model=16),
}
# the meshes the 8 forced CPU devices can build for the JAX package's own
# NamedSharding-returning helpers
REAL = ("2x4", "1x8", "8x1")
ARCHS = sorted(jreg.ARCHS)


def _norm(spec):
    """A spec's entries, trailing ``None`` trimmed, tuples as tuples."""
    e = [tuple(x) if isinstance(x, (list, tuple)) else x for x in spec]
    while e and e[-1] is None:
        e.pop()
    return tuple(e)


@pytest.fixture(scope="module")
def real_meshes():
    return {k: jmesh.make_mesh(tuple(MESHES[k].values()), tuple(MESHES[k]))
            for k in REAL}


# ------------------------------------------------ ports of test_sharding.py

def test_resolve_basic():
    m = FakeMesh(data=16, model=16)
    rules = shd.Rules({"embed": "data", "heads": "model"})
    spec = shd.resolve_spec(("embed", "heads"), (4096, 8192), rules, m)
    assert spec == P("data", "model")


def test_resolve_divisibility_drops():
    m = FakeMesh(data=16, model=16)
    rules = shd.Rules({"kv": "model"})
    # 2 KV heads cannot shard 16 ways -> replicated
    assert shd.resolve_spec(("kv",), (2,), rules, m) == P()
    assert shd.resolve_spec(("kv",), (32,), rules, m) == P("model")


def test_resolve_tuple_axes_shorten():
    m = FakeMesh(pod=2, data=16, model=16)
    rules = shd.Rules({"batch": ("pod", "data")})
    assert shd.resolve_spec(("batch",), (32,), rules, m) == P(("pod", "data"))
    assert shd.resolve_spec(("batch",), (16,), rules, m) == P("pod")
    assert shd.resolve_spec(("batch",), (3,), rules, m) == P()


def test_resolve_tuple_prefix_rechecked_against_used():
    """A (pod, data) batch rule colliding with an embed rule: the surviving
    prefix is re-checked against the axes other dims claimed, in either dim
    order."""
    m = FakeMesh(pod=2, data=4, model=4)
    rules = shd.Rules({"batch": ("pod", "data"), "embed": "data"})
    assert shd.resolve_spec(("batch", "embed"), (2, 8), rules, m) == \
        P("pod", "data")
    assert shd.resolve_spec(("embed", "batch"), (8, 2), rules, m) == \
        P("data", "pod")
    assert shd.resolve_spec(("embed", "batch"), (8, 8), rules, m) == \
        P("data", "pod")


def test_resolve_duplicate_axis_inside_rule_tuple():
    m = FakeMesh(data=4, model=4)
    rules = shd.Rules({"batch": ("data", "data")})
    assert shd.resolve_spec(("batch",), (16,), rules, m) == P("data")


def test_resolve_no_duplicate_mesh_axes():
    m = FakeMesh(data=4, model=4)
    rules = shd.Rules({"a": "model", "b": "model"})
    spec = shd.resolve_spec(("a", "b"), (8, 8), rules, m)
    assert spec == P("model")


def test_resolve_skips_missing_axes():
    m = FakeMesh(data=4)            # no "model" on this mesh
    rules = shd.Rules({"heads": "model", "embed": "data"})
    assert shd.resolve_spec(("heads", "embed"), (8, 8), rules, m) == \
        P(None, "data")


def test_train_rules_profile():
    rules = shd.train_rules(FakeMesh(data=1, model=1))
    assert rules.lookup("vocab") == ("model",)
    assert rules.lookup("embed") == ("data",)
    assert rules.lookup(None) == ()


def test_param_shardings_cover_every_tensor():
    cfg = treg.reduced(treg.get("glm4-9b"))
    m = FakeMesh(data=1, model=1)
    shards = shd.param_shardings(cfg, m, shd.train_rules(m))
    assert set(shards) == set(tapi.build(cfg).schema(cfg))


def test_serve_builders_construct_for_host_mesh():
    """The serving placements on a 1x1 mesh: params, caches and the batch
    resolve for every name, every leaf of the cache, and shard nothing
    (the 1x1 counterpart of the reference's cell-builder check; the
    lowered cells come with the dry-run)."""
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    m = FakeMesh(data=1, model=1)
    rules = shd.arch_rules(cfg, m, shd.serve_rules(m))
    params = shd.param_shardings(cfg, m, rules)
    assert set(params) == set(tapi.build(cfg).schema(cfg))
    for layout in ("batch", "slot"):
        cache = shd.cache_shardings(cfg, m, rules, 4, 64, layout=layout)
        assert set(cache) == set(tapi.cache_specs(cfg, layout=layout))
        assert all(len(s) <= 5 for s in cache.values())
    # a 1-wide axis divides everything: the spec names it, sharding nothing
    assert shd.batch_sharding(m, rules, (4, 16)) == P("data")


def test_qt_leaf_shardings_consistent():
    """QT triples resolve q along the output-channel axis and scale / zero
    FOLLOW it (same mesh axes where sizes line up, replicated on size-1
    broadcast dims)."""
    from repro_torch.models.layers import QT, QT4
    fm = FakeMesh(data=4, model=4)
    rules = shd.Rules({"vocab": "model", "embed": "data"})
    qt = QT(torch.zeros((64, 32), dtype=torch.uint8),
            torch.zeros((64, 1)), torch.zeros((64, 1)))
    spec = shd.resolve_spec(("vocab", "embed"), (64, 32), rules, fm)
    assert spec == P("model", "data")
    assert shd.follower_spec(spec, (64, 32), (64, 1), fm) == P("model")
    sh = shd.leaf_shardings(("vocab", "embed"), qt, rules, fm)
    assert isinstance(sh, QT)
    assert all(isinstance(s, P) for s in sh)
    assert sh.q == spec and sh.scale == P("model") and sh.zero == P("model")
    # packed QT4: last-dim divisibility is checked at the PACKED size
    qt4 = QT4(torch.zeros((64, 16), dtype=torch.uint8),
              torch.zeros((64, 1)), torch.zeros((64, 1)))
    sh4 = shd.leaf_shardings(("vocab", "embed"), qt4, rules, fm)
    assert isinstance(sh4, QT4)
    assert sh4.q == P("model", "data")


def test_qt_follower_per_group_divisibility():
    fm = FakeMesh(data=4, model=4)
    qspec = P("model", "data")
    assert shd.follower_spec(qspec, (64, 32), (64, 8), fm) == \
        P("model", "data")
    assert shd.follower_spec(qspec, (64, 32), (64, 6), fm) == P("model")


def test_quantized_param_structs_match_schema():
    """Every schema tensor of the reduced qwen3, packed as the loader packs
    it at 8 and 4 bits, resolves to a spec tree of its own structure with
    the q symbols uint8 (QT4 at 4 bits for the big matrices)."""
    from repro_torch.models.layers import QT, QT4, pack_qt
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    m = FakeMesh(data=2, model=2)
    rules = shd.serve_rules(m)
    for bits in (8, 4):
        big = 0
        for name, s in tapi.build(cfg).schema(cfg).items():
            if len(s.shape) < 2:
                continue
            q = np.zeros(s.shape, np.uint8)
            sc = np.ones(s.shape[:-1] + (1,), np.float32)
            qt = pack_qt(q, sc, sc, bits=bits)
            spec = shd.leaf_shardings(s.axes, qt, rules, m)
            assert type(spec) is type(qt), name
            assert qt.q.dtype == torch.uint8
            big += isinstance(qt, QT4)
            assert isinstance(qt, QT4 if bits == 4 else QT)
        assert big if bits == 4 else not big


# ------------------------------------------------------------- parity grid

def _profiles(fm):
    return {
        "train": (jshd.train_rules(fm), shd.train_rules(fm)),
        "opt_state": (jshd.opt_state_rules(fm), shd.opt_state_rules(fm)),
        "serve": (jshd.serve_rules(fm), shd.serve_rules(fm)),
        "serve_long": (jshd.serve_rules(fm, long_context=True),
                       shd.serve_rules(fm, long_context=True)),
    }


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    """Every profile (and its ``arch_rules`` KV adjustment) and the exact-TP
    table resolve every full-size schema tensor to the reference's spec."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    fm = FakeMesh(**MESHES[mesh])
    jsch, tsch = japi.build(jcfg).schema(jcfg), tapi.build(tcfg).schema(tcfg)
    assert set(jsch) == set(tsch)
    profiles = _profiles(fm)
    for name in list(profiles):
        jr, tr = profiles[name]
        profiles[name + "+arch"] = (jshd.arch_rules(jcfg, fm, jr),
                                    shd.arch_rules(tcfg, fm, tr))
    for prof, (jr, tr) in profiles.items():
        assert jr.table == tr.table, prof
        for n, s in jsch.items():
            assert tsch[n].shape == s.shape and tsch[n].axes == s.axes, n
            want = _norm(jshd.resolve_spec(s.axes, s.shape, jr, fm))
            got = shd.resolve_spec(s.axes, s.shape, tr, fm)
            assert tuple(got) == want, (prof, n, got, want)
    for n, s in jsch.items():
        jr = jshd.serve_tp_table(jcfg, fm, s.axes)
        tr = shd.serve_tp_table(tcfg, fm, s.axes)
        assert jr.table == tr.table, n
        want = _norm(jshd.resolve_spec(s.axes, s.shape, jr, fm))
        assert tuple(shd.resolve_spec(s.axes, s.shape, tr, fm)) == want, n
    assert shd.kv_divisible(tcfg, fm) == jshd.kv_divisible(jcfg, fm)


def _ref_cache_shapes(cfg, batch, max_len, **kw):
    import inspect
    mod = japi.build(cfg)
    accepted = inspect.signature(mod.init_cache).parameters
    init_kw = {k: v for k, v in kw.items() if k in accepted}
    shapes = jax.eval_shape(lambda: mod.init_cache(cfg, batch, max_len,
                                                   **init_kw))
    return {k: tuple(v.shape) for k, v in shapes.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh, real_meshes):
    """The cache of every family resolves, in the ``batch`` and ``slot``
    layouts (and int8 where the family has it), to the reference's specs;
    on the meshes the forced devices can build, through the reference's own
    ``cache_shardings``."""
    jcfg, tcfg = jreg.get(arch), treg.get(arch)
    fm = FakeMesh(**MESHES[mesh])
    for long_context in (False, True):
        jr = jshd.arch_rules(jcfg, fm, jshd.serve_rules(
            fm, long_context=long_context))
        tr = shd.arch_rules(tcfg, fm, shd.serve_rules(
            fm, long_context=long_context))
        for kw in (dict(layout="batch"), dict(layout="slot"),
                   dict(layout="slot", kv_bits=8)):
            got = shd.cache_shardings(tcfg, fm, tr, 16, 256, **kw)
            specs = japi.cache_specs(jcfg, **kw)
            assert set(got) == set(specs), kw
            assert shd.cache_shapes(tcfg, 16, 256, **kw) == \
                _ref_cache_shapes(jcfg, 16, 256, **kw)
            shapes = _ref_cache_shapes(jcfg, 16, 256, **kw)
            for k, axes in specs.items():
                want = _norm(jshd.resolve_spec(axes, shapes[k], jr, fm))
                assert tuple(got[k]) == want, (kw, k, got[k], want)
            if mesh in REAL and not long_context:
                m = real_meshes[mesh]
                ref = jshd.cache_shardings(
                    jcfg, m, jshd.arch_rules(jcfg, m, jshd.serve_rules(m)),
                    16, 256, **kw)
                for k in ref:
                    assert tuple(got[k]) == _norm(ref[k].spec), (kw, k)
    want = _norm(jshd.resolve_spec(["batch", None], (16, 128),
                                   jshd.serve_rules(fm), fm))
    assert tuple(shd.batch_sharding(fm, shd.serve_rules(fm), (16, 128))) \
        == want


@pytest.mark.parametrize("mesh", REAL)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "glm4-9b", "mamba2-370m"])
def test_state_specs_match_reference(arch, mesh, real_meshes):
    """``optimizer.state_shardings`` over ZeRO specs: fp32 moments take the
    parameter's spec, Q8 moments keep it on the symbols and drop the last
    axis on scale / zero, the step replicates — as the reference's."""
    jcfg, tcfg = jreg.reduced(jreg.get(arch)), treg.reduced(treg.get(arch))
    m = real_meshes[mesh]
    fm = FakeMesh(**MESHES[mesh])
    shapes = {n: s.shape for n, s in tapi.build(tcfg).schema(tcfg).items()}
    ref_opt = jshd.param_shardings(jcfg, m, jshd.opt_state_rules(m))
    got_opt = shd.param_shardings(tcfg, fm, shd.opt_state_rules(fm))
    for q8 in (False, True):
        ref = jopt.state_shardings(jopt.AdamWConfig(quantized_state=q8),
                                   shapes, ref_opt)
        got = topt.state_shardings(topt.AdamWConfig(quantized_state=q8),
                                   shapes, got_opt)
        assert got.step == P() and _norm(ref.step.spec) == ()
        for part in ("m", "v"):
            rd, gd = getattr(ref, part), getattr(got, part)
            assert set(rd) == set(gd)
            for n in rd:
                if isinstance(rd[n], tuple) and hasattr(rd[n], "_fields"):
                    assert isinstance(gd[n], topt.Q8Moment), n
                    for r, g in zip(rd[n], gd[n]):
                        assert tuple(g) == _norm(r.spec), (n, g, r.spec)
                else:
                    assert not isinstance(gd[n], topt.Q8Moment), n
                    assert tuple(gd[n]) == _norm(rd[n].spec), n


def test_spec_type_is_a_trimmed_tuple():
    """The port's spec compares as the tuple of its entries and pads back
    to any rank."""
    assert P("data", None) != P("data")
    spec = shd.resolve_spec(("batch", None, "kv"), (4, 8, 3),
                            shd.Rules({"batch": "data"}),
                            FakeMesh(data=2, model=4))
    assert spec == P("data") and tuple(spec) == ("data",)
    assert spec.padded(3) == ("data", None, None)
    # specs cross process boundaries (the ranks return them) intact
    import pickle
    for sp in (spec, P(), P(("pod", "data"), None, "model")):
        assert pickle.loads(pickle.dumps(sp)) == sp
        assert type(pickle.loads(pickle.dumps(sp))) is P
    assert dataclasses.is_dataclass(shd.Rules({}))
