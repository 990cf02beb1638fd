"""The port's multi-device serving (``--mesh``) on the CPU: the ports of the
three tests of ``tests/test_sharded_serving.py``, on a 2x4 world of 8
``gloo`` ranks (one process each, ``repro_torch.launch.mesh.spawn``), as the
reference runs them on 8 forced CPU devices, plus the launcher.

* **placement** — the streaming loader's ``make_param_placer`` lands every
  QT / QT4 leaf with consistent q / scale / zero specs, and each rank's
  weight bytes equal the reference's ``per_device_bytes`` for the device at
  the same mesh position (mesh order, data-major);
* **numerics** — greedy decode through the sharded engine is bitwise the
  port's single device, dense and MoE, and equals the reference's sharded
  engine up to the near-tie rule of ``tests/test_torch_serve.py`` (the
  reference's sharded tokens are its single device's, which its own suite
  asserts);
* **slot pool** — the continuous engine's pool is placed by the resolved
  ``layout="slot"`` spec and serves every request bitwise as the
  single-device 4-slot engine;
* **heads** — on a 2x2 world, where the reduced configs' 2 KV heads divide
  the model axis, each rank attends over its own KV head and its caches
  hold only that head (the resolved spec), and the tokens stay bitwise.

One world a mesh serves both configs (a spawned world costs seconds); each
rank runs one intra-op thread.  The configs are the reduced ones cut to 2
layers (the MoE's expert hidden dim to 64) so that eight ranks decode the
container in seconds; the containers are the JAX package's, with
4,096-symbol segments.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core.quant import Granularity as JGranularity
from repro.core.spec import CompressionSpec as JSpec
from repro.core.store import CompressedModel as JModel
from repro.launch import mesh as jmesh
from repro.models import api as japi
from repro.serving import engine as jengine
from repro_torch.configs import registry as treg
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh

import torch_mesh_cases as cases

ROOT = Path(__file__).resolve().parents[1]
SPEC = "*:bits=8,codec=huffman; defaults:segment_symbols=4096"
B, PROMPT, GEN, MAX_LEN = 4, 8, 10, 24
SLOT_LENS, SLOT_GEN, SLOT_MAX_LEN = (5, 8, 3, 7, 2), 6, 32
NEAR_TIE_STEPS = 2
WORLD_TIMEOUT_S = 240


def _bf16_step(x: float) -> float:
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


def _container(arch, tmp):
    """Both packages' narrow config, the JAX package's weights and its
    container saved for the ranks."""
    import dataclasses
    jcfg = jreg.reduced(jreg.get(arch))
    jcfg = dataclasses.replace(jcfg, n_layers=2,
                               **({"d_ff": 64} if jcfg.moe else {}))
    tcfg = cases.narrow(treg, arch)
    params = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    cm = JModel.compress(host, spec=JSpec.parse(
        SPEC, default_granularity=JGranularity.PER_CHANNEL))
    path = str(tmp / f"{arch}.npz")
    cm.save(path)
    return jcfg, tcfg, cm, path


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    dense = _container("qwen3-1.7b", tmp)
    moe = _container("qwen2-moe-a2.7b", tmp)
    prompt = np.random.default_rng(2).integers(0, dense[1].vocab,
                                               (B, PROMPT))
    prompts = cases.random_prompts(dense[1].vocab, SLOT_LENS)
    return {"dense": dense, "moe": moe, "prompt": prompt,
            "prompts": prompts}


def _serve(containers, data, model):
    """One world: the dense config lockstep + continuous, then the MoE
    config lockstep; each rank's results."""
    dense, moe = containers["dense"], containers["moe"]
    prompt = containers["prompt"]
    return tmesh.spawn(
        cases.serve_worlds, data, model, backend="gloo", device="cpu",
        timeout_s=WORLD_TIMEOUT_S,
        args=([dict(cfg=dense[1], path=dense[3], prompt=prompt, gen=GEN,
                    max_len=SLOT_MAX_LEN, prompts=containers["prompts"],
                    slot_gen=SLOT_GEN),
               dict(cfg=moe[1], path=moe[3], prompt=prompt, gen=GEN,
                    max_len=MAX_LEN)],))


@pytest.fixture(scope="module")
def world(containers):
    """The reference's 2x4: the reduced configs' 2 KV heads do not divide
    the model axis, so the heads stay whole."""
    return dict(containers, ranks=_serve(containers, 2, 4))


@pytest.fixture(scope="module")
def heads_world(containers):
    """2x2: the 2 KV heads split over the model axis, one a rank."""
    return dict(containers, ranks=_serve(containers, 2, 2))


@pytest.fixture(scope="module")
def single(containers, few_threads_module):
    """The port's single device: lockstep tokens of both configs and the
    dense config's 4-slot engine."""
    out = {}
    for k in ("dense", "moe"):
        _, tcfg, _, path = containers[k]
        max_len = SLOT_MAX_LEN if k == "dense" else MAX_LEN
        toks, params = cases.lockstep_tokens(
            tcfg, path, containers["prompt"], GEN, max_len, "cpu")
        out[k] = toks
        if k == "dense":
            out["slots"] = cases.slot_tokens(
                tcfg, params, containers["prompts"], SLOT_GEN, SLOT_MAX_LEN,
                "cpu")
    return out


@pytest.fixture(scope="module")
def few_threads_module():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_qt_leaves_land_consistently_sharded(world):
    ranks = [r[0] for r in world["ranks"]]
    coords = [r["coord"] for r in ranks]
    assert coords == [(d, m) for d in range(2) for m in range(4)]
    model_sharded = 0
    for name, parts in ranks[0]["placement"].items():
        (qspec, qshape), *followers = parts
        for spec, shape in followers:
            for dim, (size, got, want) in enumerate(zip(shape, spec, qspec)):
                if size == 1:
                    assert got is None, (name, dim, got)
                else:
                    assert got == want, \
                        f"{name} dim {dim}: scale/zero {got}, q {want}"
        if "model" in qspec:
            model_sharded += 1
        # every rank cut the same specs
        for r in ranks[1:]:
            assert [s for s, _ in r["placement"][name]] == \
                [s for s, _ in parts], name
    assert model_sharded, "no QT leaf sharded over the model axis"
    pb = ranks[0]["weight_bytes"]
    assert len(pb) == 8 and max(pb.values()) < sum(pb.values())
    assert all(r["weight_bytes"] == pb for r in ranks)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_per_rank_bytes_equal_reference_per_device(world, arch):
    """Rank (d, m)'s weight bytes are the reference's device at mesh
    position (d, m) under its own placer (2x4 over the 8 forced
    devices)."""
    k = "dense" if arch == "qwen3-1.7b" else "moe"
    jcfg, _, cm, _ = world[k]
    mesh = jmesh.make_serve_mesh(2, 4)
    placed = jengine.load_params_from_compressed(
        cm, quantized=True, backend="numpy",
        placer=jengine.make_param_placer(jcfg, mesh))
    ref = jengine.per_device_bytes(placed)
    devs = list(mesh.devices.flat)
    got = world["ranks"][0][0 if k == "dense" else 1]["weight_bytes"]
    for i, dev in enumerate(devs):
        assert got[(i // 4, i % 4)] == ref[str(dev)], (i, dev)


def _reference_logits(cfg, params, prompt, max_len):
    steps = jengine.ServeSteps(cfg, jengine.ServeConfig(max_len=max_len))
    logits, cache = steps.prefill_fn(params, jnp.asarray(prompt, jnp.int32))
    out, toks = [], []
    for i in range(GEN):
        lg = np.asarray(logits, np.float32)[:, -1]
        out.append(lg)
        toks.append(np.argmax(lg, axis=-1))
        if i + 1 < GEN:
            logits, cache = steps.decode_fn(
                params, jnp.asarray(toks[-1][:, None], jnp.int32), cache,
                jnp.int32(PROMPT + i))
    return np.stack(out), np.stack(toks, axis=1)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_sharded_greedy_decode_bit_identical(world, single, arch):
    k = "dense" if arch == "qwen3-1.7b" else "moe"
    for r in world["ranks"]:
        got = r[0 if k == "dense" else 1]["tokens"]
        assert got.shape == (B, GEN)
        np.testing.assert_array_equal(got, single[k])
    # the reference's engine on the same container (its sharded tokens
    # are its single device's): equal up to a reference near-tie
    jcfg, _, cm, _ = world[k]
    max_len = SLOT_MAX_LEN if k == "dense" else MAX_LEN
    jparams = jengine.load_params_from_compressed(cm, backend="numpy")
    logits, want = _reference_logits(jcfg, jparams, world["prompt"], max_len)
    got = single[k]
    compared = 0
    for row in range(B):
        diff = np.nonzero(got[row] != want[row])[0]
        if not len(diff):
            compared += GEN
            continue
        d = int(diff[0])
        best = float(logits[d, row, want[row, d]])
        gap = best - float(logits[d, row, got[row, d]])
        assert gap <= NEAR_TIE_STEPS * _bf16_step(best), (row, d, gap)
        compared += d + 1
    assert compared >= B * 2


def test_continuous_engine_slot_cache_sharded_and_identical(world, single):
    from repro.distributed import sharding as jshd
    tcfg = world["dense"][1]
    for r in world["ranks"]:
        out = r[0]
        d, _ = out["coord"]
        # slot axis (dim 1) resolved over data: this rank holds its block
        specs = out["slot_specs"]
        for key, spec in specs.items():
            assert spec.padded(5)[1] == "data", (key, spec)
        assert out["slot_rows"] == (2 * d, 2 * d + 2)
        assert out["slot_cache"]["k"] == (tcfg.n_layers, 2, SLOT_MAX_LEN,
                                          tcfg.n_kv_heads, tcfg.hd)
        # the pool as held is the block the reported specs give a rank
        full = (tcfg.n_layers, 4, SLOT_MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
        for key, spec in specs.items():
            assert out["slot_cache"][key] == _held(full, spec, 2, 4), key
        assert out["slot_tokens"] == single["slots"]
        # the spec is the reference's own resolution of the slot layout
        jcfg = world["dense"][0]
        jm = jmesh.make_serve_mesh(2, 4)
        want = jshd.cache_shardings(jcfg, jm,
                                    jengine.serve_mesh_rules(jcfg, jm),
                                    4, SLOT_MAX_LEN, layout="slot")
        for key in specs:
            assert tuple(specs[key]) == tuple(want[key].spec), key
    assert all(len(t) == SLOT_GEN for t in single["slots"])


def _held(full, spec, data, model):
    """The block of a ``full``-shaped leaf one rank holds under ``spec``."""
    sizes = {"data": data, "model": model}
    return tuple(n // math.prod(sizes[a] for a in tshd.entry_axes(e))
                 for n, e in zip(full, spec.padded(len(full))))


def _kv_bytes(cfg, rows, max_len):
    """Bytes of a whole bf16 k / v cache of ``rows`` rows."""
    return 2 * 2 * cfg.n_layers * rows * max_len * cfg.n_kv_heads * cfg.hd


def test_kv_heads_split_over_model_caches_hold_their_block(heads_world):
    """2x2: the reduced configs' 2 KV heads divide the model axis, so each
    rank's lockstep cache, slot pool and prefill scratch hold its rows and
    its one KV head, as the reported specs say."""
    tcfg = heads_world["dense"][1]
    moe_cfg = heads_world["moe"][1]
    full = (tcfg.n_layers, 4, SLOT_MAX_LEN, tcfg.n_kv_heads, tcfg.hd)
    for dense, moe in heads_world["ranks"]:
        for key, spec in dense["slot_specs"].items():
            assert spec.padded(5)[1] == "data", (key, spec)
            assert spec.padded(5)[3] == "model", (key, spec)
            assert dense["slot_cache"][key] == _held(full, spec, 2, 2), key
        assert dense["slot_cache"]["k"] == (tcfg.n_layers, 2, SLOT_MAX_LEN,
                                            tcfg.n_kv_heads // 2, tcfg.hd)
        assert dense["cache_bytes"] * 4 == _kv_bytes(tcfg, B, SLOT_MAX_LEN)
        assert moe["cache_bytes"] * 4 == _kv_bytes(moe_cfg, B, MAX_LEN)


def test_kv_heads_split_over_model_tokens_bitwise(heads_world, single):
    """2x2, heads split: lockstep tokens (dense and MoE) and every slot
    request are bitwise the port's single device."""
    for dense, moe in heads_world["ranks"]:
        np.testing.assert_array_equal(dense["tokens"], single["dense"])
        assert dense["slot_tokens"] == single["slots"]
        np.testing.assert_array_equal(moe["tokens"], single["moe"])


def test_lockstep_cache_rows_split_over_data(world):
    """Each rank holds its data group's half of the lockstep cache."""
    tcfg = world["dense"][1]
    # k and v, bf16
    full = 2 * 2 * tcfg.n_layers * B * SLOT_MAX_LEN * tcfg.n_kv_heads \
        * tcfg.hd
    for r in world["ranks"]:
        assert r[0]["cache_bytes"] * 2 == full


# ------------------------------------------------------------- the launcher

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_launcher_mesh_serves_and_prints_the_mesh_line():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--arch", "qwen3-1.7b", "--mesh", "1x2", "--device", "cpu",
           "--dist-backend", "gloo", "--decode-backend", "numpy",
           "--compress-spec", SPEC, "--batch", "2", "--prompt-len", "8",
           "--gen", "4"]
    r = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    mesh = [ln for ln in lines if ln.startswith("mesh 1x2 (data x model): ")]
    assert len(mesh) == 1, r.stdout
    assert "over 2 ranks [gloo, cpu]" in mesh[0]
    assert sum(ln.startswith("generated (2, 4) tokens") for ln in lines) == 1


@pytest.mark.parametrize("extra,msg", [
    (["--resident", "compressed"],
     "--resident compressed is single-device (per-layer decode targets the "
     "bandwidth-bound single-accelerator regime); drop --mesh or use "
     "--resident dense"),
    (["--batch-slots", "2", "--kv-spec", "bits=16"],
     "paged KV (--kv-spec) is single-device today; drop --mesh"),
    (["--batch-slots", "2", "--replicas", "2"],
     "--replicas is data parallelism over single-device engines; the mesh "
     "layer shards ONE engine — drop --mesh or serve a single replica"),
    (["--batch-slots", "2", "--traffic", "4"],
     "--traffic paces arrivals and sheds on a full queue by each rank's own "
     "clock, but on a --mesh every rank must take the same admission "
     "decisions; drop --traffic (the uniform --batch wave is admitted alike "
     "on every rank) or --mesh"),
    (["--dist-backend", "nccl"],
     "--dist-backend nccl runs on cards; ranks on the CPU take "
     "--dist-backend gloo"),
    ([], None),
])
def test_launcher_mesh_refusals(extra, msg, capsys):
    from repro_torch.launch import serve as tserve
    argv = ["--arch", "qwen3-1.7b", "--mesh", "1x2", "--device", "cpu",
            "--dist-backend", "gloo"] + extra
    if msg is None:
        # a malformed mesh is refused in the reference's words too
        argv[3] = "2by2"
        msg = "--mesh: bad mesh spec '2by2': expected DATAxMODEL, e.g. 2x4"
    with pytest.raises(SystemExit) as e:
        tserve.main(argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--production", "--shape", "--multi-pod"])
def test_launcher_production_flags_still_refused(flag, capsys):
    """With ``--mesh`` the production flags are refused: ``--production``
    dry-runs its own production mesh, and ``--shape`` / ``--multi-pod``
    apply to ``--production`` only."""
    from repro_torch.launch import serve as tserve
    argv = {"--shape": ["--shape", "decode_32k"]}.get(flag, [flag])
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen3-1.7b", "--mesh", "1x2"] + argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err
    assert ("drop --mesh" if flag == "--production"
            else "applies to --production only") in err

