"""Sharded-compute training (every family's train cell layout: FSDP
blocks gathered at use and reduce-scattered back, column- and
row-parallel products, a rank's heads and experts, sequence-parallel
carries, an SSM's ``in_zx`` re-blocked for its heads) on the CPU, against
one device and the JAX package's train cell.

One spawned 2 x 2 ``gloo`` world (``repro_torch.launch.mesh.spawn``, one
process a rank) runs every job; reduced qwen3-1.7b, qwen2-moe-a2.7b,
seamless-m4t-medium and mamba2-370m, cut to 2 layers (the
encoder-decoder's 2 encoder and 2 decoder layers, the MoE's expert
hidden dim to 64), and reduced jamba-1.5-large-398b cut to one period of
4 (Mamba, Mamba with the MoE FFN, attention, Mamba with the MoE FFN; its
FFNs' hidden dim 64), take the weights the reference made (an npz), and
batches of 4 x 16 tokens (the encoder-decoder's with 4 x 16 source
frames, normal from the same generator, in bf16 as the train cells take
them).  The routed configs
admit every routed choice (``capacity_factor`` = E / top_k): a sharded
cell sizes the capacity by each data rank's rows, one device by the whole
batch's.  Their ranks are fed one device's router choices (a flip of a
near-tie moves a token's gradient by far more than rounding), and every
choice of their own that differs must be a near-tie.

* **gradients** of one batch, every parameter, relative L2 within
  ``GRAD_RTOL`` of one device's (measured: at most 0.0105, the bf16
  rounding of the row-parallel sums; the SSM blocks' 0.0178-0.0277);
  also with ``seq_sp`` off (the carry
  whole over model), with ``q8_gather=8``, with KV heads that do not
  divide the model axis (``wk`` / ``wv`` whole over it) and, for the
  hybrid, with the MoE aux weighted ``AUX_HEAVY`` (where the aux's
  gradient is most of the router's).  Three planted
  faults must read at least 3 x the limit: the column-parallel input's
  gradient not all-reduced over model, a norm scale's gradient summed
  over model where its carry was whole, a reduce-scatter backward that
  keeps its own partial (measured 0.77-1.0); and a fourth on the
  encoder-decoder, its norms on carries split along S without
  ``split=``, must read it on every norm scale (measured 0.24-0.75);
  three on the ssm: ``in_zx`` placed by the plain cut of ``[z | x]``
  (each model rank's x columns some of z's), ``conv_bc`` entering the
  rank's heads without its model-axis sum (read on ``conv_bc_*``), the
  pre-block and final norms without ``split=`` (read on them); two on
  the hybrid: the MoE aux's statistics not summed over data (read on the
  router at ``AUX_HEAVY``, 0.55-1.08; at the loss's 0.01 it reads
  0.05-0.09), its loss on logits gathered whole, each rank its rows'
  mean (0.64-0.75);
* **steps**: the loss and grad norm of 2 steps within ``RTOL``; each
  parameter's first moment (linear in the gradients) within
  ``GRAD_RTOL`` and its f32-moment update within ``UPDATE_RTOL`` of one
  device's.  Adam's first steps move each element by about the learning
  rate, either way, so an element whose gradient is within rounding of
  zero moves the other way on the mesh: the updates' relative L2 reads up
  to 0.19 (``k_norm``; 0.062 under exact TP, whose forward rounds as one
  device's); the moments up to the gradients' 1% (mamba2's 3.5%).  The
  hybrid's second gradient moves up to 0.105 on one device alone given
  those flipped elements, so its update and moment are held step by
  step, each from the state the mesh's step started from;
* **grad_compress** steps: the first step's loss and grad norm within
  ``RTOL``.  The compression's grid does not hold 0 (the zero point is a
  block's minimum), so a zero gradient element comes back a residue whose
  sign follows the rounding of its block's range, which Adam turns into
  a step of the learning rate: the params part ways from one device's
  after the first update (the embedding's update reads 0.84), on one
  device as much as on the mesh.  The compression is held bitwise below;
* **the reference**: ``repro.launch.specs.build_train_cell`` jitted on a
  2 x 2 JAX mesh of the host devices ``tests/conftest.py`` forces, against
  the port's ``specs.build_train_cell`` on the ranks, 2 steps of each:
  loss and grad norm within ``RTOL``, first moments within ``GRAD_RTOL``
  (but the routed configs' ``ROUTED`` leaves'), updates within
  ``UPDATE_RTOL`` (measured 0.156, the MoE's experts; the hybrid's
  0.178);
* **q8_gather** at 8 and 4 bits (qwen3, seamless, mamba2 and jamba):
  symbols, scales and zeros of the ranks' blocks, gathered, bitwise one
  device's; the FSDP all-gathers over data move uint8 (packed nibbles at
  4 bits) and exactly 1/2 (1/4) of the bf16 gather's bytes, plus the f32
  per-row scales where a quantized leaf's rows split over data (none of
  mamba2's: its tied table's rows rest over model), beside the f32
  leaves no ``q8_gather`` quantizes (the hybrid's router), gathered alike
  in every run;
* **placement**: ``shard_train_state`` then ``gather_params`` gives every
  leaf of reduced mamba2 and jamba back bitwise, ``in_zx`` (re-blocked at
  rest; the hybrid's stacked over periods) included;
* **grad_compress**: the block arithmetic on leaves split on dim 0, on a
  later dim and on both, with 256-element blocks that straddle ranks and a
  zero-padded last block, bitwise the single-device function's blocks,
  and no all-gather; and ``train_loop.compress_blocks`` of mamba2's and
  jamba's gradient trees (their ``in_zx`` re-blocked) bitwise one
  device's;
* **every family** trains under the train cell's hints: every config of
  the registry gets them, and its cell computes sharded; exact TP on a
  mesh is refused for the ssm and the hybrid, whose train state rests
  ``in_zx`` re-blocked.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import ShapeConfig as JShape
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.training import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.distributed import grad_compress
from repro_torch.launch import mesh as tmesh
from repro_torch.training import optimizer as topt

import torch_sharded_cases as scases
import torch_sharded_train_cases as cases

GRAD_RTOL = 0.05
# the leaves whose gradients the router's choices reach: the reference's
# compiled router flips near-ties that the port's eager one does not (one
# device against one device: 0.05-0.10 on these, ROADMAP queue 3 items
# 5-6), so against the reference their moments are not held to
# GRAD_RTOL (their updates are); against one device they are, its
# choices fed
ROUTED = ("moe/", "mlp_norm")
FAULT_FACTOR = 3.0
RTOL = 2e-3
UPDATE_RTOL = 0.25
NEAR_TIE = 0.02
B, S, STEPS = 4, 16, 2
WORLD_TIMEOUT_S = 300
ARCHS = {"qwen3": "qwen3-1.7b", "moe": "qwen2-moe-a2.7b",
         "seamless": "seamless-m4t-medium", "mamba2": "mamba2-370m",
         "jamba": "jamba-1.5-large-398b"}
FAULTS = {"rs_keeps_own": ("qwen3", None),       # fault -> config, seq_sp
          "column_input_unsummed": ("qwen3", False),
          "whole_norm_summed": ("qwen3", False),
          "encdec_norm_unsplit": ("seamless", None),
          "ssm_zx_plain": ("mamba2", None),
          "ssm_conv_bc_unsummed": ("mamba2", None),
          "ssm_norm_unsplit": ("mamba2", None),
          "hybrid_aux_local": ("jamba", None),
          "hybrid_loss_gathered": ("jamba", None)}
# the hybrid's MoE aux weight in the cases that read the aux's own
# gradient: at the loss's 0.01 the cross-entropy's gradient through the
# gates outweighs it on the router (a wrong aux reads 0.05-0.09 there)
AUX_HEAVY = 1.0
FAULT_KW = {"hybrid_aux_local": dict(aux_coef=AUX_HEAVY)}
# the faults read on some leaves only (all of them otherwise)
FAULT_LEAVES = {"encdec_norm_unsplit": "norm",
                "ssm_conv_bc_unsummed": ("conv_bc_w", "conv_bc_b"),
                "ssm_norm_unsplit": ("layers/norm", "final_norm"),
                "hybrid_aux_local": "moe/router",
                "hybrid_loss_gathered": ("embed", "final_norm", "/in_zx",
                                         "/wq", "/router", "/w_down")}
# the configs whose q8_gather is held: the symbols, and the bytes gathered
# (whether f32 per-row scales are gathered over data beside the symbols)
Q8_KEYS = {"qwen3": True, "seamless": True, "mamba2": False,
           "jamba": True}
# the configs whose 2 steps are held to one device's 2 steps (the hybrid's
# step by step: test_hybrid_steps_match_one_device_step_by_step)
TRAJECTORY_KEYS = ["qwen3", "moe", "seamless", "mamba2"]
COMPRESS = [((64, 96), ("data", None)), ((64, 96), (None, "model")),
            ((10, 50), ("data", "model")), ((3, 10, 50),
                                            (None, "data", "model")),
            ((36, 44), ("model", "data")), ((2, 4, 130), (None, "model"))]


def _cfgs(arch):
    """Both packages' reduced config, 2 layers (the encoder-decoder's
    reduced 2 encoder layers kept; the hybrid's one period of 4), the
    MoE's expert hidden dim 64 and every routed choice admitted."""
    out = []
    for reg in (jreg, treg):
        cfg = reg.reduced(reg.get(arch))
        cfg = dataclasses.replace(cfg, n_layers=cfg.attn_period
                                  if cfg.family == "hybrid" else 2)
        if cfg.moe:
            cf = float(cfg.moe.padded_experts(16) // cfg.moe.top_k)
            cfg = dataclasses.replace(cfg, d_ff=64, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def few_threads_module():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, few_threads_module):
    """Each config's reference weights, batches (the encoder-decoder's
    source frames drawn after its tokens), one device's gradients, steps
    and router calls."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    rng = np.random.default_rng(0)
    out = {}
    for key, arch in ARCHS.items():
        jcfg, tcfg = _cfgs(arch)
        jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
        path = str(tmp / f"{key}.npz")
        np.savez(path, **{k: np.asarray(v, np.float32)
                          for k, v in jp.items()})
        params = scases.load_params(tcfg, path)
        toks = [rng.integers(0, tcfg.vocab, (B, S + 1)).astype(np.int32)
                for _ in range(STEPS)]
        srcs = [rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
                for _ in range(STEPS)] if tcfg.family == "encdec" else None
        batches = [{"tokens": torch.from_numpy(t)} for t in toks]
        for b, src in zip(batches, srcs or ()):
            b["src_embeds"] = torch.from_numpy(src).to(torch.bfloat16)
        loss, grads, routes = cases.single_grads(tcfg, params, batches[0])
        s = dict(jcfg=jcfg, tcfg=tcfg, jparams=jp, params=params,
                 toks=toks, srcs=srcs, batches=batches, loss=loss,
                 grads=grads, routes=routes,
                 steps=cases.single_steps(tcfg, params, batches),
                 compressed=cases.single_steps(tcfg, params, batches,
                                               grad_compress=True))
        if key in Q8_KEYS:
            s["q8_grads"] = cases.single_grads(tcfg, params, batches[0],
                                               q8_gather=8)
        if tcfg.family == "hybrid":
            s["aux_grads"] = cases.single_grads(tcfg, params, batches[0],
                                                aux_coef=AUX_HEAVY)
        if key == "qwen3":
            kv1 = dataclasses.replace(tcfg, n_kv_heads=1)
            p1 = {n: p[..., :tcfg.hd] if n.endswith(("/wk", "/wv")) else p
                  for n, p in params.items()}
            s["kv1"] = (kv1, p1, cases.single_grads(kv1, p1, batches[0]))
        out[key] = s
    return out


def _grads(s, **kw):
    """A ``grads`` job of config ``s``, a routed one fed one device's
    router choices: its ``q8_gather=8`` run's for ``q8_gather=8`` (held to
    that run), else its bf16 run's (the 4-bit run is read for its gathers'
    bytes only)."""
    routes = s["routes"] if s["tcfg"].moe else None
    if routes is not None and kw.get("q8_gather") == 8:
        routes = s["q8_grads"][2]
    return ("grads", dict(cfg=s["tcfg"], params=s["params"],
                          batch=s["batches"][0], routes=routes, **kw))


@pytest.fixture(scope="module")
def world(setup):
    """Every job's results, rank by rank, from one 2 x 2 world."""
    q, m, e, s2, j = (setup[k] for k in ARCHS)
    kv1, p1, _ = q["kv1"]
    rng = np.random.default_rng(5)
    leaves = [(rng.normal(0, 1, shape).astype(np.float32), spec)
              for shape, spec in COMPRESS]
    jobs = {
        "grads/qwen3": _grads(q),
        "grads/moe": _grads(m),
        "grads/qwen3/seq_sp_off": _grads(q, seq_sp=False),
        "grads/moe/seq_sp_off": _grads(m, seq_sp=False),
        "grads/qwen3/q8": _grads(q, q8_gather=8, record=True),
        "grads/qwen3/q8_4": _grads(q, q8_gather=4, record=True),
        "grads/qwen3/bf16": _grads(q, record=True),
        "grads/qwen3/kv1": ("grads", dict(cfg=kv1, params=p1,
                                          batch=q["batches"][0])),
        "grads/seamless": _grads(e),
        "grads/seamless/seq_sp_off": _grads(e, seq_sp=False),
        "grads/seamless/q8": _grads(e, q8_gather=8, record=True),
        "grads/seamless/q8_4": _grads(e, q8_gather=4, record=True),
        "grads/seamless/bf16": _grads(e, record=True),
        "grads/mamba2": _grads(s2),
        "grads/mamba2/seq_sp_off": _grads(s2, seq_sp=False),
        "grads/mamba2/q8": _grads(s2, q8_gather=8, record=True),
        "grads/mamba2/q8_4": _grads(s2, q8_gather=4, record=True),
        "grads/mamba2/bf16": _grads(s2, record=True),
        "grads/jamba": _grads(j),
        "grads/jamba/aux": _grads(j, aux_coef=AUX_HEAVY),
        "grads/jamba/q8": _grads(j, q8_gather=8, record=True),
        "grads/jamba/q8_4": _grads(j, q8_gather=4, record=True),
        "grads/jamba/bf16": _grads(j, record=True),
        **{f"fault/{f}": _grads(setup[k], seq_sp=sp, fault=f,
                                **FAULT_KW.get(f, {}))
           for f, (k, sp) in FAULTS.items()},
        **{f"steps/{k}": ("steps", dict(
            cfg=s["tcfg"], params=s["params"], batches=s["batches"],
            routes=s["steps"]["routes"] if s["tcfg"].moe else None,
            states=k not in TRAJECTORY_KEYS))
           for k, s in setup.items()},
        **{f"compressed/{k}": ("steps", dict(
            cfg=s["tcfg"], params=s["params"], batches=s["batches"],
            grad_compress=True,
            routes=s["compressed"]["routes"] if s["tcfg"].moe else None))
           for k, s in setup.items()},
        **{f"cell/{k}": ("steps", dict(
            cfg=s["tcfg"], params=s["params"], batches=s["batches"],
            cell_shape=(B, S))) for k, s in setup.items()},
        "q8": ("q8", dict(cfg=q["tcfg"], params=q["params"],
                          bits_list=(8, 4))),
        "q8/seamless": ("q8", dict(cfg=e["tcfg"], params=e["params"],
                                   bits_list=(8, 4))),
        "q8/mamba2": ("q8", dict(cfg=s2["tcfg"], params=s2["params"],
                                 bits_list=(8, 4))),
        "q8/jamba": ("q8", dict(cfg=j["tcfg"], params=j["params"],
                                bits_list=(8, 4))),
        "compress": ("compress", dict(leaves=leaves)),
        "roundtrip/mamba2": ("roundtrip", dict(cfg=s2["tcfg"],
                                               params=s2["params"])),
        "compress_tree/mamba2": ("compress_tree", dict(
            cfg=s2["tcfg"], grads=s2["grads"])),
        "roundtrip/jamba": ("roundtrip", dict(cfg=j["tcfg"],
                                              params=j["params"])),
        "compress_tree/jamba": ("compress_tree", dict(
            cfg=j["tcfg"], grads=j["grads"])),
    }
    ranks = tmesh.spawn(cases.run_jobs, 2, 2, backend="gloo", device="cpu",
                        timeout_s=WORLD_TIMEOUT_S,
                        args=(list(jobs.values()),))
    out = {k: [r[i] for r in ranks] for i, k in enumerate(jobs)}
    out["leaves"] = leaves
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _worst(got, want):
    errs = {n: _rel(got[n], want[n]) for n in want}
    n = max(errs, key=errs.get)
    return n, errs[n]


def _assert_near_ties(rank):
    for flips, gap in rank["routes"]:
        assert gap <= NEAR_TIE, (flips, gap)


GRAD_CASES = ["qwen3", "moe", "qwen3/seq_sp_off", "moe/seq_sp_off",
              "qwen3/q8", "qwen3/kv1", "seamless", "seamless/seq_sp_off",
              "seamless/q8", "mamba2", "mamba2/seq_sp_off", "mamba2/q8",
              "jamba", "jamba/q8", "jamba/aux"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_one_device(setup, world, case):
    key = case.split("/")[0]
    s = setup[key]
    want_loss, want = (s["loss"], s["grads"])
    if case.endswith("/q8"):
        want_loss, want, _ = s["q8_grads"]
    elif case.endswith("/kv1"):
        want_loss, want, _ = s["kv1"][2]
    elif case.endswith("/aux"):
        want_loss, want, _ = s["aux_grads"]
    for rank in world[f"grads/{case}"]:
        assert sorted(rank["grads"]) == sorted(want)
        name, err = _worst(rank["grads"], want)
        assert err <= GRAD_RTOL, (name, err)
        np.testing.assert_allclose(rank["loss"], want_loss, rtol=RTOL)
        _assert_near_ties(rank)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_miss_one_device(setup, world, fault):
    s = setup[FAULTS[fault][0]]
    want = s["aux_grads"][1] if fault in FAULT_KW else s["grads"]
    leaves = FAULT_LEAVES.get(fault)
    for rank in world[f"fault/{fault}"]:
        if leaves is None:
            name, err = _worst(rank["grads"], want)
            assert err >= FAULT_FACTOR * GRAD_RTOL, (fault, name, err)
            continue
        errs = {n: _rel(rank["grads"][n], g) for n, g in want.items()
                if n.endswith(leaves)}
        assert errs and min(errs.values()) >= FAULT_FACTOR * GRAD_RTOL, \
            (fault, errs)


def _assert_updates(got, want, init, routed=()):
    for n, p in want["params"].items():
        err = _rel(got["params"][n] - init[n], p - init[n])
        assert err <= UPDATE_RTOL, (n, err)
    moments = {n: m for n, m in want["moments"].items()
               if not any(k in n for k in routed)}
    name, err = _worst(got["moments"], moments)
    assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("key", TRAJECTORY_KEYS)
def test_steps_match_one_device(setup, world, key):
    s = setup[key]
    want = s["steps"]
    init = {n: p.float().numpy() for n, p in s["params"].items()}
    for rank in world[f"steps/{key}"]:
        np.testing.assert_allclose(rank["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=RTOL)
        _assert_updates(rank, want, init)
        _assert_near_ties(rank)


def test_hybrid_steps_match_one_device_step_by_step(setup, world):
    """The hybrid's 2 steps: the loss and grad norm of each within ``RTOL``
    of one device's 2 steps, and each step's update and first moment
    within ``UPDATE_RTOL`` / ``GRAD_RTOL`` of one device's step from the
    state the mesh's step started from (the ranks' states gathered,
    bitwise alike on every rank; one device fed the router choices the
    ranks were fed).  Held across both steps instead, the moments read
    0.096 (``A_log``): the flips of Adam's first update (the elements
    whose gradient is within rounding of zero) move this config's second
    gradient by up to 0.105 on one device alone, given the mesh's first
    update in place of its own."""
    s = setup["jamba"]
    want = s["steps"]
    ranks = world["steps/jamba"]
    first = ranks[0]["states"]
    assert len(first) == STEPS
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norms"], want["grad_norms"],
                                   rtol=RTOL)
        _assert_near_ties(rank)
        for got, ref in zip(rank["states"], first):
            for part in ("params", "moments", "second"):
                assert all(np.array_equal(got[part][n], ref[part][n])
                           for n in ref[part]), part
    cfg, params = s["tcfg"], s["params"]
    calls = len(want["routes"]) // STEPS
    init, state = {n: p.float().numpy() for n, p in params.items()}, None
    for k, got in enumerate(first):
        ref = cases.single_steps(
            cfg, params, s["batches"][k:k + 1], state=state,
            routes=want["routes"][k * calls:(k + 1) * calls])
        _assert_updates(got, ref, init)
        init = got["params"]
        params = {n: torch.from_numpy(got["params"][n]).to(p.dtype)
                  for n, p in params.items()}
        state = topt.OptState(
            torch.tensor(k + 1, dtype=torch.int32),
            *({n: torch.from_numpy(got[part][n]) for n in params}
              for part in ("moments", "second")))


@pytest.mark.parametrize("key", list(ARCHS))
def test_compressed_first_step_matches_one_device(setup, world, key):
    want = setup[key]["compressed"]
    for rank in world[f"compressed/{key}"]:
        np.testing.assert_allclose(rank["losses"][0], want["losses"][0],
                                   rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norms"][0],
                                   want["grad_norms"][0], rtol=RTOL)
        _assert_near_ties(rank)


def _reference_steps(s):
    """The JAX package's train cell on a 2 x 2 mesh, jitted with its
    shardings: each step's loss and grad norm, the params and first
    moments after."""
    jcfg, jp = s["jcfg"], s["jparams"]
    mesh = jmesh.make_mesh((2, 2), ("data", "model"),
                           devices=jax.devices()[:4])
    try:
        cell = jspecs.build_train_cell(jcfg, JShape("train_4k", S, B,
                                                    "train"), mesh)
        step = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                       out_shardings=cell.out_shardings)
        state = jopt.init_state(jopt.AdamWConfig(), jp)
        losses, norms = [], []
        with jax.set_mesh(mesh):
            p, st = jax.device_put((jp, state), cell.in_shardings[:2])
            for t, src in zip(s["toks"], s["srcs"] or [None] * STEPS):
                b = {"tokens": t}
                if src is not None:
                    b["src_embeds"] = jax.numpy.asarray(
                        src, jax.numpy.bfloat16)
                b = jax.device_put(b, cell.in_shardings[2])
                p, st, m = step(p, st, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        return losses, norms, dict(
            params={k: np.asarray(v, np.float32) for k, v in p.items()},
            moments={k: np.asarray(v, np.float32) for k, v in st.m.items()})
    finally:
        jspecs.clear_contexts()


@pytest.mark.parametrize("key", list(ARCHS))
def test_train_cell_matches_reference_cell(setup, world, key):
    s = setup[key]
    losses, norms, want = _reference_steps(s)
    init = {k: np.asarray(v, np.float32) for k, v in s["jparams"].items()}
    # both cells step with their package's default AdamW: the same one
    fields = lambda c: (dataclasses.asdict(c.schedule), c.b1, c.b2,  # noqa
                        c.eps, c.weight_decay, c.clip_norm)
    assert fields(topt.AdamWConfig()) == fields(jopt.AdamWConfig())
    for rank in world[f"cell/{key}"]:
        np.testing.assert_allclose(rank["losses"], losses, rtol=RTOL)
        np.testing.assert_allclose(rank["grad_norms"], norms, rtol=RTOL)
        _assert_updates(rank, want, init, ROUTED if s["tcfg"].moe else ())


def test_q8_gather_blocks_are_one_devices_bitwise(setup, world):
    _assert_q8_blocks(setup["qwen3"]["params"], world["q8"])


def test_encdec_q8_gather_blocks_are_one_devices_bitwise(setup, world):
    _assert_q8_blocks(setup["seamless"]["params"], world["q8/seamless"])


def test_ssm_q8_gather_blocks_are_one_devices_bitwise(setup, world):
    """The symbols of the re-blocked ``in_zx`` too, nibbles packed within
    each rank's ``[z_r | x_r]`` block at 4 bits."""
    _assert_q8_blocks(setup["mamba2"]["params"], world["q8/mamba2"])


def test_hybrid_q8_gather_blocks_are_one_devices_bitwise(setup, world):
    """The stacked Mamba positions' re-blocked ``in_zx`` among them."""
    _assert_q8_blocks(setup["jamba"]["params"], world["q8/jamba"])


def _assert_q8_blocks(params, ranks):
    from repro_torch.training import train_loop
    for i, bits in enumerate((8, 4)):
        want = train_loop.ste_quantize_params(params, bits)
        for rank in ranks:
            got = rank[i]
            assert got and sorted(got) == sorted(
                n for n, w in want.items() if hasattr(w, "master"))
            for n, parts in got.items():
                for k, v in parts.items():
                    w = getattr(want[n], k).numpy()
                    assert v.dtype == w.dtype and np.array_equal(v, w), \
                        (bits, n, k)


def _data_gathers(records):
    out = {}
    for r in records:
        if r["kind"] == "all-gather" and r["axis"] == "data":
            out[r["dtype"]] = out.get(r["dtype"], 0) + r["bytes"]
    return out


def test_q8_gather_moves_symbols_not_bf16(world):
    _assert_q8_gathers(world, "qwen3")


def test_encdec_q8_gather_moves_symbols_not_bf16(world):
    _assert_q8_gathers(world, "seamless")


def test_ssm_q8_gather_moves_symbols_not_bf16(world):
    _assert_q8_gathers(world, "mamba2")


def test_hybrid_q8_gather_moves_symbols_not_bf16(world):
    _assert_q8_gathers(world, "jamba")


def _assert_q8_gathers(world, key):
    for bf, q8, q4 in zip(world[f"grads/{key}/bf16"],
                          world[f"grads/{key}/q8"],
                          world[f"grads/{key}/q8_4"]):
        whole = _data_gathers(bf["records"])
        g8, g4 = _data_gathers(q8["records"]), _data_gathers(q4["records"])
        # the f32 leaves q8_gather leaves whole (the hybrid's router) are
        # gathered alike in every run
        f32 = whole.pop("float32", 0)
        for g in (g8, g4):
            g["float32"] = g.get("float32", 0) - f32
            if not g["float32"]:
                del g["float32"]
        assert set(whole) == {"bfloat16"}, whole
        kinds = {"uint8", "float32"} if Q8_KEYS[key] else {"uint8"}
        assert set(g8) == set(g4) == kinds, (g8, g4)
        assert 2 * g8["uint8"] == whole["bfloat16"]
        assert 4 * g4["uint8"] == whole["bfloat16"]
        # the scales gathered are f32 per-row ones (lm_head's rows split
        # over data): a row of four bytes each
        if Q8_KEYS[key]:
            assert g8["float32"] == g4["float32"] \
                <= whole["bfloat16"] // 64


def test_grad_compress_blocks_are_one_devices_bitwise(world):
    for i, (full, spec) in enumerate(world["leaves"]):
        want = grad_compress.compress_decompress(
            {"g": torch.from_numpy(full)})["g"].numpy()
        for rank in world["compress"]:
            got, gathers = rank[i]
            assert gathers == 0, (spec, gathers)
            assert np.array_equal(got, want), (full.shape, spec)


def test_ssm_train_state_gathers_back_bitwise(setup, world):
    """``shard_train_state`` then ``gather_params`` is the identity on every
    leaf, ``in_zx`` (re-blocked at rest, put back) included."""
    _assert_roundtrip(setup, world, "mamba2")


def test_hybrid_train_state_gathers_back_bitwise(setup, world):
    """The stacked ``periods/pos*/in_zx`` (re-blocked along their last dim,
    the leading period dim kept) included."""
    assert any(n.endswith("/in_zx") for n in setup["jamba"]["params"])
    _assert_roundtrip(setup, world, "jamba")


def _assert_roundtrip(setup, world, key):
    params = setup[key]["params"]
    for rank in world[f"roundtrip/{key}"]:
        assert sorted(rank) == sorted(params)
        for n, p in params.items():
            want = (p.view(torch.int16) if p.dtype == torch.bfloat16
                    else p).numpy()
            assert rank[n].dtype == want.dtype and \
                np.array_equal(rank[n], want), n


def test_ssm_grad_compress_tree_is_one_devices_bitwise(setup, world):
    """``train_loop.compress_blocks`` of mamba2's gradient blocks, the
    re-blocked ``in_zx``'s among them, gathered: bitwise the single-device
    ``compress_decompress`` of the whole gradients, with no all-gather."""
    _assert_compress_tree(setup, world, "mamba2")


def test_hybrid_grad_compress_tree_is_one_devices_bitwise(setup, world):
    _assert_compress_tree(setup, world, "jamba")


def _assert_compress_tree(setup, world, key):
    grads = setup[key]["grads"]
    want = grad_compress.compress_decompress(
        {n: torch.from_numpy(g) for n, g in grads.items()})
    for got, gathers in world[f"compress_tree/{key}"]:
        assert gathers == 0
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            assert np.array_equal(got[n], w.numpy()), n


def test_straddling_blocks_are_found(world):
    """The cases hold blocks that straddle ranks: the all-reduce path is
    exercised, not only the aligned one."""
    from repro_torch.distributed.grad_compress import _straddling
    mesh = (("data", 2), ("model", 2))
    counts = [len(_straddling(shape, spec, mesh)) for shape, spec in COMPRESS]
    assert counts[0] == 0 and min(counts[1:]) > 0, counts
    assert math.prod((2, 4, 130)) % 256 != 0       # a padded last block


@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_every_family_trains_sharded(arch):
    """Every config of the registry trains under the reference's train-cell
    hints (``specs.train_contexts``; the MoE and hybrid families with their
    EP context), and its train cell says so."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as lmesh, specs
    cfg = treg.get(arch)
    assert cfg.family in specs.SHARDED_TRAIN_FAMILIES
    with lmesh.fake_world(4):
        mesh = lmesh.make_mesh((2, 2), ("data", "model"))
        hints, ep = specs.train_contexts(cfg, mesh)
        assert hints is not None and not hints.exact_tp
        assert tuple(hints.batch_axes) == ("data",)
        assert hints.seq_sp == (cfg.family != "hybrid")
        assert (ep is not None) == (cfg.moe is not None)
        cell = specs.build_train_cell(
            cfg, ShapeConfig("train_4k", S, B, "train"), mesh)
        assert cell.meta["compute"] == "sharded", cell.meta


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssm_exact_tp_refused_on_mesh(arch):
    """An SSM's train layout (the hybrid's Mamba positions' too) rests
    ``in_zx`` re-blocked for sharded compute, which exact TP's whole-weight
    gathers would read in the wrong column order: the mesh step refuses
    exact TP for it."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.training import train_loop
    cfg = _cfgs(arch)[1]
    with lmesh.fake_world(4):
        mesh = lmesh.make_mesh((2, 2), ("data", "model"))
        specs = train_loop.train_shardings(cfg, mesh)
        names = [n for n in specs if n.endswith("/in_zx")]
        assert names and all(train_loop.zx_split(cfg, n, specs[n], mesh) == 2
                             for n in names)
        with pytest.raises(NotImplementedError, match="in_zx"):
            train_loop.make_mesh_grad_fn(cfg, cases.train_config(), mesh)
