"""The port's production dry-run (``repro_torch.launch.dryrun`` over
``launch.specs`` and ``launch.mesh``'s fake world) and the query-block
attention it needs, against the JAX package:

* per-rank argument bytes of reduced cells (decode, prefill, train on a
  2 x 2 mesh) and of a production decode cell (16 x 16) equal the sum of
  the shard shapes the reference's ``resolve_spec`` gives on a stand-in
  mesh: the weights by the reference's rules, the cache where the port's
  placement and the reference's coincide (whole KV heads over model);
* the FLOPs counted for a reduced 1 x 1 prefill cell equal the closed form
  2·B·S·(layer matmul params) + 2·B·D·V (``lm_head``, last position) +
  4·B·H·S·T·hd, and its query blocks keep the peak below one layer's
  whole score tensor;
* ``gqa_attention(q_block=b)`` equals the reference's with the same
  ``q_block``: bitwise where the score sums are exact in float32, within
  the attention tolerance of ``tests/test_torch_dense.py`` (``ATOL``)
  otherwise; prefill logits with ``q_block`` give the reference's greedy
  tokens up to near-ties; ``loss_fn`` takes ``q_block`` in every family;
* the dry-run leaves no process group behind, ``--out`` resumes, the
  multi-pod pass proves memory, the kernel wrappers raise on ``meta``
  tensors, and ``mesh.make_host_mesh`` defaults to the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models import api as japi
from repro.models import layers as jl
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers

ATOL = 2e-2                  # tests/test_torch_dense.py's attention limit
NEAR_TIE_STEPS = 2


class FakeMesh:
    """Duck-typed mesh exposing .shape only."""

    def __init__(self, **shape):
        self.shape = shape


def _local(shape, spec, fm) -> int:
    """Elements of this rank's block of ``shape`` cut by ``spec``."""
    n = 1
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for d, e in zip(shape, entries):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= d // math.prod(fm.shape[a] for a in axes)
    return n


def _ref_param_bytes(jcfg, fm, rules, weights):
    total = 0
    for name, s in japi.build(jcfg).schema(jcfg).items():
        spec = jshd.resolve_spec(s.axes, s.shape, rules, fm)
        if weights == "bf16" or not jspecs._quantize_pred(name, s.shape):
            total += _local(s.shape, spec, fm) * np.dtype(s.dtype).itemsize
        else:
            # uint8 symbols + the per-layer float32 scale and zero
            total += _local(s.shape, spec, fm) + 2 * 4 * s.shape[0]
    return total


def _serve_rules(jcfg, fm):
    rules, _ = jspecs._serve_rules(jcfg, fm, long_context=False)
    return jshd.arch_rules(jcfg, fm, rules)


def _ref_decode_args(jcfg, fm, B, S):
    rules = _serve_rules(jcfg, fm)
    mod = japi.build(jcfg)
    shapes = jax.eval_shape(lambda: mod.init_cache(jcfg, B, S))
    cache = sum(_local(v.shape, jshd.resolve_spec(
        mod.cache_specs(jcfg)[k], v.shape, rules, fm), fm)
        * np.dtype(v.dtype).itemsize for k, v in shapes.items())
    token = _local((B, 1), jshd.resolve_spec(("batch", None), (B, 1), rules,
                                             fm), fm) * 4
    return _ref_param_bytes(jcfg, fm, rules, "int8") + cache + token


def _ref_prefill_args(jcfg, fm, B, S):
    rules = _serve_rules(jcfg, fm)
    prompt = _local((B, S), jshd.resolve_spec(("batch", None), (B, S), rules,
                                              fm), fm) * 4
    return _ref_param_bytes(jcfg, fm, rules, "int8") + prompt


def _ref_train_args(jcfg, fm, B, S):
    rules = jshd.arch_rules(jcfg, fm, jshd.train_rules(fm))
    orules = jshd.arch_rules(jcfg, fm, jshd.opt_state_rules(fm))
    moments = 0
    for s in japi.build(jcfg).schema(jcfg).values():
        spec = jshd.resolve_spec(s.axes, s.shape, orules, fm)
        moments += 2 * 4 * _local(s.shape, spec, fm)      # m, v in float32
    tokens = _local((B, S + 1), jshd.resolve_spec(
        ("batch", None), (B, S + 1), rules, fm), fm) * 4
    return (_ref_param_bytes(jcfg, fm, rules, "bf16") + moments + 4
            + tokens)


REDUCED = [("decode_32k", _ref_decode_args), ("prefill_32k",
                                               _ref_prefill_args),
           ("train_4k", _ref_train_args)]


@pytest.mark.parametrize("shape,ref", REDUCED, ids=[r[0] for r in REDUCED])
def test_reduced_cell_args_equal_reference_shards(shape, ref):
    """Reduced qwen3 on 2 x 2: its 2 KV heads divide the model axis, so the
    port's cache placement is the reference's."""
    B = 4
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    d = dryrun.run_cell("qwen3-1.7b", shape, cfg=tcfg, mesh_shape=(2, 2),
                        batch=B, verbose=False)
    S = {"decode_32k": 32768, "prefill_32k": 32768, "train_4k": 4096}[shape]
    want = ref(jcfg, FakeMesh(data=2, model=2), B, S)
    assert d["memory_analysis"]["argument_size"] == want
    assert d["memory_analysis"]["peak"] >= want
    assert not dist.is_initialized()           # the fake world is gone


def test_production_decode_cell():
    """qwen3-1.7b x decode_32k on 16 x 16: args are the reference's weight
    and cache shards — 8 KV heads do not divide 16, so the cache's sequence
    rests split over model, as the reference's ``_serve_rules`` place it."""
    jcfg = jreg.get("qwen3-1.7b")
    fm = FakeMesh(data=16, model=16)
    d = dryrun.run_cell("qwen3-1.7b", "decode_32k", verbose=False)
    rules = _serve_rules(jcfg, fm)
    B, S = 128, 32768
    cache = 2 * jcfg.n_layers * (B // 16) * (S // 16) * jcfg.n_kv_heads \
        * jcfg.hd * 2
    token = (B // 16) * 4
    want = _ref_param_bytes(jcfg, fm, rules, "int8") + cache + token
    assert d["memory_analysis"]["argument_size"] == want
    assert want == _ref_decode_args(jcfg, fm, B, S)
    assert d["meta"]["kv_seq_reference"] == "model"
    assert d["meta"]["kv_port"] == "model"
    assert d["meta"]["kv_port_spec"] == "-,data,model,-,-"
    from repro.launch import roofline as jroof
    keys = set(jroof.Roofline(
        arch="qwen3-1.7b", shape="decode_32k", mesh="16x16", kind="decode",
        chips=256, flops_per_chip=1.0, raw_bytes_per_chip=0.0,
        analytic_bytes_per_chip=0.0, wire_bytes_per_chip=0.0,
        collective_detail={}, memory_analysis={}, meta={}).to_dict())
    assert keys | {"fits", "run_s"} == set(d)
    assert d["fits"] and d["dominant"] == "collective"
    assert d["collective_detail"]["counts"]["all-gather"] > 0
    # sharded compute: the ranks of a model group split the work (exact TP
    # repeated it: 0.0196); attention over 32k, which model_flops leaves
    # out, keeps the ratio below 1
    assert 0.2 < d["flops_ratio"] < 1.0
    assert d["meta"]["sharded_compute"]
    assert not dist.is_initialized()


SERVING = [(a, s) for a, cfg in treg.ARCHS.items()
           if cfg.family in ("dense", "moe")
           for s in ("prefill_32k", "decode_32k")]


def test_kv_port_equals_reference_in_every_dense_and_moe_serving_cell():
    """Every dense and MoE serving cell of ``all_cells`` places its cache's
    sequence where the reference's ``_serve_rules`` do (cells built on the
    production mesh, not run)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import specs
    assert {(a, s) for a, s, ok in specs.all_cells(treg.ARCHS) if ok
            and treg.get(a).family in ("dense", "moe")
            and s in ("prefill_32k", "decode_32k")} == set(SERVING)
    with tmesh.fake_world(256):
        mesh = tmesh.make_production_mesh()
        for a, s in SERVING:
            cell = specs.build_cell(treg.get(a), SHAPES[s], mesh)
            assert cell.meta["sharded_compute"], (a, s)
            assert cell.meta["kv_port"] == cell.meta["kv_seq_reference"], \
                (a, s, cell.meta)
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_stationary_cell_builds_counts_and_gathers_no_weight(arch,
                                                            monkeypatch):
    """``serve_mode="stationary"`` on 2 x 2: its args are the reference's
    stationary weight shards (the experts' hidden dim over data) and
    cache; it runs with no weight block gathered (every rest block stays
    where it is) and sums partial dots over data instead."""
    import dataclasses
    from repro_torch.distributed.ctx import Sharded
    from repro_torch.models import layers
    tcfg = treg.reduced(treg.get(arch))
    jcfg = jreg.reduced(jreg.get(arch))
    real = layers._gather_blocks

    def no_gather(p, mesh, keep):
        out = real(p, mesh, keep)
        assert not isinstance(p, Sharded) or (
            isinstance(out, Sharded) and out.spec == p.spec), p
        return out
    monkeypatch.setattr(layers, "_gather_blocks", no_gather)
    B = 4
    d = dryrun.run_cell(arch, "decode_32k", cfg=tcfg, mesh_shape=(2, 2),
                        batch=B, serve_mode="stationary", verbose=False)
    assert d["meta"]["serve_mode"] == "stationary" and d["fits"]
    cd = d["collective_detail"]
    assert cd["counts"]["all-reduce"] > 0 and d["flops_per_chip"] > 0
    fm = FakeMesh(data=2, model=2)
    rules = _serve_rules(jcfg, fm)
    rules = jshd.Rules({**rules.table, "expert_embed": None,
                        "expert_mlp": ("data",)})
    mod = japi.build(jcfg)
    shapes = jax.eval_shape(lambda: mod.init_cache(jcfg, B, 32768))
    cache = sum(_local(v.shape, jshd.resolve_spec(
        mod.cache_specs(jcfg)[k], v.shape, rules, fm), fm)
        * np.dtype(v.dtype).itemsize for k, v in shapes.items())
    want = _ref_param_bytes(jcfg, fm, rules, "int8") + cache + B * 4
    assert d["memory_analysis"]["argument_size"] == want
    assert not dist.is_initialized()


def test_reduce_scatter_is_recorded_and_priced_as_the_reference_ring():
    """``collectives.reduce_scatter`` on the fake backend: recorded with
    its output and input bytes, priced as the reference prices an HLO
    reduce-scatter of the same output shape (output x (n - 1))."""
    from repro.launch import roofline as jroof
    from repro_torch.distributed import collectives
    from repro_torch.launch import roofline
    with tmesh.fake_world(16):
        mesh = tmesh.make_mesh((1, 16), ("data", "model"))
        t = torch.empty((4, 256, 32), dtype=torch.bfloat16, device="meta")
        with collectives.recording() as recs:
            out = collectives.reduce_scatter(mesh, t, 1, "model")
    assert tuple(out.shape) == (4, 16, 32)
    (r,) = recs
    assert r["kind"] == "reduce-scatter" and r["group"] == 16
    assert r["bytes"] == 4 * 16 * 32 * 2 and r["in_bytes"] == 4 * 256 * 32 * 2
    hlo = ("  %c0 = bf16[4,16,32]{2,1,0} reduce-scatter(bf16[4,256,32]{2,1,0}"
           " %p0), replica_groups={{" + ",".join(map(str, range(16)))
           + "}}, dimensions={1}")
    want = jroof.collective_wire_bytes(hlo, 256)["reduce-scatter"]
    got = roofline.collective_detail(recs)
    assert got["reduce-scatter"] == pytest.approx(want, rel=1e-12)
    assert want == 4 * 16 * 32 * 2 * 15
    assert not dist.is_initialized()


def test_command_r_like_cache_is_split_sixteen_ways():
    """A reduced command-r-plus-104b with its 8 KV heads on a model axis of
    16: the cache's sequence rests split over model, so a rank holds
    ``cache_bytes / 16`` of it (the reference's placement), not every head
    of every position."""
    import dataclasses
    from repro_torch.launch import roofline
    over = dict(n_heads=16, n_kv_heads=8, head_dim=16)
    tcfg = dataclasses.replace(treg.reduced(treg.get("command-r-plus-104b")),
                               **over)
    jcfg = dataclasses.replace(jreg.reduced(jreg.get("command-r-plus-104b")),
                               **over)
    B, S = 1, 32768
    d = dryrun.run_cell("command-r-plus-104b", "decode_32k", cfg=tcfg,
                        mesh_shape=(1, 16), batch=B, verbose=False)
    fm = FakeMesh(data=1, model=16)
    assert d["meta"]["kv_port"] == d["meta"]["kv_seq_reference"] == "model"
    params = _ref_param_bytes(jcfg, fm, _serve_rules(jcfg, fm), "int8")
    cache = d["memory_analysis"]["argument_size"] - params - B * 4
    assert cache * 16 == roofline._cache_bytes(tcfg, B, S)
    assert d["memory_analysis"]["argument_size"] == \
        _ref_decode_args(jcfg, fm, B, S)
    assert not dist.is_initialized()


def test_reduced_prefill_flops_equal_the_closed_form():
    cfg = treg.reduced(treg.get("qwen3-1.7b"))
    B, S = 1, 32768
    d = dryrun.run_cell("qwen3-1.7b", "prefill_32k", cfg=cfg,
                        mesh_shape=(1, 1), batch=B, verbose=False)
    D, H, KV, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    layer = D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    want = (2 * B * S * layer * cfg.n_layers
            + 2 * B * D * cfg.padded_vocab()
            + 4 * B * H * S * S * hd * cfg.n_layers)
    assert d["flops_per_chip"] == want
    assert d["meta"]["q_block"] == 1024
    # the query blocks: the peak stays below one layer's whole scores
    assert d["memory_analysis"]["peak"] < B * H * S * S * 4
    assert d["collective_detail"]["counts"] == {
        k: 0 for k in d["collective_detail"]["counts"]}


def test_multi_pod_proves_memory_and_out_resumes(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    argv = ["--arch", "mamba2-370m", "--shape", "decode_32k", "--multi-pod",
            "--out", out]
    assert dryrun.main(argv) == 0
    assert dryrun.main(argv) == 0
    text = capsys.readouterr().out
    assert "1/1 newly-run cells OK" in text and "0/0 newly-run" in text
    import json
    with open(out) as f:
        (d,) = json.load(f)
    assert d["mesh"] == "2x16x16" and d["compile_only"] and d["fits"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------- q_block

@pytest.mark.parametrize("S,q_block,KV,causal", [(32, 8, 2, True),
                                                 (32, 16, 4, False)])
def test_q_block_attention_bitwise_when_sums_are_exact(S, q_block, KV,
                                                       causal):
    """The inputs of ``test_torch_dense``'s bitwise attention test (every
    score sum exact in float32), through both packages' query blocks."""
    B, H, hd = 2, 4, 128
    rng = np.random.default_rng(S + q_block)
    q = (rng.choice([-1.0, 1.0], (B, S, H, hd))
         * (1 + rng.integers(0, 128, (B, S, H, hd)) / 128))
    k = rng.integers(-1, 2, (B, S, KV, hd)) * (rng.random((B, S, KV, hd))
                                               < 0.125)
    v = rng.integers(-2, 3, (B, S, KV, hd))
    tq, tk, tv = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (q, k, v))
    got = tlayers.gqa_attention(tq, tk, tv, causal=causal, q_block=q_block)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = jl.gqa_attention(jb(q), jb(k), jb(v), causal=causal,
                            q_block=q_block)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # and the blocks compute what one block does
    one = tlayers.gqa_attention(tq, tk, tv, causal=causal)
    assert torch.equal(got, one)


def test_q_block_attention_random_within_tolerance():
    B, S, H, KV, hd, qb = 2, 64, 4, 2, 32, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 1, (B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = tlayers.gqa_attention(t(q), t(k), t(v), causal=True, q_block=qb)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = jl.gqa_attention(jb(q), jb(k), jb(v), causal=True, q_block=qb)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=0)


def test_prefill_with_q_block_greedy_equals_reference():
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16))
    jlog, _ = japi.build(jcfg).prefill(jcfg, jp, jnp.asarray(prompt),
                                       max_len=24, q_block=4)
    with torch.no_grad():
        tlog, cache = tapi.build(tcfg).prefill(
            tcfg, tp, torch.from_numpy(prompt), max_len=24, q_block=4)
        whole, _ = tapi.build(tcfg).prefill(tcfg, tp,
                                            torch.from_numpy(prompt),
                                            max_len=24)
    assert torch.equal(tlog, whole)
    t = tlog.float().numpy()[:, -1]
    j = np.asarray(jlog, np.float32)[:, -1]
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)
    for r in range(j.shape[0]):
        best = float(j[r].max())
        gap = best - float(j[r, t[r].argmax()])
        assert gap <= NEAR_TIE_STEPS * 2.0 ** (math.frexp(best)[1] - 8), r


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b",
                                  "mamba2-370m", "jamba-1.5-large-398b",
                                  "seamless-m4t-medium"])
def test_loss_takes_q_block_in_every_family(arch):
    """The loss with query blocks equals the loss without, in every family
    (each block's softmax is exact over all of T)."""
    cfg = treg.reduced(treg.get(arch))
    mod = tapi.build(cfg)
    params = mod.init(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 17)).astype(np.int64))}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32)
        ).to(torch.bfloat16)
    with torch.no_grad():
        a = mod.loss_fn(cfg, params, batch, remat=False, q_block=4)
        b = mod.loss_fn(cfg, params, batch, remat=False)
    assert torch.isfinite(a)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- plumbing

def test_kernel_wrappers_raise_on_meta_tensors():
    from repro_torch.kernels import ops
    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    wq = torch.empty((64, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.dequant_matmul(x, wq, 0.01, 0.0)


def test_make_host_mesh_defaults_to_the_card():
    with tmesh.fake_world(1):
        m = tmesh.make_host_mesh(device="cpu")
        assert m.device == torch.device("cpu")
        if torch.cuda.is_available():
            assert tmesh.make_host_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tmesh.make_host_mesh()
    assert not dist.is_initialized()
