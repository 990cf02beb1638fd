"""The port's roofline arithmetic (``repro_torch.launch.roofline``) and cell
bookkeeping (``launch.specs``) against the JAX package's: model FLOPs,
cache bytes and the analytic HBM bytes on every ``all_cells`` entry,
``pick_microbatches`` on the production meshes, ``all_cells`` and the
dry-run's ``--list``, and the ring pricing of collectives against the
reference's ``collective_wire_bytes`` on an HLO text written with the same
collectives.  Pure arithmetic: no process group, no model run."""
import pytest

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun, roofline, specs


class FakeMesh:
    """Duck-typed mesh exposing .shape only."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}
CELLS = [(a, s) for a, s, ok in jspecs.all_cells(jreg.ARCHS)]


def _meta(arch, shape, mesh):
    kind = SHAPES[shape].kind
    if kind == "train":
        cfg = treg.get(arch)
        return {"kind": "train",
                "microbatches": specs.pick_microbatches(
                    cfg, SHAPES[shape], mesh),
                "q8_opt": cfg.param_count() >= specs.Q8_OPT_THRESHOLD,
                "weights": "bf16"}
    if kind == "prefill":
        return {"kind": "prefill", "weights": "int8"}
    return {"kind": "decode", "weights": "int8", "kv_bits": 16}


def test_all_cells_equal_the_reference():
    assert specs.all_cells(treg.ARCHS) == jspecs.all_cells(jreg.ARCHS)
    assert len(CELLS) == 40


def test_list_equals_the_reference(capsys):
    assert dryrun.main(["--list"]) == 0
    want = "".join(
        f"{a:24s} {s:12s} {'ok' if ok else 'SKIP (full attention @500k)'}\n"
        for a, s, ok in jspecs.all_cells(jreg.ARCHS))
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pick_microbatches_equals_the_reference(mesh):
    m = MESHES[mesh]
    for a, s in CELLS:
        assert specs.pick_microbatches(treg.get(a), SHAPES[s], m) \
            == jspecs.pick_microbatches(jreg.get(a), JSHAPES[s], m), (a, s)


def test_model_flops_and_cache_bytes_equal_the_reference():
    for a, s in CELLS:
        tc, jc = treg.get(a), jreg.get(a)
        sh, jsh = SHAPES[s], JSHAPES[s]
        assert roofline.model_flops(tc, sh, sh.kind) \
            == jroof.model_flops(jc, jsh, jsh.kind), (a, s)
        for kvb in (2.0, 1.0 + 2.0 / (tc.hd if tc.n_heads else 64)):
            assert roofline._cache_bytes(tc, sh.global_batch, sh.seq_len,
                                         kvb) \
                == jroof._cache_bytes(jc, jsh.global_batch, jsh.seq_len,
                                      kvb), (a, s, kvb)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_analytic_hbm_bytes_equal_the_reference(mesh):
    m = MESHES[mesh]
    chips = 1
    for n in m.shape.values():
        chips *= n
    for a, s in CELLS:
        meta = _meta(a, s, m)
        got = roofline.analytic_hbm_bytes(treg.get(a), SHAPES[s], meta,
                                          chips)
        want = jroof.analytic_hbm_bytes(jreg.get(a), JSHAPES[s], meta, chips)
        assert got == want, (a, s)


# one line a collective as XLA prints them: (kind, output shape, group)
HLO_COLLECTIVES = [
    ("all-gather", "bf16[16,128]", 16),
    ("all-gather", "f32[8,4,64]", 8),
    ("all-reduce", "f32[1024]", 16),
    ("all-reduce", "bf16[2,2048]", 2),
    ("reduce-scatter", "bf16[64,32]", 16),
    ("all-to-all", "bf16[16,512]", 16),
    ("collective-permute", "f32[300]", 2),
]
_BYTES = {"bf16": 2, "f32": 4}


def _hlo_and_records():
    lines, records = [], []
    for i, (kind, shape, n) in enumerate(HLO_COLLECTIVES):
        groups = "{{" + ",".join(str(r) for r in range(n)) + "}}"
        lines.append(f"  %c{i} = {shape}{{0}} {kind}({shape}{{0}} %p{i}), "
                     f"replica_groups={groups}, dimensions={{0}}")
        dtype, dims = shape.rstrip("]").split("[")
        nbytes = _BYTES[dtype]
        for d in dims.split(","):
            nbytes *= int(d)
        records.append({"kind": kind, "bytes": nbytes, "group": n,
                        "intra_node": n <= 8})
    return "\n".join(lines), records


def test_ring_pricing_equals_collective_wire_bytes():
    hlo, records = _hlo_and_records()
    want = jroof.collective_wire_bytes(hlo, 256)
    got = roofline.collective_detail(records)
    for kind in roofline.KINDS:
        assert got[kind] == pytest.approx(want[kind], rel=1e-12), kind
    assert got["counts"] == want["counts"]
    assert got["nvlink_bytes"] + got["ib_bytes"] \
        == pytest.approx(sum(want[k] for k in roofline.KINDS), rel=1e-12)


def test_collective_term_prices_nvlink_and_infiniband():
    from repro_torch.launch import mesh as hw
    recs = [{"kind": "all-gather", "bytes": 16e6, "group": 8,
             "intra_node": True},
            {"kind": "all-reduce", "bytes": 8e6, "group": 16,
             "intra_node": False}]
    d = roofline.collective_detail(recs)
    r = roofline.Roofline(
        arch="a", shape="s", mesh="16x16", kind="decode", chips=256,
        flops_per_chip=0.0, raw_bytes_per_chip=0.0,
        analytic_bytes_per_chip=0.0, wire_bytes_per_chip=0.0,
        collective_detail=d, memory_analysis={}, meta={}, model_flops=0.0)
    want = 16e6 * 7 / 8 / hw.NVLINK_BW + 8e6 * 2 * 15 / 16 / hw.IB_BW
    assert r.collective_s == pytest.approx(want, rel=1e-12)
    assert r.dominant == "collective"
