"""The port's static analysis (``src/repro_torch/analysis/``) against the
JAX package's (``src/repro/analysis/``), and each rule on planted faults.

Counterparts of ``tests/test_static_analysis.py``, test for test: the
``Finding`` / ``Baseline`` surface behaves as the reference's on the same
findings; the lock checker and the emit collector give the reference's
findings on the same source strings and trees; each rule flags a planted
fault and stays silent on compliant code; the twin contracts hold on the
repo's dense and MoE models and fail on a perturbed twin.  Only the
reference's pure-AST modules are imported (no JAX trace runs here).
CPU only, a few seconds serial.
"""
import ast
import io
import json
import textwrap
from contextlib import redirect_stderr, redirect_stdout

import pytest

from repro.analysis import base as jbase
from repro.analysis import catalog as jcat
from repro.analysis import locks as jlocks
from repro_torch.analysis import base
from repro_torch.analysis import catalog as cat
from repro_torch.analysis import dtypes
from repro_torch.analysis import jit_boundary as jb
from repro_torch.analysis import locks
from repro_torch.analysis import twins
from repro_torch.analysis.__main__ import main as analysis_main


def _both(cls_name, **kw):
    return getattr(base, cls_name)(**kw), getattr(jbase, cls_name)(**kw)


# ------------------------------------------------------------ base/baseline

def test_finding_render_and_fingerprint_stability():
    f = base.Finding(file="src/a.py", line=42, rule="dtype-discipline",
                     message="affine in bf16 at row 17", symbol="deq")
    assert f.render() == "src/a.py:42 dtype-discipline affine in bf16 at row 17"
    g = base.Finding(file="src/a.py", line=99, rule="dtype-discipline",
                     message="affine in bf16 at row 23", symbol="deq")
    assert f.fingerprint() == g.fingerprint()
    h = base.Finding(file="src/b.py", line=42, rule="dtype-discipline",
                     message="affine in bf16 at row 17", symbol="deq")
    assert f.fingerprint() != h.fingerprint()
    # the reference's Finding renders, fingerprints and serializes alike
    for kw in (dict(file="src/a.py", line=42, rule="r", message="m 17 x3",
                    symbol="deq"),
               dict(file="b.py", line=0, rule="lock-discipline",
                    message="write to self.a")):
        mine, ref = _both("Finding", **kw)
        assert (mine.render(), mine.fingerprint(), mine.to_json()) \
            == (ref.render(), ref.fingerprint(), ref.to_json())


def test_baseline_roundtrip_and_split(tmp_path):
    f1 = base.Finding(file="a.py", line=1, rule="r", message="one")
    f2 = base.Finding(file="b.py", line=2, rule="r", message="two")
    b = base.Baseline()
    assert b.absorb([f1]) == 1 and b.absorb([f1]) == 0
    path = tmp_path / "baseline.json"
    b.save(path)
    b2 = base.Baseline.load(path)
    assert b2.entries.keys() == b.entries.keys()
    new, accepted, stale = b2.split([f1, f2])
    assert [x.message for x in new] == ["two"]
    assert [x.message for x in accepted] == ["one"]
    assert stale == []
    new, accepted, stale = b2.split([f2])
    assert stale == [f1.fingerprint()]
    # one file format: the reference loads it and splits alike
    ref = jbase.Baseline.load(path)
    assert ref.entries == b2.entries
    j1, j2 = (jbase.Finding(**x.to_json()) for x in (f1, f2))
    got = ref.split([j1, j2])
    assert [[x.to_json() for x in got[0]], [x.to_json() for x in got[1]],
            got[2]] == [[f2.to_json()], [f1.to_json()], []]


def test_baseline_missing_file_is_empty(tmp_path):
    assert base.Baseline.load(tmp_path / "nope.json").entries == {}


def test_checker_registry_resolves():
    for name in base.CHECKERS:
        assert callable(base.resolve(name))
    # the reference's rules, with jit-host-boundary as host-boundary, plus
    # the port's kernel-wrapper rule
    want = (set(jbase.CHECKERS) - {"jit-host-boundary"}) \
        | {"host-boundary", "kernel-wrapper"}
    assert set(base.CHECKERS) == want
    assert base.REPO_ROOT == jbase.REPO_ROOT


# -------------------------------------------------------------------- dtype

BF16_AFFINES = {
    "to": """
        def deq(q, scale, zero):
            qf = q.to(torch.bfloat16)
            return qf * scale + zero
    """,
    "alias": """
        def deq(q, scale, zero):
            bf = torch.bfloat16
            return q.to(bf) * scale.to(bf) + zero.to(bf)
    """,
    "module-alias": """
        bf = torch.bfloat16
        def deq(q, scale, zero):
            return q.to(dtype=bf) * scale + zero
    """,
    "method": """
        class D:
            def deq(self, q, scale, zero):
                return q.bfloat16() * scale + zero
    """,
}


@pytest.mark.parametrize("case", sorted(BF16_AFFINES))
def test_dtype_checker_flags_bf16_affine(case):
    got = dtypes.check_source(textwrap.dedent(BF16_AFFINES[case]), "fix.py")
    assert len(got) == 1 and got[0].rule == "dtype-discipline"
    assert "bfloat16" in got[0].message
    assert got[0].symbol == ("D.deq" if case == "method" else "deq")


DYNAMIC_AFFINES = {
    "x.dtype": """
        def deq(q, scale, zero, x):
            dt = x.dtype
            qf = q.to(dt)
            return qf * scale + zero
    """,
    "defaultless dtype": """
        def deq(w, dtype):
            return w.q.to(dtype) * w.scale.to(dtype) + w.zero.to(dtype)
    """,
    "type": """
        def deq(q, scale, zero, x):
            return q.type(x.dtype) * scale + zero
    """,
}


@pytest.mark.parametrize("case", sorted(DYNAMIC_AFFINES))
def test_dtype_checker_flags_dynamic_dtype_affine(case):
    got = dtypes.check_source(textwrap.dedent(DYNAMIC_AFFINES[case]),
                              "fix.py")
    assert len(got) == 1 and "dynamic" in got[0].message


def test_dtype_checker_silent_on_f32_affine():
    src = textwrap.dedent("""
        def deq(q, scale, zero, dtype=torch.float32):
            qf = q.to(torch.float32)
            out = qf * scale.float() + zero.to(dtype=torch.float32)
            return out.to(torch.bfloat16)   # cast AFTER the affine is fine
        def deq2(q, scale, zero, dtype):
            w = q.float() * scale.float() + zero.float()
            return w.to(dtype)
    """)
    assert dtypes.check_source(src, "fix.py") == []


def test_dtype_checker_silent_on_unresolvable():
    # unknown factor dtypes are not guessed at; a `dtype` with a default
    # that is no dtype resolves to nothing either
    src = ("def f(a, b, c):\n    return a * b + c\n"
           "def g(a, b, c, dtype=None):\n    return a.to(dtype) * b + c\n")
    assert dtypes.check_source(src, "fix.py") == []


# the port counterpart of each Python site the reference baselines
DTYPE_COUNTERPARTS = {
    ("_deq_plain", "dynamic"): "deq",
    ("_lookup", "bfloat16"): "take_rows",
    ("kv_dequantize", "bfloat16"): "kv_dequantize",
    ("_SteDeq.forward", "bfloat16"): "_ste_deq",
    ("rope", "dynamic"): "rope",
}


def test_dtype_checker_finds_reference_counterparts():
    got = dtypes.check(base.REPO_ROOT)
    found = {(f.symbol, "dynamic" if "dynamic" in f.message else "bfloat16")
             for f in got}
    assert set(DTYPE_COUNTERPARTS) <= found
    assert all(f.file == "src/repro_torch/models/layers.py" for f in got)
    ref = json.loads((base.REPO_ROOT / "scripts" /
                      "static_baseline.json").read_text())
    ref_syms = {e["fingerprint"].split("::")[2] for e in ref["entries"]
                if "/models/" in e["fingerprint"]}
    assert set(DTYPE_COUNTERPARTS.values()) == ref_syms
    # each one is baselined with its reason
    entries = base.Baseline.load(
        base.REPO_ROOT / "src/repro_torch/analysis/baseline.json").entries
    for f in got:
        assert entries.get(f.fingerprint(), "").strip(), f.render()


# ------------------------------------------------------------ host-boundary

HOST_FAULTS = {
    "span in checkpointed lambda": ("""
        def forward(cfg, params, x, remat):
            block = checkpointed(
                lambda lp, x: _block(cfg, lp, x), remat)
            return block(params, x)

        def _block(cfg, lp, x):
            with obs_trace.span("serve.layer"):
                return x + 1
    """, "_block", "obs_trace.span"),
    "item in Function.forward": ("""
        class _Ste(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                if x.abs().max().item() > 1:
                    return x
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g
    """, "_Ste.forward", "item"),
    "partial into checkpoint": ("""
        def body(x, n):
            torch.cuda.synchronize()
            return x

        def run(x):
            return torch.utils.checkpoint.checkpoint(
                functools.partial(body, n=2), x, use_reentrant=False)
    """, "body", "torch.cuda.synchronize"),
    "launch counter in a named body": ("""
        def layer(x):
            build.count_launch("dequant_matmul")
            return x

        def forward(x, remat):
            step = checkpointed(layer, remat)
            return step(x)
    """, "layer", "build.count_launch"),
}


@pytest.mark.parametrize("case", sorted(HOST_FAULTS))
def test_host_boundary_flags_planted_fault(case):
    src, symbol, call = HOST_FAULTS[case]
    got = jb.check_source(textwrap.dedent(src))
    assert len(got) == 1 and got[0].rule == "host-boundary"
    assert got[0].symbol == symbol and repr(call) in got[0].message


def test_host_boundary_silent_outside_staging():
    src = textwrap.dedent("""
        def host_loop(xs):
            obs_metrics.counter("calls").inc()
            print("fine here")
            return [x.item() for x in xs]

        def forward(x, remat):
            return checkpointed(lambda v: v * 2, remat)(x)
    """)
    assert jb.check_source(src) == []


def test_host_boundary_follows_into_layers_and_is_clean_on_repo():
    idx = jb._Index.scan(base.REPO_ROOT)
    roots = {sym for m in idx.modules.values()
             for _, sym, _ in jb._roots(idx, m)}
    # every remat body and autograd.Function of the port is a root
    assert {"forward.<lambda>", "body", "_SteDeq.forward",
            "_GatherAtUse.backward", "_AllGather.forward"} <= roots
    assert jb.check(base.REPO_ROOT) == []


# ----------------------------------------------------------- kernel-wrapper

WRAPPER_OK = """
    from . import build

    def launch(x):
        if x.device.type == "cpu":
            return launch_plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        lib = build.load()
        return lib.kernel(x)
"""

WRAPPER_FAULTS = {
    "except falls back": ("""
        from . import build

        def launch(x):
            try:
                return build.load().kernel(x)
            except RuntimeError:
                return launch_plain(x)
    """, "except handler falls back"),
    "availability picks a path": ("""
        import torch
        from . import build

        def launch(x):
            if not torch.cuda.is_available():
                return x.clone()
            return build.load().kernel(x)
    """, "is_available() picks another path"),
    "plain outside a cpu test": ("""
        from . import build

        def launch(x):
            if x.is_cuda:
                return build.load().kernel(x)
            return launch_plain(x)
    """, "outside a device test for the CPU"),
    "no raise for another device": ("""
        from . import build

        def launch(x):
            if x.device.type == "cpu":
                return launch_plain(x)
            return build.load().kernel(x)
    """, "neither CPU nor CUDA"),
    "through a helper": ("""
        from . import build

        def _launch(x):
            return build.load().kernel(x)

        def launch(x):
            try:
                return _launch(x)
            except Exception:
                return launch_plain(x)
    """, "except handler falls back"),
}


def _wrapper_findings(tmp_path, src):
    pkg = tmp_path / "src" / "repro_torch" / "kernels"
    pkg.mkdir(parents=True)
    (pkg / "build.py").write_text("def load():\n    return None\n")
    (pkg / "fake.py").write_text(textwrap.dedent(src))
    return jb.check_wrappers(tmp_path)


@pytest.mark.parametrize("case", sorted(WRAPPER_FAULTS))
def test_kernel_wrapper_flags_planted_fault(case, tmp_path):
    src, msg = WRAPPER_FAULTS[case]
    got = _wrapper_findings(tmp_path, src)
    assert got and any(msg in f.message for f in got), got
    assert {(f.rule, f.symbol, f.file) for f in got} == {
        ("kernel-wrapper", "launch", "src/repro_torch/kernels/fake.py")}


def test_kernel_wrapper_silent_on_compliant_wrapper(tmp_path):
    assert _wrapper_findings(tmp_path, WRAPPER_OK) == []


def test_kernel_wrapper_covers_every_wrapper_and_is_clean_on_repo():
    scope = jb.wrapper_scope(jb._Index.scan(base.REPO_ROOT))
    for key in [("repro_torch.kernels.huffman_decode", "decode_streams"),
                ("repro_torch.kernels.ans_decode", "decode_streams_tans"),
                ("repro_torch.kernels.fused_decode_matmul",
                 "fused_decode_matmul"),
                ("repro_torch.kernels.dequant_matmul", "dequant_matmul"),
                ("repro_torch.core.decode_backends", "_cuda_decode"),
                ("repro_torch.core.decode_backends", "_cuda_decode_tans")]:
        assert key in scope, key
    # the host and plain backends reach no kernel; get_backend raises
    for sym in ("_torch_decode", "_numpy_decode", "get_backend"):
        assert ("repro_torch.core.decode_backends", sym) not in scope
    assert jb.check_wrappers(base.REPO_ROOT) == []


# -------------------------------------------------------------------- locks

_LOCK_POLICY = dict(lock="_lock", guarded=frozenset({"counter"}),
                    single_writer={"solo": "single writer by contract"})

LOCK_CASES = {
    "unguarded write": ("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.counter = 0
            def bump(self):
                self.counter += 1
    """, ["outside"]),
    "locked write and single writer": ("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.counter = 0
                self.solo = []
            def bump(self):
                with self._lock:
                    self.counter += 1
                self.solo.append(1)
    """, []),
    "undeclared attribute": ("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
            def sneak(self):
                self.rogue = 1
    """, ["undeclared"]),
    "missing lock": ("""
        class C:
            def __init__(self):
                self.counter = 0
    """, ["never assigned"]),
    "mutating call": ("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.counter = {}
            def bump(self, k):
                self.counter.update({k: 1})
    """, ["outside"]),
    "close clears outside the lock": ("""
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.counter = {}
            def close(self):
                self._exec = None
                self.counter.clear()
    """, ["undeclared", "outside"]),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_lock_checker_matches_reference(case):
    src, want = LOCK_CASES[case]
    cls = next(n for n in ast.walk(ast.parse(textwrap.dedent(src)))
               if isinstance(n, ast.ClassDef))
    got = locks.check_class(cls, locks.LockPolicy(**_LOCK_POLICY), "fix.py")
    ref = jlocks.check_class(cls, jlocks.LockPolicy(**_LOCK_POLICY),
                             "fix.py")
    assert len(got) == len(want)
    for f, w in zip(got, want):
        assert w in f.message and f.rule == "lock-discipline"
    assert [f.to_json() for f in got] == [
        dict(f.to_json(), message=f.message.replace(
            "repro.analysis", "repro_torch.analysis")) for f in ref]


def test_lock_policies_match_repo():
    assert locks.check(base.REPO_ROOT) == []
    pol = locks.POLICIES[("src/repro_torch/serving/resident.py",
                          "CompressedResidentWeights")]
    assert "_pending" in pol.guarded and pol.single_writer["_exec"]


def test_every_lock_owner_has_a_policy():
    owners = set()
    for path in base.iter_py_files(base.REPO_ROOT,
                                   ["src/repro_torch/**/*.py"]):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ClassDef) and any(
                    isinstance(n, ast.Call)
                    and base.dotted(n.func).endswith(("Lock", "RLock"))
                    for n in ast.walk(node)):
                owners.add((base.rel(path, base.REPO_ROOT), node.name))
    assert owners and owners <= set(locks.POLICIES)


# ------------------------------------------------------------- catalog sync

EMITS = """
    def f(name):
        obs_trace.span("serve.step")
        obs_trace.instant("kv.admit")
        obs_metrics.counter("queue.shed").inc()
        obs_metrics.histogram("request.ttft_s").observe(1.0)
        obs_metrics.counter(name).inc()
"""


def test_catalog_collect_emits_and_dynamic_name(tmp_path):
    for pkg in ("repro", "repro_torch"):
        d = tmp_path / "src" / pkg / "serving"
        d.mkdir(parents=True)
        (d / "mod.py").write_text(textwrap.dedent(EMITS))
    sites, findings = cat.collect_emits(tmp_path)
    ref_sites, ref_findings = jcat.collect_emits(tmp_path)
    assert ("spans", "serve.step") in sites
    assert ("metrics", "queue.shed") in sites
    assert len(findings) == 1 and "non-literal" in findings[0].message
    # the reference's collector on its own tree gives the same points
    assert {k: [(f.replace("repro_torch", "repro"), ln) for f, ln in v]
            for k, v in sites.items()} == ref_sites
    assert [f.message for f in findings] == [f.message for f in ref_findings]


def test_catalog_reads_resolve_names_bound_in_the_function():
    src = textwrap.dedent("""
        def phase():
            counters = ("resident.prefetch_hit", "resident.consume_wait_s")
            read = lambda: {c: obs_metrics.counter(c).total()
                            for c in counters}
            n = obs_metrics.counter("fleet.redrives").total()
            obs_metrics.gauge(unknown).value()
    """)
    sites, bad = cat.collect_reads(src, "chip_smoke.py")
    assert set(sites) == {("metrics", "resident.prefetch_hit"),
                          ("metrics", "resident.consume_wait_s"),
                          ("metrics", "fleet.redrives")}
    assert len(bad) == 1 and "non-literal" in bad[0].message


CATALOG_FAULTS = {
    "dead entry": ("dead catalog entry: metric 'dead.one'", "dead.one"),
    "uncataloged emit": ("uncataloged metric 'new.one'", "new.one"),
    "dynamic name": ("non-literal name in obs_metrics.gauge", ""),
    "uncataloged read": ("reads uncataloged metric 'read.only'",
                         "read.only"),
}


@pytest.fixture
def planted_catalog(tmp_path, monkeypatch):
    from repro_torch.obs import points
    monkeypatch.setattr(points, "EXPECTED_POINTS",
                        {"mode": {"spans": ["serve.step"], "metrics": []}})
    monkeypatch.setattr(points, "INFORMATIONAL_POINTS",
                        {"spans": [], "metrics": ["dead.one"]})
    d = tmp_path / "src" / "repro_torch" / "serving"
    d.mkdir(parents=True)
    (d / "mod.py").write_text(textwrap.dedent("""
        def f(name):
            obs_trace.span("serve.step")
            obs_metrics.counter("new.one").inc()
            obs_metrics.gauge(name).set(1)
    """))
    (tmp_path / "chip_smoke.py").write_text(
        "def g():\n    obs_metrics.counter('read.only').total()\n")
    return cat.check_points(tmp_path)


@pytest.mark.parametrize("case", sorted(CATALOG_FAULTS))
def test_catalog_flags_planted_fault(case, planted_catalog):
    msg, symbol = CATALOG_FAULTS[case]
    hits = [f for f in planted_catalog if msg in f.message]
    assert len(hits) == 1 and hits[0].symbol == symbol
    assert len(planted_catalog) == len(CATALOG_FAULTS)


def test_catalog_flags_backend_missing_a_family(monkeypatch):
    from repro_torch.core import decode_backends as db
    good = db._REGISTRY["numpy"]
    monkeypatch.setitem(db._REGISTRY, "half", db.DecoderBackend(
        name="half", fns={"prefix": good.fns["prefix"]},
        probe=lambda: True, fused_fns=dict(good.fused_fns)))
    got = cat.check_registries(base.REPO_ROOT)
    assert sorted(f.message for f in got) == [
        "decoder backend 'half' fuses families ['tans'] it cannot decode "
        "unfused",
        "decoder backend 'half' missing decode families ['tans']"]


def test_catalog_sync_clean_on_repo():
    assert cat.check(base.REPO_ROOT) == []


# ---------------------------------------------------------------- twins

PAIRS = {f"{fam}-{i}": (fam, i) for fam in ("dense", "moe")
         for i in range(5)}


@pytest.fixture(scope="module")
def pairs():
    return {fam: twins.twin_pairs(fam) for fam in ("dense", "moe")}


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_twin_pair_clean(case, pairs):
    fam, i = PAIRS[case]
    pair = pairs[fam][i]
    ref = pair.ref_ops()
    assert ref, "canonicalization must keep float ops"
    assert any(op == "mm" for op, _ in ref)
    assert twins.diff_ops(ref, pair.twin_ops()) == "", pair.name


@pytest.fixture(scope="module")
def dense_decode():
    mod, dense, cfg, params, inputs = twins._setup("dense")
    i = inputs()
    ref = twins.record_ops(lambda: mod.decode_step(
        cfg, params, i["token1"], i["cache"], i["posv"]))
    return mod, dense, cfg, params, inputs, ref


def test_twin_perturbation_detected(dense_decode):
    """A twin with one extra bf16 multiply on its output must diverge."""
    mod, dense, cfg, params, inputs, ref = dense_decode
    i = inputs()

    def perturbed():
        x, c = twins.compose_step(mod, dense, cfg, params, i["token1"],
                                  i["cache"], i["posv"])
        return x * 1.0001, c

    msg = twins.diff_ops(ref, twins.record_ops(perturbed))
    assert "additionally computes mul" in msg


def test_twin_dropped_op_detected(dense_decode):
    mod, dense, cfg, params, inputs, ref = dense_decode
    i = inputs()
    assert "additionally computes" in twins.diff_ops(ref, ref[:-1])

    def no_final_norm():
        # a real twin that drops the head's norm: embed, blocks, logits
        x = mod.embed_step(cfg, params, i["token1"])
        for l in range(cfg.n_layers):
            x, _ = mod.resident_block(cfg, dense._layer(params, l), x,
                                      i["cache"], l, i["posv"])
        return mod.logits_fn(cfg, params, x)

    assert twins.diff_ops(ref, twins.record_ops(no_final_norm)) \
        .startswith("op ")


def test_twin_stage_failure_is_a_finding(monkeypatch):
    def broken(family):
        raise RuntimeError(f"no {family}")
    monkeypatch.setattr(twins, "twin_pairs", broken)
    got = twins.check(base.REPO_ROOT)
    assert [f.symbol for f in got] == ["dense", "moe"]
    assert all("could not stage" in f.message for f in got)


# ------------------------------------------------------------------- gate

def test_gate_exits_zero_on_repo():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = analysis_main(["--json"])
    got = json.loads(out.getvalue())
    assert rc == 0, got
    assert got["findings"] == [] and got["stale_baseline"] == []
    assert set(got["checkers"]) == set(base.CHECKERS)
    assert got["accepted"] == got["checkers"]["dtype-discipline"]
    # --no-baseline lists only what the baseline justifies
    entries = base.Baseline.load(
        base.REPO_ROOT / "src/repro_torch/analysis/baseline.json").entries
    with redirect_stdout(io.StringIO()) as out2, redirect_stderr(err):
        rc = analysis_main(["--json", "--no-baseline",
                            "--checks", "dtype-discipline"])
    listed = json.loads(out2.getvalue())["findings"]
    assert rc == 1 and listed
    assert {base.Finding(**f).fingerprint() for f in listed} == set(entries)
