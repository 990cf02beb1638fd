"""catalog-sync: obs point catalog <-> emit sites, and registry closure
(counterpart of ``repro/analysis/catalog.py``, over the port).

Two drift directions:

* **dead catalog entry** — a span/metric listed in
  ``repro_torch/obs/points.py`` with no remaining emit site anywhere in
  ``src/repro_torch``.
* **uncataloged emit** — an ``obs_trace.span``/``instant`` or
  ``obs_metrics.counter``/``gauge``/``histogram`` call whose literal name
  appears in neither ``EXPECTED_POINTS`` nor ``INFORMATIONAL_POINTS``.
  Every point must be classified: contract (some mode requires it) or
  informational (best-effort).  The two sets must be disjoint.

Only literal first arguments are collected; a non-literal name (dynamic
point naming) is itself a finding — the catalog cannot audit what it
cannot read.

``chip_smoke.py`` reads metrics back (``obs_metrics.counter(c).total()``,
often ``for c in counters`` over a tuple of names bound in the same
function).  Those reads are resolved the same way and must name cataloged
points; they are not emit sites, so a read never keeps a dead entry alive.

The registry half checks closure of the two extension registries:

* every decoder backend of ``repro_torch.core.decode_backends`` provides
  both decode families (``prefix``, ``tans``) and any fused families are a
  subset of those;
* every entropy codec's table class implements ``from_container``, which
  ``table_from_container`` dispatches on.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set, Tuple

from .base import Finding, iter_py_files, rel

TARGET_GLOBS = ["src/repro_torch/**/*.py"]
SMOKE = "chip_smoke.py"

SPAN_CALLS = {"span", "instant"}          # obs_trace.<call>("name", ...)
METRIC_CALLS = {"counter", "gauge", "histogram"}   # obs_metrics.<call>("name")
REQUIRED_FAMILIES = frozenset({"prefix", "tans"})

EmitSites = Dict[Tuple[str, str], List[Tuple[str, int]]]


def _point_call(node: ast.AST):
    """(module alias, call, kind) of an obs point call, else None."""
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name) and node.args):
        return None
    mod, call = node.func.value.id, node.func.attr
    if mod == "obs_trace" and call in SPAN_CALLS:
        return mod, call, "spans"
    if mod == "obs_metrics" and call in METRIC_CALLS:
        return mod, call, "metrics"
    return None


def _dynamic(file: str, node: ast.Call, mod: str, call: str) -> Finding:
    return Finding(
        file=file, line=node.lineno, rule="catalog-sync",
        message=f"non-literal name in {mod}.{call}(...) — dynamic point "
                f"names cannot be audited against the catalog")


def collect_emits(root: Path) -> Tuple[EmitSites, List[Finding]]:
    """Map (kind, name) -> [(file, line)] for every literal obs emit."""
    sites: EmitSites = {}
    findings: List[Finding] = []
    for path in iter_py_files(root, TARGET_GLOBS):
        if "analysis" in path.parts:
            continue
        file = rel(path, root)
        for node in ast.walk(ast.parse(path.read_text())):
            hit = _point_call(node)
            if hit is None:
                continue
            mod, call, kind = hit
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                sites.setdefault((kind, arg.value), []).append(
                    (file, node.lineno))
            else:
                findings.append(_dynamic(file, node, mod, call))
    return sites, findings


def _str_seq(node: ast.AST):
    """The strings of a tuple / list of string literals, else None."""
    if isinstance(node, (ast.Tuple, ast.List)) and node.elts and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str)
            for e in node.elts):
        return [e.value for e in node.elts]
    return None


def collect_reads(src: str, file: str) -> Tuple[EmitSites, List[Finding]]:
    """Point names a script reads back: literal first arguments, and names
    bound by ``for c in X`` where ``X`` is a literal tuple or a name the
    same function binds to one."""
    sites: EmitSites = {}
    findings: List[Finding] = []
    tree = ast.parse(src)
    scopes = [n for n in tree.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    scopes.append(ast.Module(body=[n for n in tree.body if n not in scopes],
                             type_ignores=[]))
    for scope in scopes:
        env: Dict[str, List[str]] = {}
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                seq = _str_seq(node.value)
                if seq is not None:
                    env[node.targets[0].id] = seq
        for node in ast.walk(scope):
            if isinstance(node, ast.comprehension) \
                    and isinstance(node.target, ast.Name):
                seq = _str_seq(node.iter)
                if seq is None and isinstance(node.iter, ast.Name):
                    seq = env.get(node.iter.id)
                if seq is not None:
                    env[node.target.id] = seq
        for node in ast.walk(scope):
            hit = _point_call(node)
            if hit is None:
                continue
            mod, call, kind = hit
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names = [arg.value]
            elif isinstance(arg, ast.Name) and arg.id in env:
                names = env[arg.id]
            else:
                findings.append(_dynamic(file, node, mod, call))
                continue
            for name in names:
                sites.setdefault((kind, name), []).append((file, node.lineno))
    return sites, findings


def check_points(root: Path) -> List[Finding]:
    from repro_torch.obs.points import EXPECTED_POINTS, INFORMATIONAL_POINTS
    sites, findings = collect_emits(root)
    points_file = "src/repro_torch/obs/points.py"

    expected: Dict[str, Set[str]] = {"spans": set(), "metrics": set()}
    for mode in EXPECTED_POINTS.values():
        for kind in expected:
            expected[kind].update(mode.get(kind, []))
    informational = {kind: set(INFORMATIONAL_POINTS.get(kind, []))
                     for kind in expected}

    def cataloged(kind: str, name: str) -> bool:
        return name in expected[kind] or name in informational[kind]

    for kind in expected:
        for name in sorted(expected[kind] & informational[kind]):
            findings.append(Finding(
                file=points_file, line=1, rule="catalog-sync",
                message=f"{kind[:-1]} {name!r} is both EXPECTED and "
                        f"INFORMATIONAL — pick one", symbol=name))
        for name in sorted(expected[kind] | informational[kind]):
            if (kind, name) not in sites:
                findings.append(Finding(
                    file=points_file, line=1, rule="catalog-sync",
                    message=f"dead catalog entry: {kind[:-1]} {name!r} has "
                            f"no emit site under src/repro_torch",
                    symbol=name))
    for (kind, name), locs in sorted(sites.items()):
        if not cataloged(kind, name):
            file, line = locs[0]
            findings.append(Finding(
                file=file, line=line, rule="catalog-sync",
                message=f"uncataloged {kind[:-1]} {name!r} — add it to "
                        f"EXPECTED_POINTS (contract) or "
                        f"INFORMATIONAL_POINTS (best-effort) in obs/points",
                symbol=name))

    smoke = root / SMOKE
    if smoke.exists():
        reads, bad = collect_reads(smoke.read_text(), SMOKE)
        findings.extend(bad)
        for (kind, name), locs in sorted(reads.items()):
            if not cataloged(kind, name):
                file, line = locs[0]
                findings.append(Finding(
                    file=file, line=line, rule="catalog-sync",
                    message=f"reads uncataloged {kind[:-1]} {name!r} — "
                            f"no catalog entry vouches for an emit site",
                    symbol=name))
    return findings


def check_registries(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    from repro_torch.core import codecs
    from repro_torch.core import decode_backends as db

    reg_file = "src/repro_torch/core/decode_backends.py"
    for name in db.backend_names():
        # audited structurally, availability-independent: the cuda backend
        # must still declare both families on a host without a card
        be = db._REGISTRY[name]
        missing = REQUIRED_FAMILIES - set(be.fns)
        if missing:
            findings.append(Finding(
                file=reg_file, line=1, rule="catalog-sync",
                message=f"decoder backend {name!r} missing decode "
                        f"families {sorted(missing)}", symbol=name))
        extra_fused = set(be.fused_fns or {}) - set(be.fns)
        if extra_fused:
            findings.append(Finding(
                file=reg_file, line=1, rule="catalog-sync",
                message=f"decoder backend {name!r} fuses families "
                        f"{sorted(extra_fused)} it cannot decode unfused",
                symbol=name))

    codec_file = "src/repro_torch/core/codecs/__init__.py"
    for name in codecs.codec_names():
        codec = codecs.get_codec(name)
        if codec.table_cls is not None and \
                not hasattr(codec.table_cls, "from_container"):
            findings.append(Finding(
                file=codec_file, line=1, rule="catalog-sync",
                message=f"codec {name!r} table class "
                        f"{codec.table_cls.__name__} lacks from_container — "
                        f"containers with this codec cannot be reloaded",
                symbol=name))
    return findings


def check(root: Path) -> List[Finding]:
    return check_points(root) + check_registries(root)
