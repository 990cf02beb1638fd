"""Shared static-analysis surface of the port: findings, baselines,
reporters, registry (the counterpart of ``repro/analysis/base.py``).

A checker produces :class:`Finding` rows, a reviewed :class:`Baseline`
(``analysis/baseline.json``) absorbs the accepted ones, and the reporters
print the rest as uniform ``file:line rule message`` text or ``--json``.

Stdlib-only: importing this module never pulls ``torch``.  Checkers that
need it (twin-consistency, the registry half of catalog-sync) import it
inside their ``check()``; the registry maps each rule name to a
``"module:function"`` string resolved only when the rule runs.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One structured analysis result.

    ``file`` is repo-relative; ``symbol`` names the enclosing function or
    class so the baseline fingerprint survives unrelated line drift.
    """

    file: str
    line: int
    rule: str
    message: str
    symbol: str = ""

    def fingerprint(self) -> str:
        # line numbers are left out: a baselined finding stays baselined
        # when code above it moves; digit runs are collapsed so counts and
        # shapes in a message do not churn the fingerprint either
        msg = re.sub(r"\d+", "N", self.message)
        return f"{self.rule}::{self.file}::{self.symbol}::{msg}"

    def render(self) -> str:
        return f"{self.file}:{self.line} {self.rule} {self.message}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class Baseline:
    """Reviewed suppression file: fingerprint -> one-line justification.

    Every entry is an accepted finding (intended code a checker would
    otherwise flag) and says why it is intended.  ``split()`` partitions a
    fresh run into (new, accepted, stale); the gate fails on new and
    reports stale so dead entries get pruned.
    """

    def __init__(self, entries: Optional[Dict[str, str]] = None):
        self.entries: Dict[str, str] = dict(entries or {})

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        if not path.exists():
            return cls()
        data = json.loads(path.read_text())
        entries = {e["fingerprint"]: e.get("justification", "")
                   for e in data.get("entries", [])}
        return cls(entries)

    def save(self, path: Path) -> None:
        data = {
            "comment": "Reviewed static-analysis suppressions of the "
                       "PyTorch port (python -m repro_torch.analysis). "
                       "Every entry says why the flagged code is intended.",
            "entries": [
                {"fingerprint": fp, "justification": j}
                for fp, j in sorted(self.entries.items())
            ],
        }
        path.write_text(json.dumps(data, indent=2) + "\n")

    def split(self, findings: Iterable[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[str]]:
        """Partition into (new, accepted) findings + stale fingerprints."""
        new: List[Finding] = []
        accepted: List[Finding] = []
        seen: set = set()
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                accepted.append(f)
                seen.add(fp)
            else:
                new.append(f)
        stale = sorted(set(self.entries) - seen)
        return new, accepted, stale

    def absorb(self, findings: Iterable[Finding],
               justification: str = "TODO: justify") -> int:
        added = 0
        for f in findings:
            fp = f.fingerprint()
            if fp not in self.entries:
                self.entries[fp] = justification
                added += 1
        return added


# --------------------------------------------------------------- reporters

def render_text(findings: Iterable[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def render_json(findings: Iterable[Finding], *,
                extra: Optional[Dict[str, object]] = None) -> str:
    payload: Dict[str, object] = {"findings": [f.to_json() for f in findings]}
    if extra:
        payload.update(extra)
    return json.dumps(payload, indent=2)


# ---------------------------------------------------------------- registry

# rule name -> "module:function"; the callable takes the repo root Path and
# returns List[Finding].  Strings keep this module free of checker imports:
# resolve() is the only place a checker module loads.
CHECKERS: Dict[str, str] = {
    "twin-consistency": "repro_torch.analysis.twins:check",
    "dtype-discipline": "repro_torch.analysis.dtypes:check",
    "host-boundary": "repro_torch.analysis.jit_boundary:check",
    "kernel-wrapper": "repro_torch.analysis.jit_boundary:check_wrappers",
    "lock-discipline": "repro_torch.analysis.locks:check",
    "catalog-sync": "repro_torch.analysis.catalog:check",
}


def resolve(name: str) -> Callable[[Path], List[Finding]]:
    spec = CHECKERS[name]
    mod_name, _, fn_name = spec.partition(":")
    return getattr(importlib.import_module(mod_name), fn_name)


def run_checkers(names: Iterable[str], root: Path = REPO_ROOT
                 ) -> List[Finding]:
    findings: List[Finding] = []
    for name in names:
        findings.extend(resolve(name)(root))
    return findings


# ------------------------------------------------------------ AST helpers
# (shared by the pure-AST checkers; stdlib `ast` only)

def iter_py_files(root: Path, rel_globs: Iterable[str]) -> List[Path]:
    files: List[Path] = []
    for g in rel_globs:
        files.extend(sorted(root.glob(g)))
    return [f for f in files if f.is_file()]


def rel(path: Path, root: Path) -> str:
    try:
        return str(path.relative_to(root))
    except ValueError:
        return str(path)


def dotted(node: ast.AST) -> str:
    """Dotted name of a call target (``torch.cuda.synchronize``,
    ``obs_trace.span``); a call's receiver that is no name stays out
    (``x.float().item`` -> ``item``)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def qualified_defs(tree: ast.Module) -> Dict[str, List[ast.FunctionDef]]:
    """Every function of a module by name, methods also as
    ``Class.method`` and nested defs under their own name (a name-based
    call graph, as the reference's; same-named defs are all kept)."""
    out: Dict[str, List[ast.FunctionDef]] = {}

    def visit(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = f"{cls}.{child.name}" if cls else child.name
                out.setdefault(name, []).append(child)
                visit(child, None)
            else:
                visit(child, cls)

    visit(tree, None)
    return out
