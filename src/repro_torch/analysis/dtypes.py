"""dtype-discipline: dequant affine arithmetic is f32; bf16 only at the dot
(counterpart of ``repro/analysis/dtypes.py``, in the torch idiom).

The PR-4 rule (EXPERIMENTS.md §Perf H1, ``kernels/dequant_matmul.py``):
the dequantization affine ``q * scale + zero`` must be computed in
float32 — bf16's 8-bit mantissa rounds the reconstruction grid — and
bfloat16 may appear only as the operand dtype of the dot (cast after the
affine).

This is an AST pass over ``kernels/*.py`` and ``models/layers.py``.  It
finds affine-dequant expressions (an ``Add`` whose left operand is a
``Mult``) and resolves the compute dtype of each factor through a
per-function symbol table:

* ``x.to(torch.float32)`` / ``x.to(dtype=...)`` / ``x.type(...)`` and
  ``x.float()``                         -> f32 (compliant)
* ``x.to(torch.bfloat16)``, ``x.bfloat16()``, ``x.half()``, or ``.to(bf)``
  with ``bf = torch.bfloat16`` bound in the function or the module
                                        -> bf16 (violation)
* ``x.to(y.dtype)``, ``.to(dt)`` with ``dt = y.dtype``, or ``.to(dtype)``
  where ``dtype`` is a parameter with no default
                                        -> dynamic (violation: the affine
  inherits whatever the caller passes)

Factors whose dtype cannot be resolved are *not* flagged (no guessing).
Intentional bf16 affines — ``_deq_plain`` and friends define the bf16
quantization *grid* that the bitwise contract pins — live in the baseline
with per-entry justifications.

The reference baselines three sites this pass has no counterpart for:
``_deq_accumulate`` (a Pallas body) and ``_fused_jax`` are the fused
kernel's affine, which the port computes in CUDA
(``csrc/fused_decode_matmul.cu``, out of an AST pass's reach), and
``fused_decode_matmul_ref`` calls ``deq`` here (``kernels/ref.py``), whose
affine is ``_deq_plain``'s.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional

from .base import Finding, iter_py_files, qualified_defs, rel

TARGET_GLOBS = ["src/repro_torch/kernels/*.py",
                "src/repro_torch/models/layers.py"]

F32, BF16, DYN = "float32", "bfloat16", "dynamic"
_DTYPE_ATTRS = {"float32": F32, "float": F32, "float64": F32, "double": F32,
                "bfloat16": BF16, "float16": BF16, "half": BF16}
_CAST_METHODS = {"float": F32, "double": F32, "bfloat16": BF16, "half": BF16}


def _dtype_of_node(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """Resolve a dtype-valued expression: torch.float32, a Name, x.dtype."""
    if isinstance(node, ast.Attribute):
        if node.attr == "dtype":
            return DYN
        if isinstance(node.value, ast.Name) and node.value.id == "torch":
            return _DTYPE_ATTRS.get(node.attr)
    if isinstance(node, ast.Name):
        return env.get(node.id)
    return None


def _cast_dtype(call: ast.Call, env: Dict[str, str]) -> Optional[str]:
    """The dtype a cast call produces (None when it is no cast or the
    target cannot be resolved)."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _CAST_METHODS and not call.args and not call.keywords:
        return _CAST_METHODS[f.attr]
    if f.attr in ("to", "type"):
        for kw in call.keywords:
            if kw.arg == "dtype":
                return _dtype_of_node(kw.value, env)
        for a in call.args:         # .to(device, dtype) / .to(dtype)
            d = _dtype_of_node(a, env)
            if d is not None:
                return d
    return None


def _value_dtype(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """Compute dtype of a value expression, best effort (None = unknown)."""
    if isinstance(node, ast.Call):
        return _cast_dtype(node, env)
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp):
        # dtype of an arithmetic expr: any bf16/dyn factor taints it
        for side in (node.left, node.right):
            d = _value_dtype(side, env)
            if d in (BF16, DYN):
                return d
        l, r = _value_dtype(node.left, env), _value_dtype(node.right, env)
        if F32 in (l, r):
            return F32
    return None


def _module_aliases(tree: ast.Module) -> Dict[str, str]:
    """Module-level names bound to a torch dtype (``f32 = torch.float32``)."""
    env: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            d = _dtype_of_node(node.value, {})
            if d is not None and d != DYN:
                env[node.targets[0].id] = d
    return env


class _FnChecker(ast.NodeVisitor):
    def __init__(self, file: str, fn: ast.FunctionDef, symbol: str,
                 module_env: Dict[str, str]):
        self.file = file
        self.fn = fn
        self.symbol = symbol
        self.env: Dict[str, str] = dict(module_env)
        self.findings: List[Finding] = []
        args = fn.args
        positional = list(args.posonlyargs) + list(args.args)
        defaults = [None] * (len(positional) - len(args.defaults)) \
            + list(args.defaults)
        pairs = list(zip(positional, defaults)) \
            + list(zip(args.kwonlyargs, args.kw_defaults or []))
        for a, d in pairs:
            if d is None:
                # def f(w, dtype): the affine takes the caller's dtype
                if a.arg == "dtype":
                    self.env[a.arg] = DYN
                continue
            dt = _dtype_of_node(d, {})
            if dt:
                self.env[a.arg] = dt

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return None                 # nested defs are checked on their own

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            dt = _value_dtype(node.value, self.env) \
                or _dtype_of_node(node.value, self.env)
            if dt:
                self.env[node.targets[0].id] = dt
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        # affine dequant shape: (a * b) + c
        if isinstance(node.op, ast.Add) and \
                isinstance(node.left, ast.BinOp) and \
                isinstance(node.left.op, ast.Mult):
            factors = [node.left.left, node.left.right, node.right]
            bad = []
            for f in factors:
                d = _value_dtype(f, self.env)
                if d in (BF16, DYN):
                    bad.append(d)
            if bad:
                kind = BF16 if BF16 in bad else DYN
                self.findings.append(Finding(
                    file=self.file, line=node.lineno,
                    rule="dtype-discipline",
                    message=f"dequant affine computed in {kind} dtype; "
                            f"PR-4 rule: affine in f32, bf16 only as the "
                            f"dot operand", symbol=self.symbol))
        self.generic_visit(node)


def check_source(src: str, file: str) -> List[Finding]:
    tree = ast.parse(src)
    module_env = _module_aliases(tree)
    findings: List[Finding] = []
    for symbol, fns in qualified_defs(tree).items():
        for node in fns:
            fc = _FnChecker(file, node, symbol, module_env)
            for stmt in node.body:
                fc.visit(stmt)
            findings.extend(fc.findings)
    return findings


def check(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_py_files(root, TARGET_GLOBS):
        findings.extend(check_source(path.read_text(), rel(path, root)))
    return findings
