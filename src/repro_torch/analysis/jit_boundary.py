"""host-boundary and kernel-wrapper: two rules on the port's staged code
and its kernel wrappers (counterpart of ``repro/analysis/jit_boundary.py``).

**host-boundary.**  The port has no jit; what it stages is what autograd
replays:

* bodies handed to ``layers.checkpointed(...)`` or
  ``torch.utils.checkpoint.checkpoint(...)`` (names, lambdas and
  ``functools.partial`` alike): under remat such a body runs again in the
  backward;
* the ``forward`` / ``backward`` of each ``torch.autograd.Function``.

An obs span or metric, a launch counter, ``print``, ``time.*``,
``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` or
``torch.cuda.synchronize`` there fires twice a step or stalls the stream.
The pass walks the call graph from those roots, within the module (as the
reference does) and into ``models/*.py``, where the blocks' work lives
(``layers.py`` and the family a block borrows from, as ``moe`` borrows
``dense._attn``), resolving names through each module's imports.

**kernel-wrapper.**  The port's wrapper rule: on a CUDA tensor a kernel
wrapper launches its kernel or raises; only on a CPU tensor does it run
the plain version.  Its scope is every function of ``kernels/*.py`` and
``core/decode_backends.py`` that reaches the ctypes library
(``build.load()``), directly or through another such function.  Each one:

* calls a ``*_plain`` function only under a device test for the CPU
  (``x.device.type == "cpu"``);
* when it does, also raises for a device that is neither CPU nor CUDA
  (an ``if`` on ``!= "cuda"`` whose branch raises: the pattern of
  ``kernels/huffman_decode.py``'s ``decode_streams``);
* has no ``try`` whose handler calls a ``*_plain`` function or returns a
  result (a failed build or launch must surface, not fall back);
* has no ``torch.cuda.is_available()`` branch that picks another path
  instead of raising.

``decode_backends.get_backend`` raises for an unavailable backend and
reaches no kernel; the cuda backend's ``probe=torch.cuda.is_available``
only gates an explicit request: both are outside the rule by construction.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, dotted, iter_py_files, qualified_defs, rel

TARGET_GLOBS = ["src/repro_torch/**/*.py"]
FOLLOW_PREFIX = "repro_torch.models."
WRAPPER_MODULES = ("repro_torch.kernels.", "repro_torch.core.decode_backends")
LIBRARY = ("repro_torch.kernels.build", "load")

STAGERS = {"checkpointed", "checkpoint"}
HOST_CALL_NAMES = {"print", "open", "input", "breakpoint"}
HOST_ATTR_CALLS = {"item", "tolist", "cpu", "numpy"}
HOST_MODULES = {"time", "threading", "os", "sys", "logging"}
OBS_MODULES = {"obs_trace", "obs_metrics"}
HOST_FUNCS = {"torch.cuda.synchronize", "count_launch", "build.count_launch"}
NP_HOST_FNS = {"save", "load", "savez", "fromfile", "tofile"}

Key = Tuple[str, str]               # (module, qualified function name)


class _Module:
    """One source file (repo-relative ``file`` under ``src/``): its
    functions and the names its imports bind."""

    def __init__(self, file: str, src: str):
        self.file = file
        parts = Path(file).with_suffix("").parts[1:]          # drop "src"
        init = parts[-1] == "__init__"
        self.name = ".".join(parts[:-1] if init else parts)
        self.package = self.name if init else self.name.rpartition(".")[0]
        self.tree = ast.parse(src)
        self.defs = qualified_defs(self.tree)
        self.imports: Dict[str, Tuple[str, Optional[str]]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.imports[a.asname] = (a.name, None)
                    else:
                        head = a.name.split(".")[0]
                        self.imports[head] = (head, None)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = self.package.split(".")
                    pkg = pkg[:len(pkg) - node.level + 1]
                    base = ".".join(pkg + ([base] if base else []))
                for a in node.names:
                    self.imports[a.asname or a.name] = (base, a.name)


class _Index:
    """Every module of the port, with name resolution across them."""

    def __init__(self, modules: List[_Module]):
        self.modules: Dict[str, _Module] = {m.name: m for m in modules}

    @classmethod
    def scan(cls, root: Path) -> "_Index":
        return cls([_Module(rel(p, root), p.read_text())
                    for p in iter_py_files(root, TARGET_GLOBS)
                    if "analysis" not in p.parts])

    def resolve(self, mod: _Module, call: ast.Call,
                local: Set[str] = frozenset()) -> Optional[Key]:
        """(module, function) a call names, where the port defines it; a
        bare name in ``local`` (the caller's own bindings) names none."""
        name = dotted(call.func)
        if not name:
            return None
        head, _, rest = name.partition(".")
        if head in local:
            return None
        if not rest:
            if head in mod.defs:
                return mod.name, head
            target = mod.imports.get(head)
            if target and target[1] is not None:
                return self._attr(target[0], target[1])
            return None
        target = mod.imports.get(head)
        if target is None or "." in rest:
            return None
        module = target[0] if target[1] is None \
            else f"{target[0]}.{target[1]}"
        return self._attr(module, rest)

    def _attr(self, module: str, attr: str) -> Optional[Key]:
        if module in self.modules and attr in self.modules[module].defs:
            return module, attr
        sub = f"{module}.{attr}"
        return None if sub in self.modules else (module, attr)

    def defs(self, key: Key) -> List[ast.FunctionDef]:
        m = self.modules.get(key[0])
        return m.defs.get(key[1], []) if m else []


def _local_names(fn: ast.AST) -> Set[str]:
    """Parameters and assigned names of a function or lambda."""
    out: Set[str] = set()
    args = fn.args
    for a in [*args.posonlyargs, *args.args, *args.kwonlyargs,
              args.vararg, args.kwarg]:
        if a is not None:
            out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _calls(node: ast.AST, *, nested: bool = True):
    """Calls under ``node``; with ``nested=False`` not those of nested
    defs and lambdas (they run when called, not here)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if not nested and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


# ------------------------------------------------------------ host-boundary

def _host_call(call: ast.Call) -> Optional[str]:
    name = dotted(call.func)
    head = name.split(".")[0]
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in HOST_ATTR_CALLS:
        return name
    if head in OBS_MODULES or name in HOST_CALL_NAMES or name in HOST_FUNCS:
        return name
    if head in HOST_MODULES and "." in name:
        return name
    if head == "np" and name.split(".")[-1] in NP_HOST_FNS:
        return name
    return None


def _is_function_class(cls: ast.ClassDef) -> bool:
    return any(dotted(b).split(".")[-1] == "Function"
               and "autograd" in dotted(b) for b in cls.bases)


def _roots(index: _Index, mod: _Module) -> List[Tuple[Key, str, ast.AST]]:
    """(key, symbol, node) of each staged body a module defines."""
    out: List[Tuple[Key, str, ast.AST]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and _is_function_class(node):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) \
                        and fn.name in ("forward", "backward"):
                    sym = f"{node.name}.{fn.name}"
                    out.append(((mod.name, sym), sym, fn))
    for sym, fns in mod.defs.items():
        for fn in fns:
            for call in _calls(fn, nested=False):
                if dotted(call.func).split(".")[-1] not in STAGERS \
                        or not call.args:
                    continue
                body = call.args[0]
                if isinstance(body, ast.Call) and \
                        dotted(body.func).split(".")[-1] == "partial" \
                        and body.args:
                    body = body.args[0]
                if isinstance(body, ast.Lambda):
                    lsym = f"{sym}.<lambda>"
                    out.append(((mod.name, lsym), lsym, body))
                elif isinstance(body, ast.Name):
                    key = index.resolve(mod, ast.Call(func=body, args=[],
                                                      keywords=[]))
                    if key is not None:
                        out.extend((key, key[1], d) for d in index.defs(key))
    return out


def _follow(key: Key, origin: str) -> bool:
    return key[0] == origin or key[0].startswith(FOLLOW_PREFIX)


def check_index(index: _Index) -> List[Finding]:
    findings: List[Finding] = []
    reported: Set[Tuple[str, int]] = set()
    for mod in index.modules.values():
        roots = _roots(index, mod)
        seen: Set[Key] = set()
        work = [(key, sym, node, mod) for key, sym, node in roots]
        while work:
            key, sym, node, owner = work.pop()
            if (key, id(node)) in seen:
                continue
            seen.add((key, id(node)))
            for call in _calls(node):
                what = _host_call(call)
                if what is not None and (owner.file, call.lineno) \
                        not in reported:
                    reported.add((owner.file, call.lineno))
                    findings.append(Finding(
                        file=owner.file, line=call.lineno,
                        rule="host-boundary",
                        message=f"host-side call {what!r} reachable from a "
                                f"remat body or an autograd.Function — "
                                f"fires again in the backward, or stalls "
                                f"the stream", symbol=sym))
                    continue
                callee = index.resolve(owner, call)
                if callee is None or not _follow(callee, mod.name):
                    continue
                target = index.modules[callee[0]]
                for d in index.defs(callee):
                    work.append((callee, callee[1], d, target))
    return sorted(findings, key=lambda f: (f.file, f.line))


def check_source(src: str, file: str = "src/repro_torch/models/fix.py"
                 ) -> List[Finding]:
    """The host-boundary pass over one source string, a module of its own."""
    return check_index(_Index([_Module(file, src)]))


def check(root: Path) -> List[Finding]:
    return check_index(_Index.scan(root))


# ----------------------------------------------------------- kernel-wrapper

def _is_cpu_test(test: ast.AST) -> bool:
    """True when the branch under ``test`` runs only for CPU tensors."""
    if isinstance(test, ast.BoolOp):
        hits = [_is_cpu_test(v) for v in test.values]
        return any(hits) if isinstance(test.op, ast.And) else all(hits)
    return isinstance(test, ast.Compare) and len(test.ops) == 1 \
        and isinstance(test.ops[0], ast.Eq) and any(
            isinstance(c, ast.Constant) and c.value == "cpu"
            for c in [test.left, *test.comparators])


def _is_not_cuda_test(test: ast.AST) -> bool:
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return dotted(test.operand).endswith("is_cuda")
    return isinstance(test, ast.Compare) and len(test.ops) == 1 \
        and isinstance(test.ops[0], ast.NotEq) and any(
            isinstance(c, ast.Constant) and c.value == "cuda"
            for c in [test.left, *test.comparators])


def _raises(body: List[ast.stmt]) -> bool:
    return bool(body) and all(isinstance(s, ast.Raise) for s in body)


def _is_plain(call: ast.Call) -> bool:
    return dotted(call.func).split(".")[-1].endswith("_plain")


def _availability(test: ast.AST) -> Optional[bool]:
    """For a test on ``torch.cuda.is_available()``: True when the branch
    taken without a card is the ``if`` body (``if not ...``), False when
    it is the ``else``; None for any other test."""
    negated = isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
    inner = test.operand if negated else test
    for call in [inner] + list(_calls(inner)):
        if isinstance(call, ast.Call) \
                and dotted(call.func).endswith("is_available"):
            return negated
    return None


def check_wrapper(fn: ast.FunctionDef, file: str, sym: str
                  ) -> List[Finding]:
    """The wrapper rule on one function that reaches the library."""
    out: List[Finding] = []

    def finding(line: int, msg: str) -> None:
        out.append(Finding(file=file, line=line, rule="kernel-wrapper",
                           message=msg, symbol=sym))

    cpu_plain = raises_other = False

    def visit(nodes, under_cpu: bool) -> None:
        nonlocal cpu_plain, raises_other
        for child in nodes:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Call) and _is_plain(child):
                if under_cpu:
                    cpu_plain = True
                else:
                    finding(child.lineno,
                            f"calls {dotted(child.func)!r} outside a device "
                            f"test for the CPU — on a CUDA tensor a wrapper "
                            f"launches its kernel or raises")
            if isinstance(child, ast.Try):
                for h in child.handlers:
                    if any(_is_plain(c) for c in _calls(h)) or any(
                            isinstance(s, ast.Return) and s.value is not None
                            for s in ast.walk(h)):
                        finding(h.lineno,
                                "except handler falls back to another path "
                                "— a failed build or launch must raise")
            if isinstance(child, (ast.If, ast.IfExp)):
                avail = _availability(child.test)
                if avail is not None and (
                        isinstance(child, ast.IfExp) or not _raises(
                            child.body if avail else child.orelse)):
                    finding(child.lineno,
                            "torch.cuda.is_available() picks another path "
                            "instead of raising")
            if isinstance(child, ast.If):
                if _is_not_cuda_test(child.test) and _raises(child.body):
                    raises_other = True
                visit([child.test], under_cpu)
                visit(child.body, under_cpu or _is_cpu_test(child.test))
                visit(child.orelse, under_cpu)
            else:
                visit(ast.iter_child_nodes(child), under_cpu)

    visit(fn.body, False)
    if cpu_plain and not raises_other:
        finding(fn.lineno,
                "takes the plain version on the CPU but does not raise for "
                "a device that is neither CPU nor CUDA")
    return out


def wrapper_scope(index: _Index) -> Dict[Key, List[ast.FunctionDef]]:
    """Functions of the wrapper modules that reach ``build.load()``."""
    scope = {(m.name, sym): fns for m in index.modules.values()
             if m.name.startswith(WRAPPER_MODULES)
             for sym, fns in m.defs.items()}
    reach: Set[Key] = set()
    changed = True
    while changed:
        changed = False
        for key, fns in scope.items():
            if key in reach:
                continue
            mod = index.modules[key[0]]
            for fn in fns:
                local = _local_names(fn)
                for call in _calls(fn, nested=False):
                    target = index.resolve(mod, call, local)
                    if target == LIBRARY or target in reach:
                        reach.add(key)
                        changed = True
                        break
                if key in reach:
                    break
    return {k: scope[k] for k in sorted(reach)}


def check_wrappers_index(index: _Index) -> List[Finding]:
    findings: List[Finding] = []
    for (module, sym), fns in wrapper_scope(index).items():
        for fn in fns:
            findings.extend(check_wrapper(fn, index.modules[module].file,
                                          sym))
    return findings


def check_wrappers(root: Path) -> List[Finding]:
    return check_wrappers_index(_Index.scan(root))
