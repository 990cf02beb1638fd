"""lock-discipline: shared mutable state is written under its Lock
(counterpart of ``repro/analysis/locks.py``, over the port's classes).

The port's serving stack has the reference's thread-crossing objects: the
resident prefetcher (worker decode thread + engine loop), the paged block
manager (engine loop + stats readers), the fleet's router and driver
(replica threads + the submitting thread), and the obs tracer / metrics
(every thread).  Each declares a policy here:

* ``lock``          — the attribute holding its ``threading.Lock``
* ``guarded``       — attributes that must only be *written* inside
  ``with self.<lock>:`` (outside ``__init__``)
* ``single_writer`` — attributes exempted with a reason: a documented
  single-writer contract makes the lock unnecessary (e.g. host bookkeeping
  only the engine loop touches, or a buffer serialized by a one-thread
  executor)
* ``locked_methods``— helpers *called with the lock already held* (their
  writes count as locked)
* ``init_methods``  — constructors/one-time builders that run before any
  thread can observe the object

Any write to an attribute in none of those sets is itself a finding
("undeclared mutable attribute") — new shared state must be classified
when it is introduced, not after the first race.  Reads are out of scope
(snapshot reads of counters are racy-but-benign by policy; the findings
this checker raises are the lost-update class).

Every class of the port that assigns a ``threading.Lock()`` to an
attribute has a policy (``test_every_lock_owner_has_a_policy`` holds the
list to a scan of the package).  The module-level locks
(``obs/trace.py``'s ``_active_lock``, ``obs/metrics.py``'s
``_default_lock``, ``kernels/build.py``'s ``_lock``) guard module globals,
which no class walk reaches.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional

from .base import Finding, rel

MUTATORS = frozenset({"append", "pop", "popitem", "update", "clear",
                      "setdefault", "remove", "discard", "extend", "add",
                      "insert"})


@dataclasses.dataclass(frozen=True)
class LockPolicy:
    lock: str
    guarded: FrozenSet[str]
    single_writer: Dict[str, str] = dataclasses.field(default_factory=dict)
    locked_methods: FrozenSet[str] = frozenset()
    init_methods: FrozenSet[str] = frozenset({"__init__"})
    lock_inherited: bool = False    # lock assigned by a base class __init__


# (repo-relative file, class name) -> policy.  Adding a thread-crossing
# class to the serving/obs layer means adding its policy here — the
# checker's "undeclared mutable attribute" rule makes forgetting loud.
POLICIES: Dict[tuple, LockPolicy] = {
    ("src/repro_torch/obs/trace.py", "Tracer"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"_events", "_instants", "_ids", "_tids",
                           "_tnames", "dropped"}),
        single_writer={
            "_local": "threading.local — per-thread state by construction",
        },
        locked_methods=frozenset({"_tid_locked"}),
    ),
    ("src/repro_torch/obs/metrics.py", "_Metric"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"_children"}),
        locked_methods=frozenset({"_child"}),
    ),
    ("src/repro_torch/obs/metrics.py", "Counter"): LockPolicy(
        lock="_lock", guarded=frozenset({"_children"}), lock_inherited=True,
    ),
    ("src/repro_torch/obs/metrics.py", "Gauge"): LockPolicy(
        lock="_lock", guarded=frozenset({"_children"}), lock_inherited=True,
    ),
    ("src/repro_torch/obs/metrics.py", "Histogram"): LockPolicy(
        lock="_lock", guarded=frozenset({"_children"}), lock_inherited=True,
    ),
    ("src/repro_torch/obs/metrics.py", "Registry"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"_metrics", "_lifecycles",
                           "dropped_lifecycles"}),
    ),
    ("src/repro_torch/serving/resident.py", "CompressedResidentWeights"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"_pending"}),
        single_writer={
            "_buf": "single-worker executor serializes every decode call "
                    "onto one thread (the decode-into-buffer contract)",
            "_exec": "set in __init__; only close() drops it, once, from "
                     "the thread that owns the store after serving stops "
                     "(prefetch / get only read it)",
        },
        init_methods=frozenset({"__init__", "_build_fused_slots"}),
    ),
    ("src/repro_torch/serving/fleet/router.py", "Router"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"shed", "n_dispatched", "_rr"}),
        locked_methods=frozenset({"_shed_locked"}),
    ),
    ("src/repro_torch/serving/fleet/driver.py", "FleetDriver"): LockPolicy(
        lock="_lock",
        guarded=frozenset({"_threads", "_stop_flag"}),
        single_writer={
            "n_steps": "lockstep driver thread only (step/run are never "
                       "called while workers are running)",
            "n_submitted": "submitting thread only (one submit entry point "
                           "by contract — replay_fleet / the launcher)",
            "handoff": "assigned in __init__ only after the decode handles "
                       "exist; never reassigned",
        },
    ),
    ("src/repro_torch/serving/kvcache/blocks.py", "BlockKVManager"): LockPolicy(
        lock="_stats_lock",
        guarded=frozenset({"shared_hits", "shared_misses", "cold_evictions",
                           "cold_restores", "dropped_evictions"}),
        single_writer={a: "engine-loop thread only (admission/step/release "
                          "are driver-serialized); only the stats counters "
                          "cross threads"
                       for a in ("pool", "tables", "kv_len", "requests",
                                 "_live", "_free_slots", "_free_blocks",
                                 "_slot_shared", "_slot_private", "_pending",
                                 "_chain", "_refs", "_block_key", "_lru")},
    ),
}


def _self_attr(node: ast.AST) -> Optional[str]:
    """The first attribute off ``self`` in a chain (self.a.b[c] -> 'a')."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        base = node.value
        if isinstance(node, ast.Attribute) and isinstance(base, ast.Name) \
                and base.id == "self":
            return node.attr
        node = base
    return None


def _written_attrs(stmt: ast.AST) -> List[str]:
    """self-attributes written by one statement (assign/augassign/mutator)."""
    out: List[str] = []
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                a = _self_attr(el)
                if a:
                    out.append(a)
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        f = stmt.value.func
        if isinstance(f, ast.Attribute) and f.attr in MUTATORS:
            a = _self_attr(f.value)
            if a:
                out.append(a)
    return out


class _MethodWalk:
    """Track writes and whether they sit inside ``with self.<lock>:``."""

    def __init__(self, lock: str):
        self.lock = lock
        self.writes: List[tuple] = []    # (attr, line, locked)

    def walk(self, node: ast.AST, locked: bool) -> None:
        for stmt in ast.iter_child_nodes(node):
            now = locked
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    a = _self_attr(item.context_expr)
                    if a == self.lock:
                        now = True
            for attr in _written_attrs(stmt):
                self.writes.append((attr, stmt.lineno, locked))
            self.walk(stmt, now)


def check_class(cls: ast.ClassDef, policy: LockPolicy, file: str
                ) -> List[Finding]:
    findings: List[Finding] = []
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    init_writes = set()
    for m in methods:
        if m.name in policy.init_methods:
            for node in ast.walk(m):
                for a in _written_attrs(node):
                    init_writes.add(a)
    if not policy.lock_inherited and policy.lock not in init_writes \
            and not any(
            policy.lock in _written_attrs(n) for m in methods
            for n in ast.walk(m)):
        findings.append(Finding(
            file=file, line=cls.lineno, rule="lock-discipline",
            message=f"{cls.name}: declared lock attribute "
                    f"{policy.lock!r} is never assigned",
            symbol=cls.name))
        return findings
    for m in methods:
        if m.name in policy.init_methods or m.name in policy.locked_methods:
            continue
        w = _MethodWalk(policy.lock)
        w.walk(m, False)
        for attr, line, locked in w.writes:
            sym = f"{cls.name}.{m.name}"
            if attr == policy.lock:
                continue
            if attr in policy.guarded:
                if not locked:
                    findings.append(Finding(
                        file=file, line=line, rule="lock-discipline",
                        message=f"write to guarded attribute "
                                f"self.{attr} outside `with "
                                f"self.{policy.lock}:`", symbol=sym))
            elif attr not in policy.single_writer:
                findings.append(Finding(
                    file=file, line=line, rule="lock-discipline",
                    message=f"write to undeclared mutable attribute "
                            f"self.{attr} — classify it as guarded or "
                            f"single-writer in repro_torch.analysis.locks",
                    symbol=sym))
    return findings


def check(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    by_file: Dict[str, Dict[str, LockPolicy]] = {}
    for (file, cls), pol in POLICIES.items():
        by_file.setdefault(file, {})[cls] = pol
    for file, pols in sorted(by_file.items()):
        path = root / file
        if not path.exists():
            findings.append(Finding(
                file=file, line=0, rule="lock-discipline",
                message="policy target file missing — update "
                        "repro_torch.analysis.locks.POLICIES"))
            continue
        tree = ast.parse(path.read_text())
        seen = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and node.name in pols:
                seen.add(node.name)
                findings.extend(check_class(node, pols[node.name],
                                            rel(path, root)))
        for missing in sorted(set(pols) - seen):
            findings.append(Finding(
                file=file, line=0, rule="lock-discipline",
                message=f"policy class {missing!r} not found — update "
                        f"repro_torch.analysis.locks.POLICIES", symbol=missing))
    return findings
