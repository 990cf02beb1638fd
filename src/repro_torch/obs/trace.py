"""Structured trace recorder: nested, thread-aware spans for the serving
pipeline (docs/OBSERVABILITY.md).

The serving stack's central performance claim — per-layer entropy decode
*overlaps* the previous layer's compute (paper §IV) — is a statement about
concurrent timelines: the worker thread's decode spans against the main
thread's step spans.  This recorder captures exactly that, with three design
constraints:

* **Zero dependencies** — stdlib only (``time``, ``threading``, ``json``),
  so ``core/`` and ``serving/`` can instrument without import cycles or new
  requirements.
* **Pure observer** — spans are host-side wall-clock intervals appended to
  an in-memory list under a lock; nothing in the traced computation changes
  (greedy outputs with tracing on vs off are asserted bit-identical by
  ``tests/test_obs.py`` and ``benchmarks/overlap_report.py``).  Span bodies
  must never run inside a captured CUDA graph (they would fire once at capture
  time); instrumentation lives in the Python drivers and call sites only.
* **Cheap when disabled** — the module-level :func:`span` / :func:`instant`
  check one global and return a shared no-op context manager, so compiled
  hot paths pay a dict build + a ``None`` check and nothing else.

Export formats:

* :meth:`Tracer.chrome_trace` / :meth:`Tracer.save` — Chrome
  ``trace_event`` JSON (``{"traceEvents": [...]}``) that loads directly in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``; spans are
  ``ph="X"`` complete events with microsecond timestamps, threads carry
  ``thread_name`` metadata.
* :meth:`Tracer.span_tree` — a plain-text nested tree per thread, for logs
  and quick terminal inspection.

CUDA launches are asynchronous, so an un-fenced span around a kernel
launch measures *enqueue*, not compute.  ``Tracer.sync`` (the
``--trace-sync`` flag) is the opt-in: instrumented call sites consult it and
fence (``torch.cuda.synchronize()``) so span durations reflect real device
time — at the cost of serializing the very overlap being measured, which is
why it defaults off.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

# a runaway loop must not OOM the host through its own observability:
# beyond this many events the tracer drops new spans and counts them
MAX_EVENTS = 1_000_000


class SpanRecord:
    """One finished span: name, category, [t0, t0+dur) in microseconds since
    the tracer epoch, the recording thread, its parent span id, and labels."""

    __slots__ = ("id", "parent", "name", "cat", "ts_us", "dur_us", "tid",
                 "args")

    def __init__(self, id: int, parent: Optional[int], name: str, cat: str,
                 ts_us: float, dur_us: float, tid: int, args: Dict[str, Any]):
        self.id = id
        self.parent = parent
        self.name = name
        self.cat = cat
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.tid = tid
        self.args = args


class _SpanCM:
    """Context manager for one span; grabs its id/parent at ``__enter__`` so
    the tree survives children finishing before (or after) their parent."""

    __slots__ = ("tracer", "name", "cat", "args", "id", "parent", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_SpanCM":
        tr = self.tracer
        self.id = tr._next_id()
        stack = tr._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        tr = self.tracer
        stack = tr._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        tr._record(SpanRecord(
            self.id, self.parent, self.name, self.cat,
            (self.t0 - tr._epoch) / 1e3, (t1 - self.t0) / 1e3,
            tr._tid(), self.args))
        return False


class _NullSpan:
    """Shared no-op context manager: what :func:`span` hands out while no
    tracer is enabled.  Stateless, so one instance serves any nesting."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class Tracer:
    """Thread-safe span recorder with a fixed epoch and per-thread stacks.

    ``sync`` is advisory: the tracer never touches device state itself, but
    instrumented call sites fence the device (``torch.cuda.synchronize()``)
    when it is set (see module docstring).
    """

    def __init__(self, *, sync: bool = False):
        self.sync = sync
        self._epoch = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._events: List[SpanRecord] = []
        self._instants: List[Dict[str, Any]] = []
        self._ids = 0
        self._local = threading.local()
        self._tids: Dict[int, int] = {}          # thread ident -> small tid
        self._tnames: Dict[int, str] = {}        # small tid -> thread name
        self.dropped = 0

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str = "serve", **args: Any) -> _SpanCM:
        return _SpanCM(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve", **args: Any) -> None:
        """A zero-duration marker event (Perfetto ``ph="i"``)."""
        now = (time.perf_counter_ns() - self._epoch) / 1e3
        with self._lock:
            if len(self._instants) + len(self._events) >= MAX_EVENTS:
                self.dropped += 1
                return
            self._instants.append(dict(name=name, cat=cat, ts=now,
                                       tid=self._tid_locked(), args=args))

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _tid(self) -> int:
        with self._lock:
            return self._tid_locked()

    def _tid_locked(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = self._tids[ident] = len(self._tids)
            self._tnames[tid] = threading.current_thread().name
        return tid

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._events) + len(self._instants) >= MAX_EVENTS:
                self.dropped += 1
                return
            self._events.append(rec)

    # --------------------------------------------------------------- reading
    @property
    def events(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._events)

    def spans(self, name: Optional[str] = None) -> Iterator[SpanRecord]:
        for e in self.events:
            if name is None or e.name == name:
                yield e

    # --------------------------------------------------------------- exports
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome ``trace_event`` JSON object (Perfetto-loadable)."""
        with self._lock:
            events, instants = list(self._events), list(self._instants)
            tnames = dict(self._tnames)
        out: List[Dict[str, Any]] = []
        for tid, tname in sorted(tnames.items()):
            out.append(dict(name="thread_name", ph="M", pid=1, tid=tid,
                            args={"name": tname}))
        out.append(dict(name="process_name", ph="M", pid=1, tid=0,
                        args={"name": "repro_torch.serving"}))
        for e in events:
            out.append(dict(name=e.name, cat=e.cat or "serve", ph="X",
                            ts=e.ts_us, dur=e.dur_us, pid=1, tid=e.tid,
                            args=dict(e.args)))
        for i in instants:
            out.append(dict(name=i["name"], cat=i["cat"] or "serve", ph="i",
                            ts=i["ts"], pid=1, tid=i["tid"], s="t",
                            args=dict(i["args"])))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def save(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the number of trace events
        (spans + instants, excluding thread/process metadata)."""
        doc = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")

    def span_tree(self) -> str:
        """Plain-text nested span tree, one block per thread, children
        indented under their parent in start order."""
        events = self.events
        by_id = {e.id: e for e in events}
        children: Dict[Optional[int], List[SpanRecord]] = {}
        for e in events:
            # a parent that never finished (still open / dropped) roots
            # its children at the top level rather than losing them
            parent = e.parent if e.parent in by_id else None
            children.setdefault(parent, []).append(e)
        for v in children.values():
            v.sort(key=lambda e: e.ts_us)
        lines: List[str] = []

        def walk(e: SpanRecord, depth: int) -> None:
            args = "".join(f" {k}={v}" for k, v in sorted(e.args.items()))
            lines.append(f"{'  ' * depth}{e.name:<28s} "
                         f"{e.dur_us / 1e3:9.3f}ms{args}")
            for c in children.get(e.id, ()):
                walk(c, depth + 1)

        roots = children.get(None, [])
        for tid in sorted({e.tid for e in roots}):
            name = self._tnames.get(tid, str(tid))
            lines.append(f"[thread {tid}: {name}]")
            for e in roots:
                if e.tid == tid:
                    walk(e, 1)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# module-level switchboard: the ONE global every instrumentation site checks

_active: Optional[Tracer] = None
_active_lock = threading.Lock()


def enable(*, sync: bool = False) -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _active
    with _active_lock:
        _active = Tracer(sync=sync)
        return _active


def disable() -> Optional[Tracer]:
    """Uninstall the global tracer; returns it (for export) or None."""
    global _active
    with _active_lock:
        tr, _active = _active, None
        return tr


def get() -> Optional[Tracer]:
    return _active


def enabled() -> bool:
    return _active is not None


def span(name: str, cat: str = "serve", **args: Any):
    """A span against the global tracer, or a shared no-op when disabled."""
    tr = _active
    return tr.span(name, cat, **args) if tr is not None else _NULL


def instant(name: str, cat: str = "serve", **args: Any) -> None:
    tr = _active
    if tr is not None:
        tr.instant(name, cat, **args)


def sync_enabled() -> bool:
    """True when a tracer is active AND asked for fenced spans — the signal
    instrumented call sites use to ``torch.cuda.synchronize()``
    (the ``--trace-sync`` contract)."""
    tr = _active
    return tr is not None and tr.sync
