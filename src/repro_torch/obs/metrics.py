"""Metrics registry: named counters, gauges, and streaming histograms with
JSON-lines snapshot export (docs/OBSERVABILITY.md has the name catalog).

Zero dependencies (stdlib only) so every layer — ``core/``, ``serving/``,
``launch/`` — can record against the process-default registry without import
cycles.  Recording is always on: a counter increment is a dict lookup and an
add (~100ns), cheap enough that instrumentation points never need an
enabled-check; *export* is what the caller opts into (``--metrics-out``).

Three metric kinds, Prometheus-shaped:

* :class:`Counter` — monotonically increasing, labeled
  (``registry.counter("queue.shed").inc(outcome="queue_full")``).
* :class:`Gauge` — last-written value per label set.
* :class:`Histogram` — streaming distribution: exact while small, then the
  P² (Jain & Chlamtac 1985) single-pass quantile estimator per tracked
  quantile — O(1) memory per quantile, no stored samples, p50/p90/p99
  accurate to ~1% on smooth distributions (asserted vs numpy by
  ``tests/test_obs.py``).

Every metric guards **label cardinality** (``MAX_LABEL_SETS`` distinct label
sets): a label that encodes an unbounded value (request id, timestamp) is an
instrumentation bug that would silently grow memory forever, so the guard
raises instead.

:func:`percentile` is the ONE shared exact-percentile rule (linear
interpolation, numpy's default) used by every benchmark and the launcher —
it replaces the index-biased ``lat[int(len(lat)*0.99)]`` one-offs so all
reported percentiles agree.

:class:`Lifecycle` records the per-request event chain of the continuous
engine (queued → admitted → prefill → first-token → done), exported as one
JSON line per request.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, \
    Tuple

# distinct label sets per metric before the cardinality guard trips
MAX_LABEL_SETS = 64


def percentile(xs: Sequence[float], p: float) -> float:
    """Exact percentile with linear interpolation (numpy's default rule).

    ``p`` in [0, 100].  Empty input returns NaN.  This is the shared helper
    the launcher and benchmarks report through — the old
    ``sorted(xs)[int(len(xs) * 0.99)]`` pattern is biased low for small N
    (16 requests: index 15*0.99=15 truncates to the p94 order statistic at
    best, and ``min(len-1, ...)`` clamps make it the max), while linear
    interpolation agrees with ``np.percentile`` to float precision.
    """
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile p must be in [0, 100], got {p}")
    xs = sorted(xs)
    if not xs:
        return float("nan")
    if len(xs) == 1:
        return float(xs[0])
    rank = (len(xs) - 1) * (p / 100.0)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(xs[lo])
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class P2Quantile:
    """P² single-pass quantile estimator (Jain & Chlamtac, CACM 1985).

    Five markers track (min, q/2-ish, q, (1+q)/2-ish, max); marker heights
    adjust toward their ideal positions with a piecewise-parabolic update.
    Exact until 5 observations have arrived.
    """

    __slots__ = ("q", "n", "heights", "pos", "want", "dpos")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0
        self.heights: List[float] = []
        self.pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.want = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self.dpos = [0.0, q / 2, q, (1 + q) / 2, 1.0]

    def observe(self, x: float) -> None:
        self.n += 1
        if len(self.heights) < 5:
            self.heights.append(float(x))
            self.heights.sort()
            return
        h = self.heights
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self.pos[i] += 1.0
        for i in range(5):
            self.want[i] += self.dpos[i]
        for i in (1, 2, 3):
            d = self.want[i] - self.pos[i]
            if (d >= 1 and self.pos[i + 1] - self.pos[i] > 1) or \
                    (d <= -1 and self.pos[i - 1] - self.pos[i] < -1):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic (P²) height update; fall back to
                # linear when the parabola would cross a neighbor
                hp = h[i] + d / (self.pos[i + 1] - self.pos[i - 1]) * (
                    (self.pos[i] - self.pos[i - 1] + d)
                    * (h[i + 1] - h[i]) / (self.pos[i + 1] - self.pos[i])
                    + (self.pos[i + 1] - self.pos[i] - d)
                    * (h[i] - h[i - 1]) / (self.pos[i] - self.pos[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(d)
                    hp = h[i] + d * (h[j] - h[i]) / (self.pos[j] - self.pos[i])
                h[i] = hp
                self.pos[i] += d

    @property
    def value(self) -> float:
        if not self.heights:
            return float("nan")
        if len(self.heights) < 5 or self.n < 5:
            return percentile(self.heights, self.q * 100.0)
        return self.heights[2]


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class CardinalityError(ValueError):
    """A metric saw more distinct label sets than MAX_LABEL_SETS — some
    label is carrying an unbounded value (request id, offset, timestamp)."""


class _Metric:
    kind = "?"

    def __init__(self, name: str, help: str = "",
                 max_label_sets: int = MAX_LABEL_SETS):
        self.name = name
        self.help = help
        self.max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _child(self, labels: Mapping[str, Any]) -> Any:
        key = _label_key(labels)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_label_sets:
                raise CardinalityError(
                    f"metric {self.name!r} exceeded {self.max_label_sets} "
                    f"distinct label sets (offending labels: {dict(labels)}) "
                    f"— a label is likely carrying an unbounded value")
            child = self._children[key] = self._new_child()
        return child

    def _new_child(self) -> Any:
        raise NotImplementedError

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def _rows(self) -> Iterable[Tuple[Dict[str, str], Any]]:
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(key), child


class Counter(_Metric):
    kind = "counter"

    def _new_child(self) -> List[float]:
        return [0.0]

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc {value})")
        with self._lock:
            self._child(labels)[0] += value

    def value(self, **labels: Any) -> float:
        with self._lock:
            child = self._children.get(_label_key(labels))
            return child[0] if child else 0.0

    def total(self) -> float:
        with self._lock:
            return sum(c[0] for c in self._children.values())

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        return [dict(name=self.name, kind=self.kind, labels=labels,
                     value=child[0]) for labels, child in self._rows()]


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> List[float]:
        return [float("nan")]

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._child(labels)[0] = float(value)

    def value(self, **labels: Any) -> float:
        with self._lock:
            child = self._children.get(_label_key(labels))
            return child[0] if child else float("nan")

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        return [dict(name=self.name, kind=self.kind, labels=labels,
                     value=child[0]) for labels, child in self._rows()]


class _HistChild:
    __slots__ = ("count", "sum", "min", "max", "quantiles")

    def __init__(self, qs: Sequence[float]):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.quantiles = {q: P2Quantile(q) for q in qs}


class Histogram(_Metric):
    """Streaming distribution; tracked quantiles default to p50/p90/p99."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99),
                 max_label_sets: int = MAX_LABEL_SETS):
        super().__init__(name, help, max_label_sets)
        self.quantiles = tuple(quantiles)

    def _new_child(self) -> _HistChild:
        return _HistChild(self.quantiles)

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        with self._lock:
            c = self._child(labels)
            c.count += 1
            c.sum += value
            c.min = min(c.min, value)
            c.max = max(c.max, value)
            for est in c.quantiles.values():
                est.observe(value)

    def quantile(self, q: float, **labels: Any) -> float:
        with self._lock:
            c = self._children.get(_label_key(labels))
            if c is None or q not in c.quantiles:
                return float("nan")
            return c.quantiles[q].value

    def count(self, **labels: Any) -> int:
        with self._lock:
            c = self._children.get(_label_key(labels))
            return c.count if c else 0

    def snapshot_rows(self) -> List[Dict[str, Any]]:
        rows = []
        for labels, c in self._rows():
            row = dict(name=self.name, kind=self.kind, labels=labels,
                       count=c.count, sum=c.sum,
                       min=c.min if c.count else None,
                       max=c.max if c.count else None)
            for q, est in c.quantiles.items():
                row[f"p{q * 100:g}"] = est.value if c.count else None
            rows.append(row)
        return rows


class Lifecycle:
    """One request's event chain (queued → admitted → prefill → first-token
    → done), exported as one JSON line.  Timestamps are monotonic-clock
    seconds, the same clock the :class:`~repro_torch.serving.batching.request.
    Request` stamps use, so engine timestamps can be recorded verbatim."""

    __slots__ = ("rid", "labels", "events")

    def __init__(self, rid: int, **labels: Any):
        self.rid = rid
        self.labels = {k: str(v) for k, v in labels.items()}
        self.events: List[Tuple[str, float]] = []

    def event(self, name: str, t: Optional[float] = None) -> None:
        self.events.append((name, time.monotonic() if t is None else float(t)))

    def label(self, **labels: Any) -> None:
        self.labels.update((k, str(v)) for k, v in labels.items())

    def row(self) -> Dict[str, Any]:
        return dict(name="request.lifecycle", kind="lifecycle", rid=self.rid,
                    labels=dict(self.labels),
                    events=[[n, t] for n, t in self.events])


class Registry:
    """Named metrics + request lifecycles, with get-or-create accessors.

    Accessors are idempotent (``registry.counter("queue.shed")`` at two call
    sites share one metric) and kind-checked (asking for an existing name as
    a different kind raises — silent kind drift would corrupt snapshots).
    """

    # requests outlive any single snapshot; bound the retained lifecycles so
    # a long-lived engine cannot grow host memory through its own telemetry
    MAX_LIFECYCLES = 100_000

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._lifecycles: List[Lifecycle] = []
        self.dropped_lifecycles = 0

    def _get(self, name: str, kind: type, **kw: Any) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(name, **kw)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                                f"{kind.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Histogram:
        return self._get(name, Histogram, help=help, quantiles=quantiles)

    def lifecycle(self, rid: int, **labels: Any) -> Lifecycle:
        lc = Lifecycle(rid, **labels)
        with self._lock:
            if len(self._lifecycles) >= self.MAX_LIFECYCLES:
                self.dropped_lifecycles += 1
            else:
                self._lifecycles.append(lc)
        return lc

    @property
    def lifecycles(self) -> List[Lifecycle]:
        with self._lock:
            return list(self._lifecycles)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> List[Dict[str, Any]]:
        """All metric children + lifecycles as plain dict rows (the
        JSON-lines schema ``scripts/check_trace.py`` validates)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
            lifecycles = list(self._lifecycles)
        rows: List[Dict[str, Any]] = []
        for m in metrics:
            rows.extend(m.snapshot_rows())
        rows.extend(lc.row() for lc in lifecycles)
        return rows

    def write_jsonl(self, path: str) -> int:
        """One JSON object per line; returns the number of rows written.
        Non-finite floats serialize as null (strict-JSON consumers)."""

        def clean(v: Any) -> Any:
            if isinstance(v, float) and not math.isfinite(v):
                return None
            if isinstance(v, dict):
                return {k: clean(x) for k, x in v.items()}
            if isinstance(v, list):
                return [clean(x) for x in v]
            return v

        rows = self.snapshot()
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps(clean(row)) + "\n")
        return len(rows)


# ---------------------------------------------------------------------------
# process-default registry: what unqualified instrumentation records against

_default = Registry()
_default_lock = threading.Lock()


def default_registry() -> Registry:
    return _default


def reset() -> Registry:
    """Swap in a fresh default registry (serve runs and tests isolate with
    this; instrumentation sites look the registry up per call, so nothing
    holds a stale reference)."""
    global _default
    with _default_lock:
        _default = Registry()
        return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",
              quantiles: Sequence[float] = (0.5, 0.9, 0.99)) -> Histogram:
    return _default.histogram(name, help, quantiles)


def lifecycle(rid: int, **labels: Any) -> Lifecycle:
    return _default.lifecycle(rid, **labels)


class LegacyMetricsView(Mapping):
    """Read-through alias from the historical ad-hoc metric-dict keys to
    registry gauges (deprecated surface — new code should read the registry
    names directly; docs/OBSERVABILITY.md maps old key → canonical name).

    Behaves like the dict it replaces (``m["decode_tok_per_s"]``, ``.get``,
    iteration), but the values come from the registry: each gauge is read
    once at construction, so the view is a stable record of *that* call even
    after a later serve overwrites the gauges (callers compare views from
    two runs side by side).  Non-gauge entries (e.g. the resolved backend
    name) ride in ``extra``.
    """

    def __init__(self, registry: Registry, alias: Mapping[str, str],
                 extra: Optional[Mapping[str, Any]] = None):
        self._registry = registry
        self._alias = dict(alias)              # old key -> canonical gauge
        self._extra = dict(extra or {})
        self._frozen = {k: registry.gauge(name).value()
                        for k, name in self._alias.items()}

    def __getitem__(self, key: str) -> Any:
        if key in self._extra:
            return self._extra[key]
        return self._frozen[key]

    def __iter__(self):
        seen = set(self._extra)
        yield from self._extra
        for k in self._alias:
            if k not in seen:
                yield k

    def __len__(self) -> int:
        return len(set(self._alias) | set(self._extra))

    def __repr__(self) -> str:
        return f"LegacyMetricsView({dict(self)!r})"
