"""Trace analysis (PyTorch port of ``repro/obs/analysis.py``, stdlib only):
decode/compute overlap and prefetch stalls from a Chrome/Perfetto
``trace_event`` file.

The compressed-resident execution model claims layer
*l+1*'s entropy decode rides under layer *l*'s compute.  In the trace that
claim is three span families:

* ``resident.decode`` — the worker thread actually decoding a layer;
* ``resident.consume_wait`` — the main thread blocked in ``get(l)`` because
  the prefetch had not finished (the *stall*: decode time NOT hidden);
* ``serve.decode_step`` / ``serve.prefill`` — the main thread's step window
  (dispatching blocks + waiting on the device).

:func:`overlap_report` reduces them to two headline numbers:

* **prefetch stall time** — total ``resident.consume_wait`` duration: the
  wall-clock the serving loop spent waiting for weight decode.
* **decode/compute overlap fraction** — the share of worker decode time
  that ran while the main thread was *busy* (inside a step span but not in
  a consume wait), i.e. decode that was actually hidden under compute
  launches.  1.0 = perfectly hidden; 0.0 = every decoded byte stalled the
  step loop (what ``prefetch=False`` or a decode-bound host degrades to).

Everything here is stdlib + pure interval arithmetic; the port's traces use
the JAX package's span names, so the two reports read alike.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Read a Chrome ``trace_event`` JSON file (object or bare array)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    return events


def span_intervals(events: Iterable[Dict[str, Any]],
                   name: str) -> List[Interval]:
    """[start, end) microsecond intervals of every ``ph="X"`` span named
    ``name``, in start order."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
           for e in events
           if e.get("ph") == "X" and e.get("name") == name]
    return sorted(out)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Merge overlapping/adjacent intervals."""
    merged: List[Interval] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def subtract(base: Sequence[Interval],
             holes: Sequence[Interval]) -> List[Interval]:
    """``base`` minus ``holes`` (both may overlap internally)."""
    base = union(base)
    holes = union(holes)
    out: List[Interval] = []
    hi = 0
    for a, b in base:
        cur = a
        while hi < len(holes) and holes[hi][1] <= cur:
            hi += 1
        j = hi
        while j < len(holes) and holes[j][0] < b:
            ha, hb = holes[j]
            if ha > cur:
                out.append((cur, ha))
            cur = max(cur, hb)
            j += 1
        if cur < b:
            out.append((cur, b))
    return out


def total(intervals: Sequence[Interval]) -> float:
    return sum(b - a for a, b in union(intervals))


def intersect_total(xs: Sequence[Interval], ys: Sequence[Interval]) -> float:
    """Total length of the pairwise intersection of two interval sets."""
    xs, ys = union(xs), union(ys)
    i = j = 0
    out = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            out += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def overlap_report(events: Iterable[Dict[str, Any]],
                   *, decode_span: str = "resident.decode",
                   wait_span: str = "resident.consume_wait",
                   step_spans: Sequence[str] = ("serve.decode_step",
                                                "serve.prefill")
                   ) -> Dict[str, float]:
    """Decode/compute overlap metrics from a trace's events (see module
    docstring).  All times in seconds; ``overlap_fraction`` in [0, 1]
    (NaN when the trace holds no decode spans)."""
    events = list(events)
    decode = span_intervals(events, decode_span)
    waits = span_intervals(events, wait_span)
    steps: List[Interval] = []
    for name in step_spans:
        steps.extend(span_intervals(events, name))
    busy = subtract(steps, waits)       # main thread driving, not stalled
    decode_total = total(decode)
    overlapped = intersect_total(decode, busy)
    frac = overlapped / decode_total if decode_total > 0 else float("nan")
    return {
        "decode_s": decode_total / 1e6,
        "stall_s": total(waits) / 1e6,
        "step_s": total(steps) / 1e6,
        "overlapped_decode_s": overlapped / 1e6,
        "overlap_fraction": min(1.0, frac) if frac == frac else frac,
        "n_decode_spans": float(len(decode)),
        "n_wait_spans": float(len(waits)),
    }
