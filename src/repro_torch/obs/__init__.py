"""Serving observability (stdlib only), copied from the JAX package:

* :mod:`.trace` — nested, thread-aware spans with Chrome/Perfetto export;
* :mod:`.metrics` — counters, gauges, streaming histograms, lifecycles;
* :mod:`.analysis` — decode/compute overlap and prefetch stalls of a trace;
* :mod:`.points` — the per-serving-mode catalog of required points
  (``scripts/check_trace.py --expect``).
"""
from . import analysis, metrics, points, trace

__all__ = ["analysis", "metrics", "points", "trace"]
