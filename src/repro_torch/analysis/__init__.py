"""Static analysis of the PyTorch port (counterpart of ``repro.analysis``).

The checkers turn the port's unwritten invariants into gated rules over
``src/repro_torch/`` and ``chip_smoke.py``: serving twins that match their
whole-tree steps op for op, the f32 dequant-affine rule, no host work in
code that autograd replays, kernel wrappers that launch or raise, lock
discipline of thread-shared state, and the obs catalog in sync with its
emit sites.  ``python -m repro_torch.analysis`` runs them against
``analysis/baseline.json``.

The import surface is stdlib-only; checker modules load lazily through
:func:`repro_torch.analysis.base.resolve`.
"""
from .base import (Baseline, CHECKERS, Finding, render_json, render_text,
                   resolve, run_checkers)

__all__ = ["Baseline", "CHECKERS", "Finding", "render_json", "render_text",
           "resolve", "run_checkers"]
