"""Run the port's static-analysis checkers (the counterpart of
``scripts/check_static.py``).

Six rules over ``src/repro_torch/`` and ``chip_smoke.py``:

* ``twin-consistency`` — the dense and MoE ``resident_*`` / ``paged_*``
  twins dispatch the same float aten ops as their whole-tree steps.
* ``dtype-discipline`` — dequant affine arithmetic is f32; bf16 appears
  only as a dot operand (the PR-4 rule).
* ``host-boundary``    — no obs point, launch counter, ``.item()`` /
  ``.cpu()`` host sync or other host side effect in a remat body or an
  ``autograd.Function``.
* ``kernel-wrapper``   — a kernel wrapper launches or raises on a CUDA
  tensor and runs its plain version only on a CPU tensor.
* ``lock-discipline``  — thread-shared attributes are written under their
  Lock or sit in a declared single-writer list.
* ``catalog-sync``     — every obs point in the catalog has an emit site,
  every emit site (and every point ``chip_smoke.py`` reads) is cataloged,
  and the codec / decoder-backend registries are complete.

Reviewed findings live in ``analysis/baseline.json`` with a justification
each; the gate is an empty delta: any finding not in the baseline exits 1,
and stale entries are reported.  ``--update-baseline`` absorbs the current
findings (then write their justifications).  There is no ruff layer here:
``scripts/check_static.py`` already runs ruff over ``src/``.

Run:  PYTHONPATH=src python -m repro_torch.analysis [--checks a,b] [--json]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List

from .base import (Baseline, CHECKERS, Finding, REPO_ROOT, render_json,
                   render_text, resolve)

BASELINE_PATH = Path(__file__).resolve().parent / "baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--checks", default=None, metavar="A,B",
                    help=f"comma-separated subset of {sorted(CHECKERS)} "
                         f"(default: all)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of text")
    ap.add_argument("--baseline", default=str(BASELINE_PATH), metavar="FILE",
                    help="reviewed suppression file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="absorb current findings into the baseline file "
                         "(write their justifications afterwards)")
    args = ap.parse_args(argv)

    names = sorted(CHECKERS) if args.checks is None \
        else [n.strip() for n in args.checks.split(",") if n.strip()]
    for n in names:
        if n not in CHECKERS:
            ap.error(f"unknown checker {n!r}; have {sorted(CHECKERS)}")

    t0 = time.perf_counter()
    findings: List[Finding] = []
    counts: Dict[str, int] = {}
    for n in names:
        got = resolve(n)(REPO_ROOT)
        counts[n] = len(got)
        findings.extend(got)
    seconds = time.perf_counter() - t0

    baseline = Baseline() if args.no_baseline \
        else Baseline.load(Path(args.baseline))
    new, accepted, stale = baseline.split(findings)
    # an entry of a rule that did not run is not stale
    stale = [fp for fp in stale if fp.split("::", 1)[0] in names]

    if args.update_baseline:
        added = baseline.absorb(new)
        for fp in stale:
            del baseline.entries[fp]
        baseline.save(Path(args.baseline))
        print(f"baseline updated: +{added} absorbed, -{len(stale)} stale "
              f"pruned -> {args.baseline}")
        return 0

    if args.json:
        print(render_json(new, extra={
            "checkers": counts,
            "accepted": len(accepted),
            "stale_baseline": stale,
            "seconds": seconds,
        }))
    else:
        per = " ".join(f"{k}:{v}" for k, v in counts.items())
        print(f"repro_torch.analysis: {per} ({len(accepted)} baselined)")
        if new:
            print(render_text(new))
        for fp in stale:
            print(f"note: stale baseline entry (matches nothing): {fp}",
                  file=sys.stderr)
    if new:
        if not args.json:
            print(f"{len(new)} non-baselined finding(s) — fix them or "
                  f"baseline with a justification", file=sys.stderr)
        return 1
    if not args.json:
        print("all checkers clean (empty delta vs baseline)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
