"""The port's observability contract against the JAX package's.

* ``repro_torch.obs.points`` holds the JAX package's catalog entry for
  entry, and ``repro_torch.obs.analysis`` gives the JAX package's overlap
  report on one synthetic trace.
* The port's launcher, serving each ported mode on the reduced config,
  writes a trace and a metrics snapshot that the repository's
  ``scripts/check_trace.py --expect MODE`` accepts (schema and every
  required point).  The script is run as it is, against the JAX package's
  catalog.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.obs import analysis as janalysis
from repro.obs import points as jpoints
from repro_torch import obs as tobs
from repro_torch.obs import analysis as tanalysis
from repro_torch.obs import points as tpoints

ROOT = Path(__file__).resolve().parents[1]
SPEC = "*:bits=8,codec=huffman; defaults:segment_symbols=1024"


def test_catalog_equals_reference():
    assert tpoints.EXPECTED_POINTS == jpoints.EXPECTED_POINTS
    assert tpoints.INFORMATIONAL_POINTS == jpoints.INFORMATIONAL_POINTS
    assert list(tpoints.EXPECTED_POINTS) == list(jpoints.EXPECTED_POINTS)
    assert tobs.__all__ == ["analysis", "metrics", "points", "trace"]
    assert tobs.points is tpoints and tobs.analysis is tanalysis


def _synthetic_trace():
    """Two threads: the serving loop's steps with consume waits inside,
    and a worker's decode spans that partly overlap them."""
    def x(name, ts, dur, tid):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 1,
                "tid": tid}
    return [
        {"name": "thread_name", "ph": "M", "pid": 1, "tid": 1,
         "args": {"name": "main"}},
        x("serve.prefill", 0.0, 100.0, 1),
        x("resident.consume_wait", 10.0, 30.0, 1),
        x("serve.decode_step", 120.0, 80.0, 1),
        x("serve.decode_step", 210.0, 50.0, 1),
        x("resident.consume_wait", 215.0, 5.0, 1),
        x("resident.decode", 5.0, 60.0, 2),
        x("resident.decode", 110.0, 40.0, 2),
        x("resident.decode", 190.0, 45.0, 2),
        {"name": "resident.prefetch_issue", "ph": "i", "ts": 4.0, "pid": 1,
         "tid": 1, "s": "t"},
    ]


def test_overlap_report_equals_reference(tmp_path):
    events = _synthetic_trace()
    got = tanalysis.overlap_report(events)
    assert got == janalysis.overlap_report(events)
    assert 0 < got["overlap_fraction"] < 1 and got["n_decode_spans"] == 3
    assert tanalysis.overlap_report([])["overlap_fraction"] != \
        tanalysis.overlap_report([])["overlap_fraction"]       # NaN
    ivs = [(0.0, 5.0), (3.0, 8.0), (10.0, 12.0)]
    holes = [(1.0, 2.0), (11.0, 20.0)]
    assert tanalysis.union(ivs) == janalysis.union(ivs)
    assert tanalysis.subtract(ivs, holes) == janalysis.subtract(ivs, holes)
    assert tanalysis.intersect_total(ivs, holes) == \
        janalysis.intersect_total(ivs, holes)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert tanalysis.load_trace_events(str(path)) == events


@pytest.mark.parametrize("mode,flags", [
    ("continuous", ["--batch-slots", "3", "--traffic", "4", "--gen", "4",
                    "--prompt-len", "8"]),
    ("continuous", ["--batch-slots", "2", "--traffic", "2", "--gen", "2",
                    "--prompt-len", "4", "--prefill-chunk", "4",
                    "--resident", "compressed", "--fused"]),
    ("dense-lockstep", ["--batch", "1", "--gen", "2", "--prompt-len", "4"]),
    ("resident-lockstep", ["--batch", "1", "--gen", "2", "--prompt-len", "4",
                           "--resident", "compressed"]),
    ("resident-fused-lockstep", ["--batch", "1", "--gen", "2",
                                 "--prompt-len", "4", "--resident",
                                 "compressed", "--fused"]),
], ids=["continuous", "continuous-resident-fused", "dense-lockstep",
        "resident-lockstep", "resident-fused-lockstep"])
def test_launcher_trace_passes_check_trace(mode, flags, tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    serve = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--device", "cpu", "--decode-backend", "numpy",
         "--compress-spec", SPEC, *flags, "--trace-out", str(trace),
         "--metrics-out", str(metrics)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert serve.returncode == 0, serve.stderr
    check = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "check_trace.py"),
         "--trace", str(trace), "--metrics", str(metrics), "--expect",
         mode],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    assert f"all '{mode}' instrumentation points emitted" in check.stdout
