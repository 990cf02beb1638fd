"""The PyTorch port stands alone: nothing under ``src/repro_torch/`` and
nothing in ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``,
importing the port leaves ``jax`` out of ``sys.modules``, and the smoke
script refuses to run (non-zero exit, no result line) where it has no card
or no checkout around it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30, files
    return files


def _absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [(ln, mod) for ln, mod in _absolute_imports(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.core.decode_backends, "
            "repro_torch.kernels.huffman_decode, "
            "repro_torch.kernels.ans_decode, repro_torch.convert, "
            "repro_torch.kernels.fused_decode_matmul, "
            "repro_torch.kernels.ops, repro_torch.kernels.ref, "
            "repro_torch.serving.resident, repro_torch.serving.batching, "
            "repro_torch.obs.points, repro_torch.obs.analysis; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad; print('clean')")
    r = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_card_or_checkout(where, tmp_path):
    """With no CUDA device (here), or from a directory holding only the
    script, ``chip_smoke.py`` exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
