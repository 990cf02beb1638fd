"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: the JAX launcher's default mode, its summary line, a checkpoint,
and the refusal of the modes it does not port."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_trains_and_prints_the_summary(tmp_path):
    out = _run("--arch", "qwen3-1.7b", "--steps", "3", "--seq-len", "33",
               "--device", "cpu", "--checkpoint-dir", str(tmp_path),
               "--checkpoint-every", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert re.fullmatch(r"arch=qwen3-1\.7b-reduced steps=3 loss "
                        r"\d+\.\d{4} -> \d+\.\d{4} \(\d+\.\d{2} steps/s\)",
                        lines[0]), lines
    assert lines[1] == f"final checkpoint -> {tmp_path}"
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith("COMMIT")) \
        == ["step_000000002.COMMIT", "step_000000003.COMMIT"]


@pytest.mark.parametrize("flag", ["--production", "--multi-pod",
                                  "--shape=train_4k"])
def test_unported_modes_are_refused(flag):
    """The production modes are ported: ``--production`` dry-runs the
    train step (mamba2-370m x decode_32k here, a cell of seconds), and
    ``--multi-pod`` / ``--shape`` without it are refused."""
    if flag == "--production":
        out = _run("--arch", "mamba2-370m", flag, "--shape", "decode_32k")
        assert out.returncode == 0, out.stderr
        assert "== mamba2-370m x decode_32k on 16x16" in out.stdout
        return
    out = _run("--arch", "qwen3-1.7b", flag, "--device", "cpu")
    assert out.returncode == 2
    assert f"{flag.split('=')[0]} applies to --production only" in out.stderr
    assert out.stdout == ""


def test_the_card_is_the_default_device():
    out = _run("--arch", "qwen3-1.7b", "--steps", "1")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
