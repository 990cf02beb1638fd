#!/usr/bin/env python3
"""Ablations of ``dequant_matmul``'s ring variant at ``lm_head``'s shape:
which part of a stage's work holds the 128-row tile back.

Each variant is a copy of this checkout's ``src/`` under
``build/ablate/<variant>/src`` with one textual edit of the ring kernel in
``csrc/dequant_matmul.cu`` that takes one piece of a stage's work out.
An ablated kernel's output is wrong, so only its time is read (the
unchanged ``base`` is held within 1e-2 of the plain version).  Variants:

- ``base``: unchanged;
- ``no_dequant``: a uint8 B register is the two raw shared words xor'ed
  (the shared loads kept; the byte-to-float, multiply, add and bf16 pack
  gone);
- ``one_a``: one ``ldmatrix`` a k16 step, row tile 0's A fragment reused
  for every row tile (a 128-row tile's A loads cut to one in eight);
- ``no_dequant_one_a``: both;
- ``no_mma``: each ``mma.sync`` replaced by two xors and an add of A's
  first register and both B registers (the loads and the dequant kept);
- ``no_x_copy``: x's ``cp.async`` copies not issued (the weight's kept).

``lm_head`` (uint8, 2048 x 152064, per-tensor affine) at M = 128 and 4,
as the wrapper plans it (128 and 16 rows a tile, unsplit).  Each variant
runs in a process of its own, in the order base, the ablations, base;
the libraries are built first, all at once.  A line a (variant, M): the
median, least and most device ms of ``LAUNCHES`` launches queued behind a
spin kernel, warm and cold (L2 flushed by a 256 MB write before each),
beside ``torch.matmul`` on the weight dequantized to bf16 beforehand (a
floor, not the same function).  The first line is the card's name and
power limit.  Needs an NVIDIA card:

    python3 scripts/ablate_dequant_ring.py
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("repro_torch/csrc/dequant_matmul.cu")
LAUNCHES, TOL = 25, 1e-2
K, N, MS = 2048, 152064, (128, 4)

_A_LOAD = """#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        load_a(a, xsl + (16 * i + lane % 16) * kLds + 16 * kk +
                      8 * (lane / 16));
"""
_ONE_A = """      uint32_t a[4];
      load_a(a, xsl + (lane % 16) * kLds + 16 * kk + 8 * (lane / 16));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
"""
_DEQ = "b[j][h] = deq_pair(byte_f32(v0, j), byte_f32(v1, j), s[j], z[j]);"
_RAW = "b[j][h] = v0 ^ (v1 >> j);"
_MMA = "for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);"
_XOR = ("for (int j = 0; j < 4; ++j) "
        "acc[i][j][0] += __uint_as_float(a[0] ^ b[j][0] ^ b[j][1]);")
_X_COPY = ("copy16(xd + r * kLds + kc, ok ? x + int64_t(m) * K + k : x, "
           "ok);")
_NO_X_COPY = "(void)xd; (void)ok;"
VARIANTS = {
    "base": [],
    "no_dequant": [(_DEQ, _RAW)],
    "one_a": [(_A_LOAD, _ONE_A)],
    "no_dequant_one_a": [(_DEQ, _RAW), (_A_LOAD, _ONE_A)],
    "no_mma": [(_MMA, _XOR)],
    "no_x_copy": [(_X_COPY, _NO_X_COPY)],
}


def make_tree(name: str) -> Path:
    """``build/ablate/<name>/src``: this checkout's ``src/`` with the
    variant's edits, each of which must match exactly once."""
    tree = ROOT / "build" / "ablate" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / "src" / KERNEL
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            sys.exit(f"{name}: the edit's text occurs {text.count(old)} "
                     f"times in {KERNEL}")
        text = text.replace(old, new)
    path.write_text(text)
    return tree / "src"


def run_variant(name: str) -> None:
    """Time ``lm_head`` through the ``repro_torch`` on ``sys.path``."""
    import numpy as np
    import torch
    from chip_smoke import queued_launch_ms, smi
    from repro_torch.kernels import dequant_matmul as dm

    dev = torch.device("cuda")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    rng = np.random.default_rng(0)
    wq = torch.from_numpy(rng.integers(0, 256, (K, N), dtype=np.uint8)).to(dev)
    scale = torch.tensor(0.004, dtype=torch.float32, device=dev)
    zero = torch.tensor(-0.03, dtype=torch.float32, device=dev)
    w_bf16 = (wq.float() * scale + zero).to(torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    for M in MS:
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(
            np.float32)).to(dev, torch.bfloat16)

        def fn():
            return dm.dequant_matmul(x, wq, scale, zero)
        got = fn()
        p = dm.launch_plan(dev)
        ref = dm.dequant_matmul_plain(x, wq, scale, zero)
        err = float((got.float() - ref.float()).abs().max())
        close = bool(torch.allclose(got.float(), ref.float(), atol=TOL,
                                    rtol=TOL))
        del ref
        if name == "base" and not close:
            sys.exit(f"base differs from the plain version by {err}")
        row = dict(variant=name, tensor="lm_head", shape=[M, K, N],
                   plan=dict(variant=p.variant, bm=p.bm, splits=p.splits),
                   max_abs_err=err)
        for key, kw in (("warm", {}), ("cold", {"flush": flush})):
            t = queued_launch_ms(fn, LAUNCHES, clock_mhz, **kw)
            d = queued_launch_ms(lambda: torch.matmul(x, w_bf16), LAUNCHES,
                                 clock_mhz, **kw)
            row[f"{key}_ms"] = dict(median=t[len(t) // 2], min=t[0],
                                    max=t[-1])
            row[f"dense_bf16_{key}_ms"] = d[len(d) // 2]
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=VARIANTS,
                    help="time this variant's tree, already made")
    args = ap.parse_args()
    if args.variant:
        sys.path.insert(0, str(ROOT))
        sys.path.insert(0, str(ROOT / "build" / "ablate" / args.variant /
                               "src"))
        run_variant(args.variant)
        return
    sys.path.insert(0, str(ROOT))
    import torch
    from chip_smoke import smi
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    print(smi("name,power.limit"), flush=True)
    trees = {name: make_tree(name) for name in VARIANTS}
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.build()"], env=dict(os.environ, PYTHONPATH=str(tree)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tree in trees.items()}
    for name, proc in builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"{name} did not build:\n{out[-4000:]}")
    for name in [*VARIANTS, "base"]:
        subprocess.run([sys.executable, __file__, "--variant", name],
                       check=True)


if __name__ == "__main__":
    main()
