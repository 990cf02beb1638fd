#!/usr/bin/env python3
"""The op that splitting the KV heads over the model axis rests on, probed
alone: the port's attention, ``layers.gqa_attention``, over a block of heads.

On a mesh each model rank attends over its block of heads (q heads
``[i H/m, (i+1) H/m)`` with their KV heads ``[i KV/m, (i+1) KV/m)``) and
the head outputs are gathered before ``wo``.  q, k and v come from the same
full-width projections either way, and the gather moves data, so the
tokens stay bitwise exactly when attention over a head block equals the
same block of attention over every head.  This script checks that, at
qwen3-1.7b's heads (16 q, 8 KV, head dim 128), for every block of every
model axis that divides the KV heads (2, 4, 8), in the steps the mesh
phase of ``chip_smoke.py`` runs:

* ``prefill``: a data group's lockstep rows (2 of a batch of 4), 32
  prompt tokens, causal, no cache;
* ``decode``: the same rows, one token against a 48-row cache at its
  last position;
* ``slot_decode``: a data group's 2 of 4 slots, one token each at its own
  position in a 64-row cache;
* ``chunk``: one slot's 16-token prefill chunk at position 16.

Each case prints one JSON line with the largest |difference| over its
blocks and whether every block is bitwise; the first line is the card's
name and power limit (on a card).  Inputs are bf16 normals from a seed.

    PYTHONPATH=src python3 scripts/probe_head_split.py [--device cpu]
"""
import argparse
import json
import subprocess

import torch

from repro_torch.configs import registry
from repro_torch.models.layers import gqa_attention

CASES = {
    # name: (rows, q tokens, cache rows, q_offset, kv_len, causal)
    "prefill": (2, 32, 32, 0, None, True),
    "decode": (2, 1, 48, 47, 48, False),
    "slot_decode": (2, 1, 64, (40, 21), (41, 22), False),
    "chunk": (1, 16, 64, (16,), (32,), True),
}


def probe(name, dev, H, KV, hd, gen):
    B, S, T, off, kv_len, causal = CASES[name]
    if isinstance(off, tuple):
        off = torch.tensor(off, device=dev)
        kv_len = torch.tensor(kv_len, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
    q, k, v = normal(B, S, H, hd), normal(B, T, KV, hd), normal(B, T, KV, hd)
    whole = gqa_attention(q, k, v, causal=causal, q_offset=off,
                          kv_len=kv_len)
    worst, bitwise = 0.0, True
    for m in (m for m in (2, 4, 8) if KV % m == 0):
        h, kv = H // m, KV // m
        for i in range(m):
            part = gqa_attention(q[:, :, i * h:(i + 1) * h],
                                 k[:, :, i * kv:(i + 1) * kv],
                                 v[:, :, i * kv:(i + 1) * kv],
                                 causal=causal, q_offset=off, kv_len=kv_len)
            want = whole[:, :, i * h:(i + 1) * h]
            bitwise &= bool(torch.equal(part, want))
            worst = max(worst, float((part.float() - want.float())
                                     .abs().max()))
    return dict(case=name, rows=B, q_tokens=S, cache_rows=T,
                model_axes=[m for m in (2, 4, 8) if KV % m == 0],
                bitwise=bitwise, max_abs_diff=worst,
                max_abs_out=float(whole.float().abs().max()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    cfg = registry.get("qwen3-1.7b")
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for name in CASES:
            print(json.dumps(dict(probe(name, dev, cfg.n_heads,
                                        cfg.n_kv_heads, cfg.hd, gen),
                                  device=str(dev))), flush=True)


if __name__ == "__main__":
    main()
