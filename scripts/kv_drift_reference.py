#!/usr/bin/env python3
"""Greedy-token drift of quantized paged KV blocks, in the JAX package and
in the PyTorch port, on the CPU.

Both packages serve the same requests (the first ``--requests`` of the
shared-prompt Poisson trace that ``chip_smoke.py``'s ``paged`` phase
replays: two 32-token system prompts, prompts up to 64 tokens, up to 16 new
tokens) through their continuous engines with 8 slots, prefill chunks of
16 and blocks of 16, on the same weights (the JAX package's
``PRNGKey(0)`` init, crossed to the port as numpy arrays), once with bf16
blocks and once each with 8- and 4-bit blocks.  Drift is the share of the
bf16 run's tokens that a run differs from, position by position (the JAX
package's measure, ``tests/test_kvcache.py``).

The geometry is the reduced qwen3-1.7b with the full vocabulary, and
optionally a wider model with qwen3-1.7b's head_dim of 128:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/kv_drift_reference.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/kv_drift_reference.py \\
        --d-model 512 --heads 4 --kv-heads 2 --head-dim 128 --layers 2

(≈ 30 s each).  Keep the widths small: this runs on the host.
"""
import argparse
import dataclasses
import json

import jax
import numpy as np

from repro.configs import registry as jreg
from repro.core.spec import KVCompressionSpec as JSpec
from repro.models import api as japi
from repro.serving import engine as jengine
from repro.serving.batching import ContinuousEngine as JEngine
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core.spec import KVCompressionSpec as TSpec
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import ContinuousEngine, poisson_trace

MAX_LEN = 96


def drift(got, want):
    return (sum(x != y for a, b in zip(got, want) for x, y in zip(a, b))
            / sum(len(b) for b in want))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--vocab", type=int, default=151936)
    p.add_argument("--d-model", type=int, default=0,
                   help="0 keeps the reduced config's widths")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=2)
    p.add_argument("--head-dim", type=int, default=128)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--requests", type=int, default=12)
    args = p.parse_args()
    over = dict(vocab=args.vocab)
    if args.d_model:
        over.update(d_model=args.d_model, n_heads=args.heads,
                    n_kv_heads=args.kv_heads, head_dim=args.head_dim,
                    d_ff=3 * args.d_model, n_layers=args.layers)
    jcfg = dataclasses.replace(jreg.reduced(jreg.get("qwen3-1.7b")), **over)
    tcfg = dataclasses.replace(treg.reduced(treg.get("qwen3-1.7b")), **over)
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(
        tcfg, {k: np.asarray(v, np.float32) for k, v in jp.items()}, "cpu")
    trace = poisson_trace(args.requests, rate_per_s=100.0, prompt_max=64,
                          gen_max=16, vocab=args.vocab, seed=0,
                          prefix_pool=2, prefix_len=32)
    jobs = [(prompt, gen) for _, prompt, gen in trace]

    def run_jax(bits):
        ce = JEngine(jcfg, jp, jengine.ServeConfig(max_len=MAX_LEN),
                     n_slots=8, prefill_chunk=16,
                     kv_spec=JSpec(bits=bits, block_size=16, sharing=True))
        reqs = [ce.submit(q, g) for q, g in jobs]
        ce.run()
        return [r.output for r in reqs]

    def run_port(bits):
        ce = ContinuousEngine(tcfg, tp, tengine.ServeConfig(max_len=MAX_LEN),
                              n_slots=8, prefill_chunk=16, device="cpu",
                              kv_spec=TSpec(bits=bits, block_size=16,
                                            sharing=True))
        reqs = [ce.submit(q, g) for q, g in jobs]
        ce.run()
        return [r.output for r in reqs]

    j16, t16 = run_jax(16), run_port(16)
    out = dict(d_model=jcfg.d_model, heads=[jcfg.n_heads, jcfg.n_kv_heads,
                                            jcfg.hd],
               layers=jcfg.n_layers, vocab=jcfg.vocab, requests=len(jobs),
               tokens=sum(len(o) for o in j16),
               bits16_port_vs_jax=drift(t16, j16))
    for bits in (8, 4):
        jq, tq = run_jax(bits), run_port(bits)
        out[f"bits{bits}"] = dict(jax_drift=drift(jq, j16),
                                  port_drift=drift(tq, t16),
                                  port_vs_jax=drift(tq, jq))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
