#!/usr/bin/env python3
"""How far a wrong sharded layout moves the logits, beside how far the
sound one does: the limit of ``chip_smoke.py``'s ``sharded`` phase
(``SHARDED_TOL_STEPS`` bf16 steps at the largest |logit|) must lie between
the two.

Each case of ``chip_smoke.SHARDED_CASES`` (full width, gloo ranks sharing
the card) runs through ``chip_smoke.sharded_rank`` as the phase runs it —
prefill 4 x 32 and 16 decode steps fed one device's greedy tokens (and
router choices) — once
sound and once with each fault below planted in every rank (patched in
memory; no file changes):

* ``combine_without_max``: the split-T combine takes each block's exps
  against its own row maxima (the all-reduce max skipped);
* ``block_offset_zero``: each rank masks its block of a T split as if it
  began at position 0 (the block's global offset dropped);
* ``partial_sum_dropped``: a row-parallel product keeps this rank's
  partial sum (its S block of it where the carry is sequence-parallel)
  instead of the sum over the ranks;
* ``ssm_norm_local``: the SSM's gated RMS norm over this rank's block of
  the inner channels only (its sum of squares not summed across ranks);
* ``zx_swapped``: each rank's z and x blocks of ``in_zx`` swapped;
* ``cross_head_offset_dropped``: each rank's cross-attention K / V heads
  taken from the first block of ``wk`` / ``wv`` (the block's head offset
  dropped), against its own block of the query heads and of ``wo``.

The first two need a cache split along T (glm4-9b on 1 x 4), the SSM
faults mamba2-370m's heads split over model (1 x 2), the cross-attention
one seamless-m4t-medium; the row-parallel one runs in every case.  Prints
the card's name and power limit, then one JSON line a run: the largest
|logit delta| against one device, the logits' scale, that delta in bf16
steps at the scale, the phase's limit, and the steps whose greedy token
differs from one device's.  ``--arch A [--arch B]`` runs only those
archs' cases.

    python3 scripts/probe_sharded_faults.py [--arch mamba2-370m]
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402

# the (arch, serve_mode) cases each fault is planted in (None: every case)
FAULTS = {"combine_without_max": (("glm4-9b", "fsdp"),),
          "block_offset_zero": (("glm4-9b", "fsdp"),),
          "partial_sum_dropped": None,
          "ssm_norm_local": (("mamba2-370m", "fsdp"),),
          "zx_swapped": (("mamba2-370m", "fsdp"),),
          "cross_head_offset_dropped": (("seamless-m4t-medium", "fsdp"),)}


def plant(fault):
    """Patch ``fault`` into this process's port (see the module doc)."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import block_index, get_hints
    from repro_torch.models import dense, layers
    if fault == "combine_without_max":
        real = collectives.all_reduce

        def all_reduce(mesh, t, axes, op):
            return t if op == "max" else real(mesh, t, axes, op)
        collectives.all_reduce = all_reduce
    elif fault == "block_offset_zero":
        real_attn = dense.gqa_attention

        def gqa_attention(q, k, v, *, q_offset=0, kv_len=None, kv_axes=(),
                          **kw):
            if kv_axes:
                # the mask tests tpos + t0 against q_offset and kv_len:
                # shifting both by t0 masks as if t0 were 0
                t0 = block_index(get_hints().mesh, kv_axes)[1] * k.shape[1]
                q_offset = q_offset + t0
                kv_len = None if kv_len is None else kv_len + t0
            return real_attn(q, k, v, q_offset=q_offset, kv_len=kv_len,
                             kv_axes=kv_axes, **kw)
        dense.gqa_attention = gqa_attention
    elif fault == "partial_sum_dropped":
        def reduce_partial(y, axes, h, carry):
            if carry is not None and carry[1] is not None \
                    and layers._entry(carry[1]) == axes:
                return layers._cut(y, 1, carry[1], h.mesh)
            return y
        layers._reduce_partial = reduce_partial
    elif fault == "ssm_norm_local":
        from repro_torch.models import mamba2
        real_norm = mamba2.rms_norm

        def rms_norm(x, scale, eps=1e-6, *, x_axes=None, split=None):
            if x_axes is None:
                return real_norm(x, scale, eps, split=split)
            return real_norm(x, layers.local_weight(scale)[0], eps)
        mamba2.rms_norm = rms_norm
    elif fault == "zx_swapped":
        import torch
        from repro_torch.models import mamba2
        real_blocks = mamba2.zx_blocks

        def zx_blocks(w, n):
            half = w.shape[-1] // 2
            return real_blocks(torch.cat([w[..., half:], w[..., :half]], -1),
                               n)
        mamba2.zx_blocks = zx_blocks
    elif fault == "cross_head_offset_dropped":
        from repro_torch.distributed.ctx import Sharded
        from repro_torch.launch import specs
        real_place = specs.Cell.place

        def place(self, params):
            out = real_place(self, params)
            for name in ("dec/cross/wk", "dec/cross/wv"):
                if name not in params:
                    continue
                t = params[name]
                entries = self.param_specs[name].padded(t.dim())
                for d, e in enumerate(entries):
                    if e is not None:
                        size, i = block_index(self.mesh, e)
                        n = t.shape[d] // size
                        t = t.narrow(d, 0 if e == "model" else i * n, n)
                out[name] = Sharded(t.clone(), entries)
            return out
        specs.Cell.place = place
    elif fault is not None:
        raise ValueError(fault)


def faulty_rank(mesh, fault, arch, mode, prompt, fed, routes):
    """``chip_smoke.sharded_rank`` with ``fault`` planted first."""
    plant(fault)
    return chip_smoke.sharded_rank(mesh, arch, mode, prompt, fed, routes)


def reading(got, want):
    """The largest |logit delta| and the steps whose greedy token differs,
    rank 0's logits against one device's."""
    import numpy as np
    scale = max(float(np.abs(w).max()) for w in want["logits"])
    by_step = [float(np.abs(g - w).max())
               for g, w in zip(got["logits"], want["logits"])]
    err = max(by_step)
    differ = int((got["tokens"] != want["tokens"]).sum())
    step = chip_smoke.bf16_step(scale)
    return dict(max_abs_delta=err, logit_scale=scale,
                bf16_steps=err / step,
                limit=chip_smoke.SHARDED_TOL_STEPS * step,
                tokens_differ=differ, tokens=int(got["tokens"].size),
                by_step=by_step)


def main(argv=None) -> int:
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", action="append", default=None,
                   help="run only this arch's cases (repeatable)")
    archs = p.parse_args(argv).arch
    if not torch.cuda.is_available():
        print("probe_sharded_faults: no CUDA device available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    dev = torch.device("cuda")
    for arch, shape, mode in chip_smoke.SHARDED_CASES:
        if archs and arch not in archs:
            continue
        prompt, _ = chip_smoke.sharded_inputs(chip_smoke.sharded_config(arch))
        want = chip_smoke.sharded_single(arch, prompt, dev)
        fed = want["tokens"][:, :chip_smoke.GEN]
        for fault in [None] + [f for f, only in FAULTS.items()
                               if only is None or (arch, mode) in only]:
            t0 = time.perf_counter()
            got, _ = chip_smoke.mesh_spawn(
                faulty_rank, shape,
                (fault, arch, mode, prompt, fed, want["routes"]))
            print(json.dumps(dict(arch=arch, mesh=list(shape),
                                  serve_mode=mode, fault=fault or "none",
                                  wall_s=time.perf_counter() - t0,
                                  **reading(got[0], want))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
