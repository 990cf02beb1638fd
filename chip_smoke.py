#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --train-only`` builds the kernels and runs phase
10 alone, a quicker rehearsal of it; ``--production-only`` runs phase 11
alone and ``--sharded-only`` phase 12; none prints a result line.)

Phases, each printing one JSON line:

1. device  — the card's name and count; the next line is nvidia-smi's
   ``name, power.limit`` for the card.
2. build   — compiles the CUDA kernels (every ``.cu`` under
   ``src/repro_torch/csrc/``: the decode kernels, the fused
   decode→dequant→matmul kernels and the dequant→matmul kernel) from the
   checkout's sources, one ``nvcc`` per source started together, linked
   into one library.
3. serve   — the main path at full width: qwen3-1.7b (d_model 2048, 16 heads
   and 8 KV heads of 128, d_ff 6144, padded vocab 152064, qk-norm) with its
   depth cut from 28 to ``DEPTH`` layers and seeded random weights.  The
   weights are compressed under ``SPEC`` (Huffman-8 embed, lm_head and
   ``wo``, rANS-4 for the other layer matrices, fp32 norms) by a child started
   first, saved and loaded as a container, decoded onto the card through the
   ``cuda`` backend (both decode kernels), held bitwise against the symbols
   ``quant.quantize`` gives, and served with ``Engine.generate`` (batch 4,
   prompt 32, 16 greedy tokens).  Launch counts are zeroed just before the load
   and read just after the generate, and must equal the load plan's chunks of
   each kernel (as in the moe, ssm and encdec phases).
   Then ``profile``: the same few decode steps timed without and then with
   ``torch.profiler``, and device time by operator under it.
   Then ``continuous``: the same decoded weights serve a seeded Poisson
   trace (``TRAFFIC``: 16 requests at 100 / s, ragged prompts of 4–32 and
   2–16 new tokens, arrivals replayed on the host clock) through the
   ``ContinuousEngine`` (8 slots, prefill chunks of 16, queue bound 64,
   ``max_len`` 64: the launcher's ``--batch-slots 8 --traffic 16
   --prompt-len 32 --gen 16``).  Every request's greedy tokens are held
   against its solo ``Engine.generate`` (cuBLAS may sum 8 rows in another
   order than 1, so the count that agree bitwise is reported, with the
   first diverging request and step), and request 0's chunked-prefill
   logit at its last prompt position against the lockstep prefill's,
   within ``REF_ATOL``.  Then the same trace on a fresh compressed-resident
   fused store: launch counts zeroed just before the store is built and
   read after the replay, once the worker has finished the last prefetch;
   the fused launches must equal 5 fused matrices x 2 layers a forward,
   with forwards = decode steps + the prompts' prefill chunks, and
   ``ans_decode`` the fallback's calls a forward x forwards + the last
   prefetch's; tokens are compared with the dense run's, and request 0's
   chunked-prefill logits with the dense engine's, within ``REF_ATOL``.
   Then ``paged``: the same decoded weights serve ``PAGED_TRAFFIC`` (24
   requests over two shared 32-token system prompts, prompts up to 64
   tokens, ``max_len`` 96: the launcher's ``--batch-slots 8 --traffic 24
   --prompt-len 64 --gen 16 --prefix-sharing``) through the slot pool and
   through the paged KV cache (``PAGED_RUNS``): bf16 blocks of 16 with
   prefix sharing, held bitwise to the slot pool request by request, with
   prefix hits; 8-bit blocks; and 4-bit blocks in a pool of
   ``PAGED_TIGHT_BLOCKS``, run twice, which must evict to the cold tier
   and give equal tokens.  Every run completes all requests with none
   shed; a ``paged_drift`` line gives the token drift against bf16 blocks
   (8-bit held to ``PAGED_DRIFT``, see there); a ``kv_logits`` line holds
   every trace prompt's first-token logits through bf16 blocks bitwise to
   the bf16 slot cache's and through 8-, 4-bit blocks and the int8 slot
   cache within ``KV_LOGITS_TOL``, against a wrong-context control; two
   ``profile`` lines time 8 paged decode steps at bits 16 and 4; an
   ``int8_cache`` line runs the lockstep prompt on the int8 slot cache
   against bf16 (logits within ``KV_LOGITS_TOL``).  Launch counts are
   zeroed before the phase and must read 0 after it.
   Then ``fleet``: ``TRAFFIC``'s 16 jobs through ``FleetDriver`` replicas
   of ``FLEET_SLOTS`` slots (prefill chunks of 16, ``max_len`` 64) on the
   same decoded weights, each request's tokens asserted **bitwise** those
   of a single ``ContinuousEngine`` with as many slots (the same step
   shapes), every request dispatched and finished once, none shed; one
   ``fleet`` line a run with its wall time, fleet steps and aggregate
   tok/s.  Runs: ``dp`` (1, 2 and 3 replicas sharing one weight tree, under
   ``round-robin`` and ``least-loaded``, lockstep); ``kill`` (3 replicas,
   replica 1 killed once its engine has taken 3 decode steps: evacuated >=
   1, ``fleet.redrives`` equal to it); ``disagg`` (a 1:1 prefill / decode
   split on bf16 blocks of 16 and a 1:2 on 8-bit rANS blocks, against a
   single paged engine with the same spec; 16 handoffs, 16 delivered; the
   bytes on the wire against the exported blocks' raw bytes, and the
   summed ``fleet.handoff_encode`` / ``fleet.handoff_adopt`` spans), plus
   one sampled request (temperature 0.8, seed 7) through the 1:1 split
   against its single paged run; ``weights`` (``from_container`` with one
   copy a replica: the decode kernels launched twice the load plan's
   chunks, ``weight_bytes`` two copies where sharing gives one, peak device
   memory); ``threaded`` (1 and 2 replicas, one worker thread each, on
   ``TRAFFIC``'s arrival times: recorded, nothing gated on speed).  Launch
   counts are zeroed before the phase.
   Then ``mesh``: the serve phase's container (kept under ``build/``) on
   a ``MESH`` (2 x 2, data x model) world of ranks, one process each,
   sharing the card over ``gloo`` (NCCL refuses two ranks on one device).
   Each rank loads through the ``cuda`` backend with the mesh's placer
   (its decode launches must equal the load plan's), keeps its blocks of
   the weights along their output channels (its bytes must equal what the
   resolved exact-TP specs give a rank, below one device's), serves the
   lockstep prompt (tokens bitwise the serve phase's) and ``TRAFFIC``'s 16
   jobs through a ``FLEET_SLOTS``-slot ``ContinuousEngine(mesh=)`` (each
   bitwise the fleet phase's single 4-slot engine), attending over its
   block of the KV heads: its lockstep cache and slot pool must hold a
   quarter of one device's (its rows, its heads).  After the moe phase,
   its container on ``MESH_MOE`` (1 x 2): exact-TP lockstep bitwise the
   moe phase's tokens with half the cache a rank, and layer 0's feed-forward through expert
   parallelism (32 experts a rank) against the single-device forward
   within ``EP_TOL``.  One ``mesh`` line a run (``lockstep``,
   ``continuous``, ``moe``) with every rank's bytes, collectives, load
   and wall times; the ranks share one card, so its speeds are not
   multi-card figures.  Any failed or hung rank fails the script.
4. dequant_matmul — the third path: the weights the serve phase decoded
   on the card through the decode kernels go through
   ``kernels.ops.dequant_matmul`` (the port of the JAX package's
   ``ops.dequant_matmul``): layer 0's seven quantized matrices (rANS-4 ones
   re-packed along K, ``wo`` uint8) and ``lm_head`` (uint8, 2048 x
   152064, 311 MB), plus ``w_down`` with a seeded per-channel affine, each
   at M = 4 and 128.  Launch counts are zeroed just before those calls and
   read just after.  Each case is then held within ``DQ_TOL`` of the plain
   version and bitwise on one-hot rows, and timed with L2 flushed before
   every launch, host-paced as every other row (and the median of
   launches queued behind a spin kernel, the device's time alone), beside
   ``torch.matmul`` on the weight dequantized beforehand (a floor, not the
   same function); each row names the launch plan that ran, as the wrapper
   recorded it at the main path's call (the kernel's variant, rows a tile,
   splits of K and workspace bytes).
5. resident — the second path, on the same container: compressed-resident
   serving with ``fused=True``.  ``wo`` (Huffman-8) goes through the fused
   prefix kernel, ``wq``, ``wk``, ``wv`` and ``w_down`` (rANS-4) through the
   fused tANS kernel, and ``w_gate`` / ``w_up`` (rows of 6144, which a
   65,536-symbol segment does not tile) fall back to the per-layer decode
   through the ``cuda`` decode kernels on the worker thread.  Launch counts
   are zeroed just before the weights are built and read just after the
   generate, once the worker has finished the prefetch the last forward
   left in flight; each count must equal what the code gives (the fused
   kernels once a forward for each fused matrix of each layer, the
   fallback's ``ans_decode`` calls once a layer and forward plus the last
   prefetch's), and the prefill logits are held to the dense-resident
   engine's.
6. reference — the reduced qwen3-1.7b served on the card and on the CPU
   through the same port, dense-resident and compressed-resident fused:
   decoded weights must be identical and prefill logits within
   ``REF_ATOL``; greedy token agreement is reported.  Then the reduced
   qwen2-moe-a2.7b the same way, dense-resident: weights identical, every
   router choice of the prefill compared (one that differs is reported
   with its probability gap and must be a near-tie, two bf16 steps), and
   the logits held within ``REF_ATOL`` when every choice agrees.  Then the
   reduced mamba2-370m, jamba-1.5-large-398b and seamless-m4t-medium the
   same way (``FAMILY_SPEC``; the hybrid's router choice by choice).
   This phase runs first, after the build, while a child encodes the
   serve phase's container (the moe, ssm and encdec containers are
   encoded by children too, beside the phases before theirs).
7. kernels — each decode kernel on the first chunk the main path decoded
   with it, held bitwise against its plain PyTorch version on the card, with
   its time (``ms``: launches paced by the host, as every row is timed),
   its device time with the launches queued behind a spin kernel
   (``device_queued_ms``), the plain version's time, its bounds, and the
   time of the whole ``cuda`` backend call around it (host matrix in, host
   symbols out).  Each row carries the SM cycles its longest block took in
   the last timed launch, as the kernel read them (``clock64``), and those
   over the chunk's largest count (``cycles_per_step``; for the tANS chain,
   one dependent step); the prefix row also the sync passes the split
   decode took (the largest of a stream).  Each line also carries a
   labelled estimate that no run reads directly: the host round trip as
   backend call time minus kernel time.
   Then the raw codec's identity table through the prefix kernel, at 4 and
   8 bits.  Then the fused kernels on layer 0's handles of the resident
   path at M = 4 and 128 and the continuous path's M = 8 (slots) and 16
   (a prefill chunk): ``wo`` (prefix) and ``wq`` (tANS; 64 lanes of
   65,536 symbols, K = N = 2048) within ``FUSED_TOL`` of the plain
   version, ``wk`` (K = 2048, N = 1024) and ``w_down`` (K = 6144, 192
   lanes) within it of ``x @ deq(symbols)``; all bitwise on one-hot rows
   and over two launches, with the kernel's sync passes or cycles a step,
   the partial buffer's bytes and a dense bf16 matmul floor.

8. moe — qwen2-moe-a2.7b at full width (d_model 2048, 16 heads and 16 KV
   heads of 128, 60 routed experts of d_ff 1408 padded to 64, top-4, 4
   shared, padded vocab 152064) with its depth cut from 24 to
   ``MOE_DEPTH`` and seeded random weights made on the host, compressed
   under ``SPEC`` by a child process (``--containers DIR moe``) that the
   script starts first, so the encode runs beside the qwen3 phases.  On its
   container, in order: dense-resident load through both decode kernels,
   every tensor held bitwise, ``Engine.generate`` as the serve phase runs
   it and a ``profile`` of its decode steps; the ``TRAFFIC`` trace through
   the ``ContinuousEngine`` at the published capacity factor (its
   low-capacity warning must fire; agreement with solo runs reported);
   the trace's requests all submitted at once through the slot pool and
   through bf16 paged blocks of 16 (bitwise equal, request by request; no
   kernel launch); compressed-resident fused serving (``MOE_FUSED`` fused,
   the 4-D expert stacks and the shared gate / up on the per-layer
   decode, launch counts exact, the port's spans summed over the
   generate); and the fused kernels at the router's and
   ``shared_w_down``'s shapes, held as the qwen3 rows are.
9. ssm, encdec — the families that serve lockstep and dense-resident only
   (in the JAX package too), from a second child (``--containers DIR ssm
   encdec``, started once the serve phase is measured) that encodes
   mamba2-370m whole (48 layers, d_model 1024, 32 SSD heads
   of 64, d_state 128, tied embeddings, padded vocab 50688; 368 M symbols)
   and seamless-m4t-medium at full width (d_model 1024, 16 heads of 64,
   d_ff 4096, padded vocab 256512) cut to ``ENCDEC_DEPTH`` encoder and
   decoder layers, each under its ``FAMILY_SPEC`` (the SSM's ``A_log``,
   ``dt_bias``, ``D_skip`` and conv weights kept float32).  Each: the
   load through both decode kernels, its launch counts equal to the load
   plan's chunks, every tensor held bitwise, ``Engine.generate`` (batch 4,
   prompt 32 (and ``SRC_FRAMES`` frames), 16 tokens), decode at S-1 held to
   prefill over S (the logits within ``EXTEND_TOL``, every leaf of the
   cache it leaves within ``EXTEND_STATE_RTOL`` of the prefill's, layer by
   layer) and a ``profile`` of 8 decode steps; ``cache_bytes`` is the
   prefill's cache.  The ssm line adds the bytes a layer and row, a
   ``LONG_PROMPT``-token prompt (three SSD chunks, the last partial) and
   ``ssd_chunked`` against a loop of ``ssd_step`` at ``SSD_SHAPE``
   (``SSD_TOL``).  The hybrid does
   not fit the card at full width and runs reduced in phase 6 only.

10. train — the training path, last: qwen3-1.7b, the published config
   whole (28 layers, d_model 2048, 16 / 8 heads of 128, d_ff 6144, padded
   vocab 152064, untied ``lm_head``; 2,032,264,192 parameters), seeded on
   the card, trained ``TRAIN_STEPS`` steps by ``train_loop.train`` on
   ``SyntheticSource`` batches of 8 x 128 tokens (remat on, f32 moments,
   ``TRAIN_SCHEDULE``).  Runs, one ``train`` line each: ``full`` (every
   loss and gradient norm finite, the step count, the loss falls by more
   than ``TRAIN_DROP``; step times, tokens/s, ``mfu``, peak memory and a
   profiled step); ``q8`` (EntroLLM-quantized moments: their bytes against
   f32 moments'; the JAX package's 0.15 criterion recorded, since its Q8
   moments fail it at this vocabulary too); ``unbind`` (the forward's
   layer views by one ``unbind`` a leaf against one ``select`` a layer:
   step time, peak, equal losses); ``microbatch`` (1 against 2
   microbatches, ``TRAIN_MB_TOL``); ``compress`` (int8 gradient wire
   format) and ``ste`` (8-bit weight gathers, straight-through), each
   falling, ``ste`` within ``TRAIN_STE_TOL`` of ``full``; ``restart``
   (``DEPTH`` layers, Q8 moments: an async checkpoint at step 5, a
   restore into fresh trees on the card, steps 5-9 again within
   ``RESTART_TOL`` and the count that are bitwise, and the gradients of one
   step run twice compared, to name an op that is not deterministic);
   ``entro`` (the reduced model saved under ``ENTRO_SPEC``, restored on the
   card through both decode kernels, launches equal to the restore plan's
   chunks, every leaf bitwise a CPU restore, 3 more steps); ``reference``
   (one step of the reduced qwen3-1.7b and qwen2-moe-a2.7b on the card
   and on the CPU: ``TRAIN_REF``, router choices compared).

11. production — the production dry-run (``launch/dryrun.py``) and its
   check on the card.  (a) Every applicable cell of ``PROD_ARCHS`` on the
   16 x 16 mesh, dry-run on the host in ``PROD_WORKERS`` processes, started
   after the serve phase, while the card works: one ``production`` line a cell
   (per-rank arguments and peak, ``fits``, the three H100-priced terms,
   ``dominant``, ``flops_ratio``).  (b) qwen3-1.7b whole on the card at 1 x 1
   (one data rank's share of a 16 x 16 cell with ``model`` at 1):
   ``prefill_32k`` at one row in query blocks of 1,024 and ``decode_32k`` at 8
   rows over a 32,768-row cache, each dry-run and run (``dryrun.run_on_device``): the
   measured step and ``max_memory_allocated`` beside the predicted
   ``step_s`` and peak, which must be within ``PROD_PEAK_RTOL``; logits
   finite.  (c) One ``mesh`` line (``run`` ``train``): qwen3-1.7b at full
   width cut to ``PROD_TRAIN["layers"]`` layers trained
   ``PROD_TRAIN["steps"]`` steps on ``PROD_TRAIN_MESH`` gloo ranks sharing
   the card, against the single-device step on the card
   (``PROD_TRAIN_TOL``).  No kernel runs on this path: launch counts are
   zeroed before the phase and must read 0 after it.

12. sharded — the production cells' sharded compute (``launch/specs.py``
   under the reference's sharding hints: column- and row-parallel
   matmuls, sequence-parallel carries, the cache split along T with the
   exact combine, the weight-stationary decode, an SSM's heads split
   over model) on ``SHARDED_CASES``: qwen3-1.7b, glm4-9b and mamba2-370m
   at full width cut to ``DEPTH`` layers, seamless-m4t-medium to
   ``ENCDEC_DEPTH`` + ``ENCDEC_DEPTH``, one period of jamba-1.5-large-398b
   at its published widths (``SHARDED_HYBRID_CUT``), on gloo ranks sharing
   the card (``launch/mesh.spawn``).  Each rank draws the same seeded
   weights the single device draws, a tensor at a time
   (``sharded_weights``), cuts its blocks by the cells' specs
   (``Cell.place``, ``local_block``), prefills the batch of 4 x 32 and
   runs ``GEN`` decode steps through the cells' step functions, fed the
   single device's greedy tokens; logits within ``SHARDED_TOL_STEPS`` bf16
   steps of the single device's (at the largest |logit|) and tokens equal
   up to a near-tie (``sharded_compare``; a routed config is fed one
   device's router choices too, ``replayed_routes``).  One
   ``sharded`` line a case: its cut, wall time, collective counts, weight
   and cache bytes a rank beside one device's.  Then ``SHARDED_TRAIN_CASES``
   (qwen3-1.7b, qwen2-moe-a2.7b, seamless-m4t-medium with its source
   frames, mamba2-370m with its ``in_zx`` re-blocked for its heads,
   jamba-1.5-large-398b cut to one Mamba and one attention block at its
   published widths, ``SHARDED_TRAIN_HYBRID_CUT``): 2
   steps of the train cells' step under their sharded-compute hints
   (``specs.train_contexts``), held to one device's steps on the card
   within ``SHARDED_TRAIN_TOL``, ``q8_gather``'s symbols bitwise; one
   ``sharded`` ``run: train`` line a case.  No kernel runs on this path
   (launches must read 0).

13. static — the port's static-analysis gate, ``python -m
   repro_torch.analysis --json`` (twin, dtype, host-boundary,
   kernel-wrapper, lock and catalog rules against
   ``src/repro_torch/analysis/baseline.json``), run by a child process on
   the host with no card visible, started beside the encode children; read
   last.  One ``static`` line: each rule's finding count, the baselined
   count, stale baseline entries, the analysis's own seconds and the
   child's wall time (start to its output's last write).  Any new finding fails the script.  No kernel runs.

Then the ``kernels`` summary line (measured fields and ``bound_ms`` only;
``launches_continuous``: each kernel's launches on the continuous phase's
compressed-resident run; ``launches_paged``: on the paged phase, 0;
``launches_fleet``: on the fleet phase, its per-replica load's;
``launches_mesh``: rank 0's on the mesh phase's qwen3 and moe worlds;
``launches_moe``: on the moe phase's dense-resident load and generate and
on its compressed-resident generate; ``launches_ssm`` /
``launches_encdec``: on those phases' load and generate; ``launches_train``:
on the train phase's entro restore; ``launches_production``: on the
production phase, 0; ``launches_sharded``: on the sharded phase, 0), and
as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits nonzero; without a CUDA device it exits 1 and prints no result.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
DEPTH = 2
# the encdec's encoder and decoder layers where it runs cut (its phase, the
# sharded cases; see SRC_FRAMES)
ENCDEC_DEPTH = 2
SPEC = ("*norm*:fp32; layers/wo:bits=8,codec=huffman; "
        "layers/*:bits=4,codec=rans; *:bits=8,codec=huffman")
SERVE_ARCH = "qwen3-1.7b"
BATCH, PROMPT, GEN = 4, 32, 16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# integer work of one decode step (window bytes, shift, mask, table loads,
# add), against the data sheet's non-tensor float32 peak: the card's
# fastest scalar rate, so this bound errs low
OPS_PER_SYMBOL = 12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12       # dense bf16 tensor-core peak
# what the resident phase must fuse and what must fall back, and why
FUSED = {"layers/wo": "prefix", "layers/wq": "tans", "layers/wk": "tans",
         "layers/wv": "tans", "layers/w_down": "tans"}
FALLBACK = "segment of 65536 symbols does not tile rows of width 6144"
# fused kernel vs its plain version: the kernel sums a lane's rows in order
# and the lanes in order, cuBLAS in its own order; both sum exact bf16
# products in float32, so outputs differ by rounding only (the JAX package
# holds its own fused kernel to the same 1e-2)
FUSED_TOL = 1e-2
# the fused kernel rows: layer 0's handles at the resident path's four
# shapes, and whether each is held against the plain version
FUSED_ROWS = (("wo", True), ("wq", True), ("wk", False), ("w_down", False))
# the continuous phase: the launcher's --batch-slots 8 --traffic 16
# --prompt-len 32 --gen 16 (max_len = prompt + gen + one chunk of headroom)
N_SLOTS, PREFILL_CHUNK, MAX_QUEUE = 8, 16, 64
CONT_MAX_LEN = PROMPT + GEN + PREFILL_CHUNK
TRAFFIC = dict(n_requests=16, rate_per_s=100.0, prompt_max=PROMPT,
               gen_max=GEN, seed=0)
# the paged phase: the launcher's --batch-slots 8 --traffic 24 --prompt-len
# 64 --gen 16 --prefix-sharing (two 32-token system prompts, two blocks
# each; max_len = 64 + 16 + one chunk = 6 blocks of 16)
PAGED_BLOCK = 16
PAGED_MAX_LEN = 64 + GEN + PREFILL_CHUNK
PAGED_TRAFFIC = dict(n_requests=24, rate_per_s=100.0, prompt_max=64,
                     gen_max=GEN, seed=0, prefix_pool=2, prefix_len=32)
# the runs: the slot pool (the yardstick), then paged pools by their
# --kv-spec; the tight 4-bit pool holds trash + three max-length requests,
# so published blocks at refcount 0 go to the cold tier, and runs twice
PAGED_TIGHT_BLOCKS = 1 + 3 * (PAGED_MAX_LEN // PAGED_BLOCK)
PAGED_RUNS = (
    ("slot-pool", None, None),
    ("bits16", "bits=16,block=16,sharing", None),
    ("bits8", "bits=8,block=16,codec=rans,sharing", None),
    ("bits4-tight", "bits=4,block=16,codec=rans,sharing", PAGED_TIGHT_BLOCKS),
    ("bits4-tight-again", "bits=4,block=16,codec=rans,sharing",
     PAGED_TIGHT_BLOCKS))
# quantized pools may change greedy tokens: at most this share of them
# against bf16 blocks, the JAX package's own bound (tests/test_kvcache.py,
# set on the reduced qwen3-1.7b, head_dim 32).  At full width (head_dim 128,
# the full vocabulary) 4-bit blocks drift past it in the JAX package itself
# (scripts/kv_drift_reference.py), so the 4-bit drift is reported and held
# through its logits instead (KV_LOGITS_TOL)
PAGED_DRIFT = 0.6
# the first generated token's logits (each trace prompt prefilled alone)
# through quantized KV may differ from the bf16 slot cache's by at most
# these; a wrong context (the other system prompt, in bf16: what a stale
# block table or garbage prefix blocks give) must move them by more than
# KV_CONTEXT_MARGIN times the widest, or a limit could not tell it apart.
# Readings on an H100 at this width: 8-bit blocks 0.141, 4-bit 1.032, the
# int8 slot cache 0.102 (and 0.102 over the int8_cache line's shared
# histories); the wrong context at least 5.06
KV_LOGITS_TOL = {"bits8": 0.5, "bits4": 2.0, "int8": 0.5}
KV_CONTEXT_MARGIN = 2.0
# the fleet phase: TRAFFIC's 16 jobs (max_len CONT_MAX_LEN, chunks of
# PREFILL_CHUNK) through replicas of FLEET_SLOTS slots (the JAX package's
# default), against a single engine with as many slots: the same step shapes
# (all lanes a decode step, (1, chunk) a prefill chunk), so each request's
# tokens must be bitwise the single engine's
FLEET_SLOTS = 4
FLEET_REPLICAS = (1, 2, 3)
FLEET_KILL = dict(replicas=3, victim=1, after_decode_steps=3)
FLEET_DISAGG = (((1, 1), "bits=16,block=16"),
                ((1, 2), "bits=8,codec=rans,block=16"))
FLEET_SAMPLED = dict(temperature=0.8, seed=7)
# the mesh phase: the serve phase's container on a MESH (data x model) of
# ranks, one process each, sharing the one card over gloo (NCCL refuses two
# ranks on one device); the moe phase's container on MESH_MOE.  Every rank
# must reach its verdict within MESH_TIMEOUT_S
MESH = (2, 2)
MESH_MOE = (1, 2)
MESH_BACKEND = "gloo"
MESH_TIMEOUT_S = 300
# the sharded phase: the production cells' sharded compute at full width
# on ranks sharing the card over gloo: (arch, (data, model), serve_mode).
# qwen3's 8 KV heads split over a model axis of 2; glm4's 2 do not divide 4,
# so its cache rests split along T and decode combines the blocks; the
# stationary decode keeps every weight where it rests on 2 x 1.  DEPTH
# layers, but the encdec's ENCDEC_DEPTH encoder and decoder layers and the
# hybrid's one period (sharded_config).  mamba2's SSD heads, inner channels
# and states split over model (in_zx re-blocked at placement); seamless's
# 16 heads and 16 KV heads over model on 2 x 2, the carries split along S;
# jamba at its published widths, its carry batch-only
SHARDED_CASES = (("qwen3-1.7b", (1, 2), "fsdp"),
                 ("glm4-9b", (1, 4), "fsdp"),
                 ("qwen3-1.7b", (2, 1), "stationary"),
                 ("mamba2-370m", (1, 2), "fsdp"),
                 ("seamless-m4t-medium", (2, 2), "fsdp"),
                 ("jamba-1.5-large-398b", (1, 2), "fsdp"),
                 ("mamba2-370m", (2, 1), "stationary"))
# jamba's one period at full width holds ~44 G weights with 16 experts in
# each of its 4 MoE FFNs, which does not fit the card twice (one device,
# then the ranks).  Cutting the experts to 4 does not shrink it: the
# schema pads the experts to a multiple of 16 (padded_experts(16)), and
# the padded ones are routable.  So the cut is the MoE FFNs' count: one
# MoE FFN a period (every_n 8) of 16 experts, top-2, the other 7 FFNs
# dense: ~18 G weights, 36 GB in bf16
SHARDED_HYBRID_CUT = {"every_n": 8}
SHARDED_SEED = 11
# sharded logits against the single device's, where the two have decoded
# the same tokens: partial sums in float32 over other splits of K, and
# softmax sums over T blocks, move a logit by bf16 rounding of the
# activations only, so the limit is SHARDED_TOL_STEPS bf16 steps at the
# largest |logit|.  It lies between the sound layouts and wrong ones at
# full width (scripts/probe_sharded_faults.py on an H100 80GB HBM3 at
# 700 W): the sound cases read 1.5-4.0 steps (e.g. 0.0547 at logits up
# to 5.09 for qwen3-1.7b on 1 x 2; jamba's one period 0.25 at 9.25); a T
# block's offset dropped 26.4, the combine without its max 242.5, a
# row-parallel sum dropped 176.75-317, the SSM's gated norm without its
# cross-rank sum 31.4, swapped z / x blocks 277, a cross-attention K / V
# head offset dropped 202.5: the limit stays, 2x the worst sound reading
# and 3.9x below the weakest fault.
# Greedy tokens equal up to a near-tie (the sharded choice within
# SHARDED_NEAR_TIE bf16 steps of the single device's best).  Both are fed
# the single device's greedy tokens, so every (row, step) is compared:
# with random weights the two best of 151,936 logits often lie within a
# bf16 step (on the H100 a greedy run of the sharded cells' own diverged
# at such ties after 23 of 68 tokens)
SHARDED_TOL_STEPS = 8
SHARDED_NEAR_TIE = 2
SHARDED_MIN_COMPARED = BATCH * (GEN + 1)
# the sharded phase's train cases: the dense and MoE train cells' step
# (launch.specs.train_contexts: sharded compute, every collective with its
# backward) at full width, PROD_TRAIN's batch and sequence, 2 steps on
# ranks sharing the card, against one device's steps on the card from the
# same seeded weights: (arch, (data, model), q8_gather).  qwen3-1.7b cut to
# DEPTH layers on 1 x 2 with f32 moments and with q8_gather=8, and with
# q8_gather=8 on 2 x 2 too, where its FSDP gathers (over data) exist;
# qwen2-moe-a2.7b cut to 1 layer (every routed choice admitted, as in
# sharded_config; the ranks are fed one device's router choices, as the
# serving cases are); seamless-m4t-medium cut to ENCDEC_DEPTH encoder and
# decoder layers on 2 x 2 with q8_gather=8, its batches carrying
# PROD_TRAIN's batch and sequence of source frames (sharded_train_batches);
# mamba2-370m cut to DEPTH layers on 2 x 2 with q8_gather=8, its 32 SSD
# heads over model, in_zx re-blocked for them (train_loop.zx_split: one
# device's in_zx, its moment and its symbols are re-blocked the same way
# before rank 0's blocks are held to them); jamba-1.5-large-398b cut by
# SHARDED_TRAIN_HYBRID_CUT on 1 x 2 with f32 moments, its 16 experts
# split over model, fed one device's router choices
SHARDED_TRAIN_CASES = (("qwen3-1.7b", (1, 2), 0),
                       ("qwen3-1.7b", (1, 2), 8),
                       ("qwen3-1.7b", (2, 2), 8),
                       ("qwen2-moe-a2.7b", (1, 2), 0),
                       ("jamba-1.5-large-398b", (1, 2), 0),
                       ("seamless-m4t-medium", (2, 2), 8),
                       ("mamba2-370m", (2, 2), 8))
SHARDED_TRAIN_DEPTH = {"qwen3-1.7b": DEPTH, "qwen2-moe-a2.7b": 1,
                       "seamless-m4t-medium": ENCDEC_DEPTH,
                       "mamba2-370m": DEPTH}
# the hybrid's train case at its published widths (d_model 8192, 64 / 8
# heads of 128, SSD d_state 128 and head_dim 64, vocab 65,536, 16 experts,
# top-2, every_n 2), cut to one period of 2 blocks: position 0 Mamba with
# the dense FFN, position 1 attention with the MoE FFN; and the FFNs'
# hidden dim to 1,024.  One published MoE FFN is 16 x 3 x 8192 x 24576 =
# 9.66 G weights, whose train state alone exceeds the card; cut, the case
# is 2.06 G weights (the untied embed and head 1.07 G of them), ~40 GB of
# one device's train state at qwen2-moe's ~19.6 B a weight
SHARDED_TRAIN_HYBRID_CUT = {"attn_period": 2, "n_layers": 2, "d_ff": 1024}
# the worlds of the sharded phase, by mesh shape, in waves: the worlds of a
# wave run together, sharing the card and the host (a rank's process
# takes seconds to start).  1 x 2 alone: jamba's serving period holds
# 25.7 GB a rank there, and its train case's rank 0 one device's train
# state (~40 GB) while rank 1 holds the weights; the others' ranks peak
# at 6.3 GB or less, 56 GB together
SHARDED_WAVES = (((1, 2),), ((1, 4), (2, 1), (2, 2)))
# loss and grad norm within 2e-3 (PROD_TRAIN_TOL's); each leaf's update within
# 0.25 relative L2 (tests/test_torch_sharded_train.py's limit, whose
# docstring gives the reason: Adam moves an element whose gradient is
# within rounding of zero by the learning rate either way, and the sharded
# layout rounds otherwise than one device) and its first moment within
# 0.1: the moments are linear in the gradients, but the second step's
# gradient is taken at params that the first update already parted, and
# at full width they read up to 0.0487 (wk, 2 x 2; the updates up to
# 0.158) on an H100 80GB HBM3 at 700 W, where the reduced configs read
# 0.02 on the CPU
SHARDED_TRAIN_TOL = dict(loss=2e-3, grad_norm=2e-3, update=0.25,
                         moment=0.1)
# EP's forward of the moe layer 0 against the single-device forward: the
# partial outputs of the model ranks are summed in bf16 in another order
# (and a choice of two experts on two ranks meets there), so an output may
# move by a few bf16 steps: at most EP_TOL of the largest |y|
EP_TOL = 2.0 ** -6
# row counts of the fused rows: lockstep decode and prefill, then the
# continuous engine's decode batch and prefill chunk
FUSED_M = (BATCH, BATCH * PROMPT, N_SLOTS, PREFILL_CHUNK)
FUSED_REPLACES = {
    "prefix": "src/repro/kernels/fused_decode_matmul.py:193",
    "tans": "src/repro/kernels/fused_decode_matmul.py:234"}
# card vs CPU bf16 logits of the reduced model: cuBLAS and the CPU sum the
# products in other orders, so logits may move by a few bf16 steps
REF_ATOL = 5e-2
TIMED_LAUNCHES = 10
PROFILE_STEPS = 8
# the dequant_matmul phase: layer 0's quantized matrices and lm_head, at a
# decode step (batch 4) and a prefill (4 x 32 tokens); the kernel against
# its plain version at the JAX package's kernel tolerance (both sum exact
# bf16 products in float32, in other orders)
DQ_TENSORS = ("layers/wq", "layers/wk", "layers/wv", "layers/wo",
              "layers/w_gate", "layers/w_up", "layers/w_down", "lm_head")
DQ_M = (BATCH, BATCH * PROMPT)
DQ_TOL = 1e-2
DQ_TIMED = 20
# the moe phase: full-width qwen2-moe-a2.7b (60 routed experts padded to 64,
# top-4, 4 shared; d_ff 1408 an expert, vocab 151936) cut to MOE_DEPTH of
# 24 layers, seeded random weights under SPEC (the router and every other
# layer matrix rANS-4, wo Huffman-8), compressed by a child process started
# with the script; what its resident run must fuse and what must fall back
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_DEPTH = 1
MOE_RESIDENT_GEN = 4
MOE_FUSED = {"layers/wq": "tans", "layers/wk": "tans", "layers/wv": "tans",
             "layers/wo": "prefix", "layers/moe/router": "tans",
             "layers/moe/shared_w_down": "tans"}
MOE_STACKS = ("layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down")
MOE_SHARED_FALLBACK = ("segment of 65536 symbols does not tile rows of "
                       "width 5632")
MOE_FUSED_ROWS = (("moe/router", False), ("moe/shared_w_down", False))
MOE_PAGED_SPEC = "bits=16,block=16"
# the families served from a container child: the moe under SPEC, and the
# ssm, hybrid and encdec families (lockstep, dense-resident: the only
# serving they have, in the JAX package too).  Their specs keep the SSM's
# sensitive tensors float32 ahead of the catch-alls (a matching rule
# overrides the keep-fp32 predicate), then, as SPEC does, one matrix of
# each block Huffman-8, the other layer matrices rANS-4 and the rest
# (embed, lm_head) Huffman-8
FAMILY_ARCHS = {"moe": MOE_ARCH, "ssm": "mamba2-370m",
                "hybrid": "jamba-1.5-large-398b",
                "encdec": "seamless-m4t-medium"}
SSM_CARVE_OUTS = ("*norm*", "*A_log*", "*dt_bias*", "*D_skip*", "*conv_*")
_FP32 = "; ".join(f"{p}:fp32" for p in SSM_CARVE_OUTS)
FAMILY_SPEC = {
    "moe": SPEC,
    "ssm": _FP32 + ("; layers/out_proj:bits=8,codec=huffman; "
                    "layers/*:bits=4,codec=rans; *:bits=8,codec=huffman"),
    "hybrid": _FP32 + ("; periods/*/wo:bits=8,codec=huffman; "
                       "periods/*:bits=4,codec=rans; *:bits=8,codec=huffman"),
    "encdec": ("*norm*:fp32; */wo:bits=8,codec=huffman; "
               "enc/*:bits=4,codec=rans; dec/*:bits=4,codec=rans; "
               "*:bits=8,codec=huffman")}
# the reduced configs' containers (the reference phase): short segments, so
# that the CPU's decode of them takes few steps
REDUCED_SEGMENTS = "; defaults:segment_symbols=4096"
# mamba2-370m whole (48 layers, full width); seamless-m4t-medium at full
# width cut to ENCDEC_DEPTH encoder and decoder layers of 12 each (525 M of
# its 600 M symbols are embed and lm_head, which no depth cut shrinks); the
# hybrid does not fit the card at full width (one period of
# jamba-1.5-large holds ~45 G weights) and runs reduced, in the reference
# phase only
SRC_FRAMES = 32
# a prompt of three SSD chunks of 256, the last one partial
LONG_PROMPT = 600
# decode_step at position S-1 against prefill over S tokens: the JAX
# package's own tolerance (tests/test_arch_smoke.py)
EXTEND_TOL = dict(atol=0.15, rtol=0.05)
# and every leaf of the cache the decode step leaves against the prefill's,
# layer by layer, relative to the layer's largest |value| (a state dropped
# or never written misses by 1; on the CPU, reduced, the port reads at most
# 5e-7)
EXTEND_STATE_RTOL = 5e-2
# ssd_chunked against a loop of ssd_step at mamba2-370m's head shapes, in
# float32: the chunked scan sums in another order (a CPU run of the port at
# these shapes: max |diff| 5.1e-5 where |y| reaches 35)
SSD_SHAPE = dict(B=2, S=LONG_PROMPT, H=32, P=64, N=128)
SSD_TOL = dict(atol=5e-4, rtol=1e-5)


# the train phase: qwen3-1.7b whole (``train_full``), at ``TRAIN_DATA``'s
# batch (8 x 128 tokens, 8 x 127 predicted) for ``TRAIN_STEPS`` steps
TRAIN_ARCH = "qwen3-1.7b"
TRAIN_STEPS = 20
TRAIN_SCHEDULE = dict(base_lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_DATA = dict(seq_len=128, global_batch=8, seed=0)
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 data sheet
# the JAX package's own criteria (tests/test_integration.py): the loss
# falls by more than 0.05 (:33-36); Q8 moments end within 0.15 of f32
# moments (:39-45); 1 and 2 microbatches within 0.02 in loss and 5e-3 in
# every parameter (:54-73); 8-bit weight gathers end within 0.1 (:283-302)
TRAIN_DROP = 0.05
TRAIN_Q8_TOL = 0.15
TRAIN_MB_TOL = dict(loss=0.02, atol=5e-3)
TRAIN_STE_TOL = 0.1
UNBIND_STEPS = 4
RESTART_STEPS, RESTART_AT = 10, 5
RESTART_TOL = 1e-3
# the entro restore exercises both decode kernels: parameters Huffman-8,
# moments rANS-8, norms (and their moments) float32
ENTRO_SPEC = "*norm*:fp32; */0/*:bits=8,codec=huffman; */1/*:bits=8,codec=rans"
ENTRO_STEPS = 3
# card against CPU, one step: the CPU tests' tolerances
# (tests/test_torch_train_loss*.py)
TRAIN_REF = dict(loss=2e-3, rel_l2=5e-2, cos=0.995)
# the production phase (11): the archs whose cells it dry-runs on the host,
# the card's cells (shape, rows) at 1 x 1 and the tolerance of the predicted
# peak against max_memory_allocated; the mesh train line's world, size and
# tolerances (tests/test_torch_train_mesh.py's)
PROD_ARCHS = ("qwen3-1.7b", "mamba2-370m")
PROD_WORKERS = 4
PROD_DRYRUN_TIMEOUT_S = 600
PROD_CARD = (("prefill_32k", 1), ("decode_32k", 8))
PROD_DECODE_STEPS = 3
PROD_PEAK_RTOL = 0.15
PROD_TRAIN_MESH = (1, 2)
PROD_TRAIN = dict(layers=2, batch=4, seq_len=128, steps=2)
PROD_TRAIN_TOL = dict(loss=2e-3, grad_norm=2e-3, update=0.1)
# the op behind a gradient that is not bitwise from run to run
NONDETERMINISTIC_OPS = {
    "embed": "the embedding gradient's accumulating scatter (take_rows: "
             "w[idx] backward, index_put_ with accumulate=True)"}


def emit(phase, **kw):
    """Print one result line; ``at_s`` is the script's clock when it was
    printed (where the time goes between the phases' own timings)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - START}), flush=True)


def smi(query):
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        res = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, res


def cuda_ms_queued(fn, n, clock_mhz):
    """Mean device time of ``fn`` over ``n`` launches queued behind a 20 ms
    spin kernel: the host enqueues them all before the first runs, so its
    launch cost does not space them out."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(20e3 * clock_mhz))
    start.record()
    for _ in range(n):
        res = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, res


def check_decoded(cm, host, params, spec, dev):
    """Every served tensor equals what quantize (or the fp32 carve-out)
    gives for it, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import quant
    from repro_torch.models.layers import pack_qt
    assert set(params) == set(host), sorted(set(host) ^ set(params))
    for name, w in host.items():
        got = params[name]
        if name in cm.unquantized:
            assert torch.equal(got.cpu(), torch.from_numpy(w)), name
            continue
        pol = spec.resolve(name, w)
        qt = quant.quantize(w, pol.bits, pol.granularity, group=pol.group,
                            scheme=pol.scheme, name=name)
        exp = pack_qt(qt.q, qt.scale, qt.zero, bits=pol.bits)
        assert type(got) is type(exp), (name, type(got), type(exp))
        for g, e in zip(got, exp):
            assert g.device.type == dev.type, name
            assert torch.equal(g, e.to(dev)), name
        assert np.array_equal(cm.qmeta[name]["scale"], qt.scale), name
    return len(host)


def parse_spec(text):
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec
    return CompressionSpec.parse(text,
                                 default_granularity=Granularity.PER_CHANNEL)


def dense_serve(cfg, cm, host, spec_text, prompt, dev):
    """Dense-resident lockstep serving of one container: decoded onto the
    card through the ``cuda`` backend, every tensor held bitwise to what
    ``host`` gives under ``spec_text``, and ``Engine.generate`` of ``GEN``
    greedy tokens (after a first call that sets up the library and the
    caches), its tokens in the padded vocabulary and its prefill logits
    finite.  Launch counts are zeroed just before the load and read just
    after the generate: each decode kernel must run, as often as the load
    plan has chunks for it.  Returns (engine, tokens, prefill logits,
    launches, the fields every serving line shares)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.serving import engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in build.launches:
        build.launches[k] = 0
    load = {}
    params = engine.load_params_from_compressed(
        cm, backend="cuda", device=dev, metrics=load)
    eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=PROMPT + GEN),
                        device=dev)
    t0 = time.perf_counter()
    eng.generate(prompt, 2)
    first_generate_s = time.perf_counter() - t0
    out, met = eng.generate(prompt, GEN, echo_metrics=True)
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    want = decode_launches_from_plan(cm)
    if 0 in want.values() or launches != dict({k: 0 for k in launches},
                                              **want):
        raise AssertionError(f"{cfg.name} launches {launches}, expected the "
                             f"load plan's {want}, each kernel at least once")
    t0 = time.perf_counter()
    n_checked = check_decoded(cm, host, params, parse_spec(spec_text), dev)
    check_s = time.perf_counter() - t0
    Vp = cfg.padded_vocab()
    if tuple(out.shape) != (BATCH, GEN) or out.dtype != torch.int32:
        raise AssertionError(f"{cfg.name} tokens {tuple(out.shape)} "
                             f"{out.dtype}")
    if not bool(((out >= 0) & (out < Vp)).all()):
        raise AssertionError(f"{cfg.name} token outside the padded vocabulary")
    with torch.inference_mode():
        logits, _ = eng.steps.prefill_fn(params,
                                         engine.lockstep_batch(prompt, dev))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits")
    st = cm.stats()
    fields = dict(
        arch=cfg.name, d_model=cfg.d_model, padded_vocab=Vp, spec=spec_text,
        params=st.param_count, effective_bits=st.effective_bits,
        groups={g.table_id: {"params": g.param_count,
                             "achieved_bits": g.effective_bits,
                             "entropy_bits": g.entropy_bits}
                for g in st.groups},
        encoded_bytes=st.encoded_bytes, first_generate_s=first_generate_s,
        decode_backend=load["decode_backend"],
        decode_load_s=load["decode_load_s"],
        ttfw_s=load["time_to_first_weight_s"], ttft_s=met["ttft_s"],
        ttft_incl_load_s=load["decode_load_s"] + met["ttft_s"],
        prefill_s=met["prefill_s"], decode_s=met["decode_s"],
        decode_tok_per_s=met["decode_tok_per_s"],
        e2e_tok_per_s=met["e2e_tok_per_s"], peak_bytes=peak,
        launches=launches, launches_expected=want, tensors_checked=n_checked,
        check_s=check_s, tokens=out[0].tolist())
    return eng, out, logits, launches, fields


def serve_config():
    """(published qwen3-1.7b, the serve phase's config: cut to ``DEPTH``
    layers)."""
    from repro_torch.configs import registry
    full = registry.get(SERVE_ARCH)
    return full, dataclasses.replace(full, n_layers=DEPTH)


def serve_host_weights(cfg):
    """The serve phase's seeded weights, drawn on the card and brought to
    the host: the child that compresses them and the phase that checks
    the card's decode draw the same ones."""
    import torch
    from repro_torch.models import dense
    params = dense.init(cfg, 0, torch.device("cuda"))
    return {k: v.float().cpu().numpy() for k, v in params.items()}


def serve_main_path(child, dev):
    """The serve phase on the container the ``serve`` child compressed
    (started first, so that the encode runs beside the build and the
    reference checks)."""
    import numpy as np

    full, cfg = serve_config()
    t0 = time.perf_counter()
    host = serve_host_weights(cfg)
    init_s = time.perf_counter() - t0
    # kept under build/ for the mesh phase's ranks, which remove it
    cm, made = containers(*child, keep={"serve": SERVE_ARCH})["serve"]

    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT))
    eng, out, logits, launches, fields = dense_serve(cfg, cm, host, SPEC,
                                                     prompt, dev)
    emit("serve", **fields, reduced={"n_layers": [full.n_layers, DEPTH]},
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd], d_ff=cfg.d_ff,
         init_s=init_s, compress_s=made["compress_s"], container=made)
    return cm, launches, eng, prompt, logits.float().cpu(), out.cpu()


def device_profile(steps):
    """``steps(window)`` runs ``PROFILE_STEPS`` steps inside the context
    ``window`` and returns ``(wall ms, window)``; it runs once without the
    profiler and once under ``torch.profiler``.  Returns the fields of a
    ``profile`` line: both wall times, device time by operator and the
    device's idle share of the profiled window (the profiler's own host
    overhead counts as idle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    unprofiled_wall_ms, _ = steps(contextlib.nullcontext())
    wall_ms, prof = steps(profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # kernels carry the device time; each operator that launched them
    # carries it again as its own, so busy time sums kernels only
    avgs = prof.key_averages()
    busy_ms = sum(dev_us(e) for e in avgs
                  if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU
                  and dev_us(e) > 0), key=dev_us, reverse=True)[:8]
    return dict(steps=PROFILE_STEPS, unprofiled_wall_ms=unprofiled_wall_ms,
                wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1 - busy_ms / wall_ms,
                top_ops=[{"name": e.key, "device_ms": dev_us(e) / 1e3,
                          "calls": e.count} for e in ops])


def prompt_tokens(prompt):
    return prompt["tokens"] if isinstance(prompt, dict) else prompt


def profile_decode(eng, prompt, dev, what="decode steps"):
    """Where a lockstep decode step's time goes: ``PROFILE_STEPS`` greedy
    steps after a prefill (:func:`device_profile`)."""
    import torch
    from repro_torch.serving import engine
    S = prompt_tokens(prompt).shape[1]

    def steps(window):
        """Prefill, then the decode steps alone inside ``window``."""
        with torch.inference_mode():
            logits, cache = eng.steps.prefill_fn(
                eng.params, engine.lockstep_batch(prompt, dev))
            tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            with window as prof:
                t0 = time.perf_counter()
                for i in range(PROFILE_STEPS):
                    logits, cache = eng.steps.decode_fn(eng.params, tok,
                                                        cache, S + i)
                    tok = logits[:, -1].argmax(-1, keepdim=True)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        return ms, prof

    emit("profile", what=what, **device_profile(steps))


def fused_per_forward(rw):
    """Fused launches a forward of the resident store ``rw``: each fused
    matrix of each layer once, by kernel family."""
    return {f"fused_{fam}": sum(
        rw._fused_slots[0][n.split("/", 1)[1]].family == fam
        for n in rw._fused) * rw.n_layers for fam in ("prefix", "tans")}


def fallback_calls_per_layer(rw):
    """``tans_decode`` calls of the worker's decode of each layer: one per
    budgeted run of each fallback step on a tANS table."""
    from repro_torch.core.scheduler import iter_seg_runs
    return [sum(len(list(iter_seg_runs(step.segs, rw.chunk_symbols)))
                for step in rw.plan[layer]
                if rw.model.tables[step.table_id].kernel == "tans")
            for layer in range(rw.n_layers)]


def serve_trace(cfg, weights, resident, dev, traffic=TRAFFIC,
                max_len=CONT_MAX_LEN, **engine_kw):
    """A trace (the continuous phase's by default) through a fresh
    ``ContinuousEngine``; returns the engine, the requests in trace order,
    the trace and the summary metrics."""
    from repro_torch.obs.metrics import percentile
    from repro_torch.serving import engine
    from repro_torch.serving.batching import (ContinuousEngine,
                                              poisson_trace, replay)
    trace = poisson_trace(vocab=cfg.vocab, **traffic)
    ce = ContinuousEngine(cfg, weights, engine.ServeConfig(max_len=max_len),
                          n_slots=N_SLOTS, prefill_chunk=PREFILL_CHUNK,
                          max_queue=MAX_QUEUE, resident=resident, device=dev,
                          **engine_kw)
    reqs, shed, makespan = replay(ce, trace, shed_on_full=True)
    fin = [r for r in reqs if r is not None and r.finish_reason == "length"]
    toks = sum(len(r.output) for r in fin)
    pct = lambda xs, p: percentile(xs, p) if xs else None  # noqa: E731
    ttft = [r.ttft_s for r in fin]
    lat = [r.latency_s for r in fin]
    wait = [r.queue_wait_s for r in fin]
    summary = dict(
        completed=len(fin), submitted=len(trace), shed=shed, tokens=toks,
        makespan_s=makespan, tok_per_s=toks / makespan,
        n_decode_steps=ce.n_decode_steps,
        prefill_chunks=sum(-(-len(p) // PREFILL_CHUNK) for _, p, _ in trace),
        prefill_chunks_run=ce.n_prefill_chunks,
        ttft_p50_s=pct(ttft, 50), latency_p50_s=pct(lat, 50),
        latency_p99_s=pct(lat, 99), queue_wait_p50_s=pct(wait, 50),
        queue_wait_p99_s=pct(wait, 99))
    if len(fin) != len(trace) or shed:
        raise AssertionError(f"continuous {resident}: {len(fin)} of "
                             f"{len(trace)} requests completed, {shed} shed")
    return ce, reqs, trace, summary


def chunked_prefill_last(ce, prompt):
    """Request ``prompt`` prefilled chunk by chunk through the engine's
    ``prefill_chunk_fn`` into a fresh scratch cache: the float logits at its
    last prompt position, on the host."""
    import torch
    P, C = len(prompt), PREFILL_CHUNK
    toks = torch.zeros((1, -(-P // C) * C), dtype=torch.int64)
    toks[0, :P] = torch.from_numpy(prompt.astype("int64"))
    toks = toks.to(ce.device)
    cache = ce.steps.mod.init_cache(ce.cfg, 1, CONT_MAX_LEN, device=ce.device)
    with torch.inference_mode():
        for c0 in range(0, toks.shape[1], C):
            logits, cache = ce.steps.prefill_chunk_fn(
                ce.params, toks[:, c0:c0 + C], cache,
                torch.full((1,), c0, dtype=torch.int64, device=ce.device))
            if c0 <= P - 1 < c0 + C:
                last = logits[0, P - 1 - c0].float().cpu()
    return last


def continuous_phase(cm, params, dev):
    """Continuous batching of the Poisson trace, dense-resident on the serve
    phase's decoded weights, then compressed-resident fused on a fresh
    store built from the same container."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import engine
    from repro_torch.serving.resident import CompressedResidentWeights

    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=DEPTH)

    # dense-resident: no kernel runs in the step (the weights were decoded
    # at load), so every count must stay 0
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    ce, reqs, trace, dense = serve_trace(cfg, params, "dense", dev)
    dense_launches = dict(build.launches)
    if any(dense_launches.values()):
        raise AssertionError(f"dense continuous launches {dense_launches}")
    solo = engine.Engine(cfg, params, engine.ServeConfig(max_len=CONT_MAX_LEN),
                         device=dev)
    agree, first_diff = 0, None
    for i, ((_, prompt, gen), r) in enumerate(zip(trace, reqs)):
        want = solo.generate(prompt[None], gen)[0].tolist()
        if want == r.output:
            agree += 1
        elif first_diff is None:
            step = next(j for j, (a, b) in enumerate(zip(want, r.output))
                        if a != b)
            first_diff = dict(request=i, step=step, solo=want[step],
                              packed=r.output[step])
    prompt0 = trace[0][1]
    chunked = chunked_prefill_last(ce, prompt0)
    with torch.inference_mode():
        lockstep, _ = ce.steps.prefill_fn(
            params, torch.as_tensor(prompt0[None], dtype=torch.int64,
                                    device=dev))
    prefill_err = float((chunked - lockstep[0, -1].float().cpu()).abs().max())
    emit("continuous", residency="dense", arch=cfg.name, n_slots=N_SLOTS,
         prefill_chunk=PREFILL_CHUNK, max_queue=MAX_QUEUE,
         max_len=CONT_MAX_LEN, traffic=TRAFFIC, **dense,
         launches=dense_launches, solo_agree_bitwise=agree,
         solo_compared=len(trace), first_diverging=first_diff,
         chunked_prefill_max_abs_err_vs_lockstep=prefill_err,
         atol=REF_ATOL, tokens_request0=reqs[0].output)
    if not prefill_err <= REF_ATOL:
        raise AssertionError(f"chunked prefill differs from the lockstep "
                             f"prefill by {prefill_err}")

    # compressed-resident fused: counts zeroed just before the store is
    # built, read after the replay once the last prefetch has decoded
    counters = ("resident.prefetch_hit", "resident.prefetch_wait",
                "resident.consume_wait_s")
    read = lambda: {c: obs_metrics.counter(c).total()  # noqa: E731
                    for c in counters}
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    c0 = read()
    t0 = time.perf_counter()
    rw = CompressedResidentWeights(cm, cfg, backend="cuda", fused=True,
                                   device=dev)
    build_s = time.perf_counter() - t0
    built = dict(build.launches)
    rce, rreqs, _, res = serve_trace(cfg, rw, "compressed", dev)
    speculative = rw.wait_prefetches()
    launches, c1 = dict(build.launches), read()
    for k in ("huffman_decode", "ans_decode", "fused_prefix", "fused_tans"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the continuous "
                                 f"resident path")
    forwards = res["n_decode_steps"] + res["prefill_chunks"]
    per_forward = fused_per_forward(rw)
    expected = {k: forwards * v for k, v in per_forward.items()}
    fused = {k: launches[k] for k in expected}
    if fused != expected:
        raise AssertionError(f"fused launches {fused}, expected {forwards} "
                             f"forwards x {per_forward}")
    per_layer = fallback_calls_per_layer(rw)
    ans = dict(at_build=built["ans_decode"], per_forward=sum(per_layer),
               forwards=forwards, speculative_prefetches=speculative,
               per_prefetch=per_layer[0])
    ans["expected"] = (ans["at_build"] + forwards * ans["per_forward"]
                       + speculative * per_layer[0])
    if launches["ans_decode"] != ans["expected"]:
        raise AssertionError(f"ans_decode launched {launches['ans_decode']} "
                             f"times, expected {ans}")
    same = sum(a.output == b.output for a, b in zip(rreqs, reqs))
    pairs = [(x, y) for a, b in zip(rreqs, reqs)
             for x, y in zip(a.output, b.output)]
    rchunked = chunked_prefill_last(rce, prompt0)
    rerr = float((rchunked - chunked).abs().max())
    rw.close()
    emit("continuous", residency="compressed-fused", arch=cfg.name,
         n_slots=N_SLOTS, prefill_chunk=PREFILL_CHUNK, **res,
         weights_build_s=build_s, forwards=forwards, launches=launches,
         fused_launches_expected=expected,
         fused_launches_per_forward=per_forward, ans_decode_launches=ans,
         prefetch_hits=c1["resident.prefetch_hit"]
         - c0["resident.prefetch_hit"],
         prefetch_waits=c1["resident.prefetch_wait"]
         - c0["resident.prefetch_wait"],
         consume_wait_s=c1["resident.consume_wait_s"]
         - c0["resident.consume_wait_s"],
         requests_equal_dense=same,
         token_agreement_vs_dense=sum(x == y for x, y in pairs) / len(pairs),
         chunked_prefill_max_abs_err_vs_dense=rerr, atol=REF_ATOL,
         tokens_request0=rreqs[0].output)
    if not rerr <= REF_ATOL:
        raise AssertionError(f"resident chunked prefill differs from the "
                             f"dense engine's by {rerr}")
    return launches


def paged_phase(params, dev):
    """The shared-prompt trace through the slot pool and through paged
    pools (``PAGED_RUNS``), dense-resident on the serve phase's decoded
    weights; then the first-token logits through each KV layout, the
    ``profile`` of paged decode steps and the int8 slot cache.  Launch
    counts are zeroed just before the phase and must read 0
    after it (the weights were decoded at load; a paged step runs no
    kernel of the port)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.spec import KVCompressionSpec
    from repro_torch.kernels import build
    from repro_torch.serving.kvcache import kv_cache_bytes

    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=DEPTH)
    slot_bytes = kv_cache_bytes(cfg, N_SLOTS, PAGED_MAX_LEN)
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    outputs = {}
    for label, text, n_blocks in PAGED_RUNS:
        spec = KVCompressionSpec.parse(text) if text else None
        torch.cuda.reset_peak_memory_stats(dev)
        ce, reqs, trace, run = serve_trace(
            cfg, params, "dense", dev, traffic=PAGED_TRAFFIC,
            max_len=PAGED_MAX_LEN, kv_spec=spec, kv_blocks=n_blocks)
        outputs[label] = [r.output for r in reqs]
        run["prefill_chunks_skipped"] = (run["prefill_chunks"]
                                         - run["prefill_chunks_run"])
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        run["slot_cache_bytes"] = slot_bytes
        if spec is not None:
            st = ce.slots.stats()
            run.update(kv_spec=spec.describe(), kv_blocks=ce.slots.n_blocks,
                       cold_effective_bits=(ce.slots.cold.effective_bits
                                            if ce.slots.cold else None),
                       **st)
        pairs = [(x, y) for a, b in zip(outputs[label], outputs["slot-pool"])
                 for x, y in zip(a, b)]
        run["requests_equal_slot_pool"] = sum(
            a == b for a, b in zip(outputs[label], outputs["slot-pool"]))
        run["token_agreement_vs_slot_pool"] = (sum(x == y for x, y in pairs)
                                               / len(pairs))
        emit("paged", run=label, arch=cfg.name, n_slots=N_SLOTS,
             prefill_chunk=PREFILL_CHUNK, max_len=PAGED_MAX_LEN,
             traffic=PAGED_TRAFFIC, **run,
             tokens_request0=outputs[label][0])
        if label == "bits16":
            if outputs[label] != outputs["slot-pool"]:
                raise AssertionError(
                    f"paged bits=16 differs from the slot pool: "
                    f"{run['requests_equal_slot_pool']} of {len(trace)} "
                    f"requests equal")
            if not run["shared_hits"] > 0:
                raise AssertionError("paged bits=16: no prefix hit")
        if label.startswith("bits4-tight") and not run["cold_evictions"] > 0:
            raise AssertionError(f"{label}: {n_blocks} blocks evicted "
                                 f"nothing to the cold tier")
    if outputs["bits4-tight"] != outputs["bits4-tight-again"]:
        raise AssertionError("two bits=4 runs gave different tokens")
    drift = {label: token_drift(outputs[label], outputs["bits16"])
             for label in ("bits8", "bits4-tight")}
    emit("paged_drift", bound=PAGED_DRIFT, held="bits8", **drift)
    if drift["bits8"] > PAGED_DRIFT:
        raise AssertionError(f"bits8: {drift['bits8']:.3f} of the tokens "
                             f"drift from bf16 blocks (> {PAGED_DRIFT})")
    kv_logits_check(cfg, params, trace, dev)
    paged_profile(cfg, params, dev)
    int8_cache_check(cfg, params, dev)
    launches = dict(build.launches)
    if any(launches.values()):
        raise AssertionError(f"paged phase launched kernels: {launches}")
    return launches


def fleet_jobs(cfg):
    from repro_torch.serving.batching import poisson_trace
    trace = poisson_trace(vocab=cfg.vocab, **TRAFFIC)
    return trace, [(p, g, {}) for _, p, g in trace]


def run_single(ce, jobs):
    """Every job through one ``ContinuousEngine``: the outputs in job
    order."""
    reqs = [ce.submit(p, g, **kw) for p, g, kw in jobs]
    ce.run()
    return [r.output for r in reqs]


def run_fleet(fd, jobs):
    """Submit every job to the fleet and drive it in lockstep to the end;
    returns the requests in job order and the wall time."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [fd.submit(p, g, **kw) for p, g, kw in jobs]
    fd.run()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def fleet_line(fd, reqs, wall, label, want, redrives=0, **fields):
    """Emit a run's ``fleet`` line and hold it: every request dispatched
    once (again once per redrive) and finished once, none shed, each
    bitwise ``want``."""
    outs = [r.output for r in reqs]
    equal = sum(a == b for a, b in zip(outs, want))
    rids = [r.rid for h in fd.replicas for r in h.engine.finished]
    toks = sum(len(o) for o in outs)
    emit("fleet", run=label, replicas=len(fd.replicas),
         policy=fd.router.policy, n_slots=FLEET_SLOTS, submitted=len(reqs),
         dispatched=fd.router.n_dispatched, finished=len(rids),
         finished_unique=len(set(rids)), shed=len(fd.shed), wall_s=wall,
         tokens=toks, tok_per_s=toks / wall,
         per_replica_finished=[len(h.engine.finished) for h in fd.replicas],
         per_replica_decode_steps=[h.engine.n_decode_steps
                                   for h in fd.replicas],
         fleet_steps=fd.n_steps, requests_equal_single=equal,
         redrives=redrives, **fields)
    if len(rids) != len(reqs) or set(rids) != {r.rid for r in reqs} \
            or fd.shed:
        raise AssertionError(f"fleet {label}: {len(set(rids))} of "
                             f"{len(reqs)} requests finished ({len(rids)} "
                             f"finishes, {len(fd.shed)} shed)")
    if fd.router.n_dispatched != len(reqs) + redrives:
        raise AssertionError(f"fleet {label}: {fd.router.n_dispatched} "
                             f"dispatched, expected {len(reqs)} + "
                             f"{redrives} redrives")
    if outs != want:
        raise AssertionError(f"fleet {label}: {len(reqs) - equal} requests' "
                             f"tokens differ from the single engine's")


def fleet_phase(cm, params, dev):
    """The fleet over the serve phase's decoded weights: data-parallel
    replicas, a killed replica, disaggregated prefill / decode splits, a
    per-replica weight load, and threaded replicas; every request held
    bitwise to a single engine.  Launch counts are zeroed just before the
    phase; only the per-replica load launches kernels."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.spec import KVCompressionSpec
    from repro_torch.kernels import build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine
    from repro_torch.serving.batching import (ContinuousEngine,
                                              SamplingParams, replay_fleet)
    from repro_torch.serving.fleet import POLICIES, FleetDriver

    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=DEPTH)
    sc = engine.ServeConfig(max_len=CONT_MAX_LEN)
    steps = engine.ServeSteps(cfg, sc)
    trace, jobs = fleet_jobs(cfg)
    common = dict(n_slots=FLEET_SLOTS, prefill_chunk=PREFILL_CHUNK,
                  steps=steps)
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    want = run_single(ContinuousEngine(cfg, params, sc, device=dev, **common),
                      jobs)

    # data parallel, shared weights, lockstep
    for n in FLEET_REPLICAS:
        for policy in POLICIES:
            fd = FleetDriver(cfg, params, sc, n_replicas=n, policy=policy,
                             devices=[dev], **common)
            fleet_line(fd, *run_fleet(fd, jobs), "dp", want)

    # a replica killed once its engine has taken a few decode steps
    fd = FleetDriver(cfg, params, sc, n_replicas=FLEET_KILL["replicas"],
                     policy="least-loaded", devices=[dev], **common)
    victim = fd.replicas[FLEET_KILL["victim"]].engine
    redrives0 = obs_metrics.counter("fleet.redrives").total()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [fd.submit(p, g) for p, g, _ in jobs]
    while victim.n_decode_steps < FLEET_KILL["after_decode_steps"]:
        if not fd.step():
            raise AssertionError("fleet kill: the victim never decoded")
    evacuated = fd.kill_replica(FLEET_KILL["victim"])
    fd.run()
    torch.cuda.synchronize()
    redrives = obs_metrics.counter("fleet.redrives").total() - redrives0
    fleet_line(fd, reqs, time.perf_counter() - t0, "kill", want,
               victim=FLEET_KILL["victim"],
               killed_after_decode_steps=FLEET_KILL["after_decode_steps"],
               redrives=redrives, evacuated=len(evacuated))
    if not evacuated or redrives != len(evacuated):
        raise AssertionError(f"fleet kill: {len(evacuated)} evacuated, "
                             f"{redrives} redrives")

    # disaggregated prefill / decode over paged blocks; the sampled request
    # goes through the first split, against its own single paged run
    for (split, text) in FLEET_DISAGG:
        spec = KVCompressionSpec.parse(text)
        paged = dict(common, kv_spec=spec)
        pwant = run_single(ContinuousEngine(cfg, params, sc, device=dev,
                                            **paged), jobs)
        sent = []
        fd = FleetDriver(cfg, params, sc, n_replicas=sum(split),
                         disaggregate=split, devices=[dev],
                         handoff_transport=lambda pl: sent.append(pl) or 0,
                         **paged)
        pool = fd.replicas[0].engine.slots.pool
        block_bytes = sum(c[:, 0].numel() * c.element_size()
                          for c in pool.values())
        tracer = obs_trace.enable()
        try:
            reqs, wall = run_fleet(fd, jobs)
        finally:
            obs_trace.disable()
        n_blocks = sum(len(pl.blocks) for pl in sent)
        fleet_line(fd, reqs, wall, "disagg", pwant, split=list(split),
                   kv_spec=spec.describe(), handoffs=fd.handoff.n_handoffs,
                   delivered=fd.handoff.n_delivered,
                   bytes_on_wire=fd.handoff.bytes_on_wire,
                   exported_blocks=n_blocks,
                   raw_block_bytes=block_bytes * n_blocks,
                   span_ms={n: 1e-3 * sum(e.dur_us for e in tracer.spans(n))
                            for n in ("fleet.handoff_encode",
                                      "fleet.handoff_adopt")})
        if not fd.handoff.n_handoffs == fd.handoff.n_delivered == len(jobs):
            raise AssertionError(f"fleet disagg {split}: "
                                 f"{fd.handoff.n_handoffs} handoffs, "
                                 f"{fd.handoff.n_delivered} delivered")
        if split == FLEET_DISAGG[0][0]:
            sampled = [(jobs[0][0], GEN,
                        dict(sampling=SamplingParams(**FLEET_SAMPLED)))]
            swant = run_single(ContinuousEngine(cfg, params, sc, device=dev,
                                                **paged), sampled)
            fd = FleetDriver(cfg, params, sc, n_replicas=sum(split),
                             disaggregate=split, devices=[dev], **paged)
            fleet_line(fd, *run_fleet(fd, sampled), "disagg-sampled", swant,
                       split=list(split), kv_spec=spec.describe(),
                       sampling=FLEET_SAMPLED, tokens_sampled=swant[0])

    # one weight copy per replica, decoded through the kernels twice
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fd = FleetDriver.from_container(cm, cfg, sc, weights="per-replica",
                                    n_replicas=2, backend="cuda",
                                    policy="least-loaded", devices=[dev],
                                    **common)
    load_s = time.perf_counter() - t0
    launches = dict(build.launches)
    plan = decode_launches_from_plan(cm)
    per = fd.weight_bytes()
    shared = FleetDriver(cfg, params, sc, n_replicas=2, devices=[dev],
                         **common).weight_bytes()
    fleet_line(fd, *run_fleet(fd, jobs), "weights", want, weights=per,
               weights_share=shared, load_s=load_s, launches=launches,
               launches_per_copy=plan,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    if launches != dict({k: 0 for k in launches},
                        **{k: 2 * v for k, v in plan.items()}):
        raise AssertionError(f"per-replica load launches {launches}, "
                             f"expected 2 x the plan's {plan}")
    if not (per["copies"] == 2 and per["total_bytes"]
            == 2 * per["bytes_per_copy"] == 2 * shared["total_bytes"]
            and shared["copies"] == 1 and shared["total_bytes"] > 0):
        raise AssertionError(f"weight_bytes: per-replica {per}, share "
                             f"{shared}")
    del fd

    # threaded replicas on TRAFFIC's arrival times: one worker a replica,
    # all queueing onto the card's one stream
    for n in (1, 2):
        fd = FleetDriver(cfg, params, sc, n_replicas=n, devices=[dev],
                         **common)
        torch.cuda.synchronize()
        reqs, shed, makespan = replay_fleet(fd, trace, threaded=True)
        torch.cuda.synchronize()
        fleet_line(fd, reqs, makespan, "threaded", want, shed_on_submit=shed)
    return dict(build.launches), want


def token_drift(got, want):
    """Share of ``want``'s tokens that ``got`` differs from, position by
    position (the JAX package's drift measure)."""
    return (sum(x != y for a, b in zip(got, want) for x, y in zip(a, b))
            / sum(len(b) for b in want))


def first_token_logits(cfg, params, prompts, dev, kv):
    """Each prompt prefilled alone, chunk by chunk, into an empty cache: the
    float logits at its last position (its first generated token's), one
    row a prompt.  ``kv`` is a ``--kv-spec`` text (a one-slot block pool)
    or the slot cache's ``kv_bits``."""
    import torch
    from repro_torch.core.spec import KVCompressionSpec
    from repro_torch.models import dense
    from repro_torch.serving.batching.request import Request
    from repro_torch.serving.kvcache import BlockKVManager
    C = PREFILL_CHUNK
    paged = isinstance(kv, str)
    if paged:
        m = BlockKVManager(cfg, 1, PAGED_MAX_LEN, device=dev,
                           spec=KVCompressionSpec.parse(kv), prefill_chunk=C)
    rows = []
    with torch.inference_mode():
        for prompt in prompts:
            P = len(prompt)
            toks = torch.zeros((1, -(-P // C) * C), dtype=torch.int64)
            toks[0, :P] = torch.from_numpy(prompt.astype("int64"))
            toks = toks.to(dev)
            if paged:
                slot, _ = m.alloc(Request(prompt=prompt, max_new_tokens=GEN))
                bt = torch.from_numpy(m.table_rows([slot])).to(dev,
                                                               torch.int64)
            else:
                cache = dense.init_cache(cfg, 1, PAGED_MAX_LEN, device=dev,
                                         kv_bits=kv)
            for c0 in range(0, toks.shape[1], C):
                pos = torch.full((1,), c0, dtype=torch.int64, device=dev)
                if paged:
                    logits, _ = dense.paged_prefill_chunk(
                        cfg, params, toks[:, c0:c0 + C], m.pool, bt, pos)
                else:
                    logits, cache = dense.prefill_chunk(
                        cfg, params, toks[:, c0:c0 + C], cache, pos)
                if c0 <= P - 1 < c0 + C:
                    rows.append(logits[0, P - 1 - c0].float())
            if paged:
                m.release(slot)
    return torch.stack(rows)


def kv_logits_check(cfg, params, trace, dev):
    """The first generated token's logits of every trace prompt through
    bf16, 8- and 4-bit blocks and the int8 slot cache, against the bf16
    slot cache's: bf16 blocks bitwise, the quantized ones within
    ``KV_LOGITS_TOL``.  The control is the bf16 slot cache with each
    prompt's system prompt swapped for the other one; returns the
    ``kv_logits`` line's fields."""
    import numpy as np
    prompts = [p for _, p, _ in trace]
    n = PAGED_TRAFFIC["prefix_len"]
    prefixes = list({p[:n].tobytes(): p[:n] for p in prompts}.values())
    swapped = [np.concatenate([next(q for q in prefixes
                                    if q.tobytes() != p[:n].tobytes()),
                               p[n:]]) for p in prompts]
    ref = first_token_logits(cfg, params, prompts, dev, 16)

    def err(got):
        return (got - ref).abs().amax(1)

    control = err(first_token_logits(cfg, params, swapped, dev, 16))
    out = dict(prompts=len(prompts), tol=KV_LOGITS_TOL,
               margin=KV_CONTEXT_MARGIN,
               control_min_max_abs_err=float(control.min()),
               control_median_max_abs_err=float(control.median()))
    for label, kv in (("bits16", "bits=16,block=16"),
                      ("bits8", "bits=8,block=16,codec=rans"),
                      ("bits4", "bits=4,block=16,codec=rans"),
                      ("int8", 8)):
        got = first_token_logits(cfg, params, prompts, dev, kv)
        e = err(got)
        out[label] = dict(max_abs_err=float(e.max()),
                          median_max_abs_err=float(e.median()),
                          first_tokens_equal=int(
                              (got.argmax(1) == ref.argmax(1)).sum()))
    emit("kv_logits", **out)
    if out["bits16"]["max_abs_err"] != 0.0:
        raise AssertionError("bf16 blocks' first-token logits differ from "
                             "the slot cache's")
    for label, tol in KV_LOGITS_TOL.items():
        if not out[label]["max_abs_err"] <= tol:
            raise AssertionError(
                f"{label} KV: first-token logits differ from bf16 by "
                f"{out[label]['max_abs_err']} (> {tol})")
    widest = max(KV_LOGITS_TOL.values())
    if not out["control_min_max_abs_err"] > KV_CONTEXT_MARGIN * widest:
        raise AssertionError(
            f"a wrong context moves the logits by only "
            f"{out['control_min_max_abs_err']}, within {KV_CONTEXT_MARGIN} "
            f"x the widest limit {widest}")
    return out


def paged_profile(cfg, params, dev):
    """``PROFILE_STEPS`` decode steps of the paged engine with every slot
    decoding (``ContinuousEngine.step`` alone: no request queued or
    prefilling), at bits 16 and 4: a ``profile`` line each
    (:func:`device_profile`)."""
    import torch
    from repro_torch.core.spec import KVCompressionSpec
    from repro_torch.serving import engine
    from repro_torch.serving.batching import ContinuousEngine, poisson_trace
    from repro_torch.serving.batching.request import RequestState
    trace = poisson_trace(vocab=cfg.vocab, **PAGED_TRAFFIC)[:N_SLOTS]
    for text in ("bits=16,block=16,sharing",
                 "bits=4,block=16,codec=rans,sharing"):
        ce = ContinuousEngine(cfg, params,
                              engine.ServeConfig(max_len=PAGED_MAX_LEN),
                              n_slots=N_SLOTS, prefill_chunk=PREFILL_CHUNK,
                              kv_spec=KVCompressionSpec.parse(text),
                              device=dev)
        reqs = [ce.submit(p, PAGED_MAX_LEN - 64) for _, p, _ in trace]
        while len(ce.queue) or ce._prefilling is not None:
            ce.step()
        if not all(r.state is RequestState.DECODING for r in reqs):
            raise AssertionError("profile: a request left the batch early")

        def steps(window):
            torch.cuda.synchronize()
            with window as prof:
                t0 = time.perf_counter()
                for _ in range(PROFILE_STEPS):
                    ce.step()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            return ms, prof

        emit("profile", what="paged decode steps", kv_spec=text,
             n_slots=N_SLOTS, **device_profile(steps))


def int8_cache_check(cfg, params, dev):
    """The serve phase's lockstep prompt (batch 4, prompt 32, 16 greedy
    tokens) through ``prefill_chunk`` / ``decode_step`` on the int8 slot
    cache and on the bf16 one: cache bytes, the logits' largest difference
    over the steps both runs share a token history, and token agreement."""
    import numpy as np
    import torch
    from repro_torch.models import dense
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                             device=dev)
    runs = {}
    for bits in (16, 8):
        cache = dense.init_cache(cfg, BATCH, PROMPT + GEN, device=dev,
                                 kv_bits=bits)
        nbytes = sum(c.numel() * c.element_size() for c in cache.values())
        pos = torch.zeros((BATCH,), dtype=torch.int64, device=dev)
        tok, toks, logits = prompt, [], []
        with torch.inference_mode():
            for _ in range(GEN):
                lg, cache = dense.prefill_chunk(cfg, params, tok, cache, pos)
                pos = pos + tok.shape[1]
                lg = lg[:, -1].float()
                logits.append(lg)
                tok = lg.argmax(-1, keepdim=True)
                toks.append(tok)
        runs[bits] = (nbytes, torch.cat(toks, 1).cpu(), logits)
    (b16, t16, l16), (b8, t8, l8) = runs[16], runs[8]
    if not all(bool(torch.isfinite(x).all()) for x in l8):
        raise AssertionError("int8 cache: non-finite logits")
    same = (t16 == t8).long()
    # step i's logits follow tokens 0 .. i-1: a row shares its history up
    # to and including its first differing token's step
    history = torch.cat([torch.ones_like(same[:, :1]),
                         same.cumprod(1)[:, :-1]], 1).to(dev)
    err = max(float(((a - b).abs() * history[:, i:i + 1]).max())
              for i, (a, b) in enumerate(zip(l16, l8)))
    emit("int8_cache", batch=BATCH, prompt=PROMPT, gen=GEN,
         cache_bytes=b8, bf16_cache_bytes=b16,
         logits_max_abs_diff_shared_history=err,
         tol=KV_LOGITS_TOL["int8"],
         token_agreement=float(same.float().mean()),
         rows_equal=int(same.all(1).sum()))
    if not err <= KV_LOGITS_TOL["int8"]:
        raise AssertionError(f"int8 cache: logits differ from bf16 by {err} "
                             f"over shared histories (> "
                             f"{KV_LOGITS_TOL['int8']})")


def resident_phase(cm, prompt, dense_logits, dense_tokens, dev):
    """Compressed-resident fused serving of the main path's container:
    launch counts zeroed just before the weights are built, read just
    after the generate."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import engine
    from repro_torch.serving.resident import CompressedResidentWeights

    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=DEPTH)
    counters = ("resident.prefetch_hit", "resident.prefetch_wait",
                "resident.consume_wait_s")
    read = lambda: {c: obs_metrics.counter(c).total()  # noqa: E731
                    for c in counters}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in build.launches:
        build.launches[k] = 0
    t0 = time.perf_counter()
    rw = CompressedResidentWeights(cm, cfg, backend="cuda", fused=True,
                                   device=dev)
    build_s = time.perf_counter() - t0
    built = dict(build.launches)
    fused = {n: rw._fused_slots[0][n.split("/", 1)[1]].family
             for n in rw._fused}
    if fused != FUSED:
        raise AssertionError(f"fused tensors {fused}, expected {FUSED}")
    if rw.fused_fallback != {"layers/w_gate": FALLBACK,
                             "layers/w_up": FALLBACK}:
        raise AssertionError(f"fallback {rw.fused_fallback}")
    eng = engine.Engine(cfg, rw, engine.ServeConfig(max_len=PROMPT + GEN),
                        device=dev, resident="compressed")
    t0 = time.perf_counter()
    eng.generate(prompt, 2)          # first call: caches and allocator
    first_generate_s = time.perf_counter() - t0
    before, c0 = dict(build.launches), read()
    out, met = eng.generate(prompt, GEN, echo_metrics=True)
    # the last forward's prefetch of layer 0 may still be decoding: wait for
    # it, so that the counts no longer depend on the worker's timing
    speculative = rw.wait_prefetches()
    launches, c1 = dict(build.launches), read()
    peak = torch.cuda.max_memory_allocated(dev)
    for k in ("huffman_decode", "ans_decode", "fused_prefix", "fused_tans"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the resident path")
    # the engine's thread launches the fused kernels: a forward runs every
    # layer's fused matmuls once
    during = {k: launches[k] - before[k] for k in ("fused_prefix",
                                                   "fused_tans")}
    per_forward = fused_per_forward(rw)
    if during != {k: GEN * v for k, v in per_forward.items()}:
        raise AssertionError(f"fused launches in generate {during}, "
                             f"expected {GEN} x {per_forward}")
    # the worker launches tans_decode: one call per budgeted run of each
    # fallback step of a layer, each layer decoded once a forward, plus the
    # last forward's prefetch of layer 0 for a next forward
    per_layer = fallback_calls_per_layer(rw)
    forwards = 2 + GEN               # both generates: prefill + steps
    ans = dict(at_build=built["ans_decode"], per_forward=sum(per_layer),
               forwards=forwards, speculative_prefetches=speculative,
               per_prefetch=per_layer[0])
    ans["expected"] = (ans["at_build"] + forwards * ans["per_forward"]
                       + speculative * per_layer[0])
    if launches["ans_decode"] != ans["expected"]:
        raise AssertionError(f"ans_decode launched {launches['ans_decode']} "
                             f"times, expected {ans}")
    with torch.inference_mode():
        logits, _ = eng.steps.prefill_fn(rw, torch.as_tensor(prompt,
                                                             device=dev))
    logits = logits.float().cpu()
    err = float((logits - dense_logits).abs().max())
    rb = rw.resident_bytes()
    peak_resident, bf16 = rw.peak_resident_bytes(), rw.dense_bf16_bytes()
    rw.close()
    emit("resident", arch=cfg.name, fused=fused, fallback=rw.fused_fallback,
         weights_build_s=build_s, first_generate_s=first_generate_s,
         ttft_s=met["ttft_s"], prefill_s=met["prefill_s"],
         decode_s=met["decode_s"], decode_tok_per_s=met["decode_tok_per_s"],
         e2e_tok_per_s=met["e2e_tok_per_s"], peak_bytes=peak,
         resident_bytes=rb, peak_resident_bytes=peak_resident,
         dense_resident_bytes=rw.dense_resident_bytes(),
         dense_bf16_bytes=bf16, launches=launches,
         launches_in_generate=during, fused_launches_per_forward=per_forward,
         ans_decode_launches=ans,
         prefetch_hits=c1["resident.prefetch_hit"]
         - c0["resident.prefetch_hit"],
         prefetch_waits=c1["resident.prefetch_wait"]
         - c0["resident.prefetch_wait"],
         consume_wait_s=c1["resident.consume_wait_s"]
         - c0["resident.consume_wait_s"],
         logits_max_abs_err_vs_dense=err, atol=REF_ATOL,
         greedy_token_agreement_vs_serve=float(
             (out.cpu() == dense_tokens).float().mean()),
         tokens=out[0].tolist())
    if not err <= REF_ATOL:
        raise AssertionError(f"resident vs dense logits differ by {err}")
    if not peak_resident < bf16:
        raise AssertionError(f"peak resident {peak_resident} >= bf16 {bf16}")
    if tuple(out.shape) != (BATCH, GEN) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("resident generate output malformed")
    return rw, launches


def reference_check(dev):
    """Reduced qwen3-1.7b: the port on the card against the port on the
    CPU, from one container."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.store import CompressedModel
    from repro_torch.models import dense
    from repro_torch.serving import engine
    from repro_torch.serving.resident import CompressedResidentWeights

    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    host = {k: v.float().numpy()
            for k, v in dense.init(cfg, 1, torch.device("cpu")).items()}
    cm = CompressedModel.compress(host, spec=parse_spec(SPEC
                                                        + REDUCED_SEGMENTS))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
    runs = {}
    for d, backend in ((dev, "cuda"), (torch.device("cpu"), "torch")):
        params = engine.load_params_from_compressed(cm, backend=backend,
                                                    device=d)
        eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=16),
                            device=d)
        with torch.inference_mode():
            logits, _ = eng.steps.prefill_fn(
                params, torch.as_tensor(prompt, device=d))
        runs[d.type] = (params, logits.float().cpu(),
                        eng.generate(prompt, 8).cpu())
    # compressed-resident fused: every reduced matrix tiles 4096-symbol
    # segments, so all of them go through the fused kernels (their plain
    # version on the CPU)
    resident = {}
    for d, backend in ((dev, "cuda"), (torch.device("cpu"), "torch")):
        rw = CompressedResidentWeights(cm, cfg, backend=backend, fused=True,
                                       device=d)
        assert not rw.fused_fallback, rw.fused_fallback
        steps = engine.ServeSteps(cfg, engine.ServeConfig(max_len=16),
                                  resident="compressed")
        with torch.inference_mode():
            logits, _ = steps.prefill_fn(rw, torch.as_tensor(prompt,
                                                             device=d))
        resident[d.type] = logits.float().cpu()
        rw.close()
    (pc, lc, tc), (pp, lp, tp) = runs["cuda"], runs["cpu"]
    for name in pp:
        a, b = pc[name], pp[name]
        parts = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in parts:
            assert torch.equal(x.cpu(), y), name
    err = float((lc - lp).abs().max())
    rerr = float((resident["cuda"] - resident["cpu"]).abs().max())
    agree = float((tc == tp).float().mean())
    emit("reference", arch=cfg.name, logits_max_abs_err=err,
         resident_fused_logits_max_abs_err=rerr,
         resident_fused_vs_dense_cpu_max_abs_err=float(
             (resident["cpu"] - lp).abs().max()),
         atol=REF_ATOL, greedy_token_agreement=agree,
         argmax_equal_first_token=bool((tc[:, 0] == tp[:, 0]).all()))
    if not err <= REF_ATOL:
        raise AssertionError(f"card vs CPU logits differ by {err}")
    if not rerr <= REF_ATOL:
        raise AssertionError(f"resident card vs CPU logits differ by {rerr}")


def kernel_phase(cm, launches, clock_mhz, dev):
    """Each kernel on the first chunk of its family the main path decoded,
    against its plain version on the same card inputs."""
    import numpy as np
    import torch
    from repro_torch.core import decode_backends
    from repro_torch.core.codecs import RawCodeTable
    from repro_torch.core.scheduler import pack_segments
    from repro_torch.kernels import ans_decode, huffman_decode

    first = {}
    for chunk in cm.scheduler(backend="numpy").plan():
        t = cm.table_for(chunk.segs[0].tensor)
        first.setdefault(t.kernel, (chunk, t))
    rows = []
    for kernel, (chunk, table) in sorted(first.items()):
        mat, counts = pack_segments(cm.payload, chunk.segs)
        mc = int(counts.max())
        a = table.decode_arrays()
        m = torch.from_numpy(mat).to(dev)
        c = torch.from_numpy(counts.astype(np.int32)).to(dev)
        if kernel == "prefix":
            tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                    for k in ("lut_sym", "lut_len")]
            kw = dict(max_len=table.peek_bits, max_count=mc)
            fn, plain, mod = (huffman_decode.decode_streams,
                              huffman_decode.decode_streams_plain,
                              "huffman_decode")
            entry = "prefix_decode"
            replaces = "src/repro/kernels/huffman_decode.py:33"
        else:
            tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                    for k in ("tab_sym", "tab_bits", "tab_base")]
            kw = dict(table_log=table.table_log, max_count=mc)
            fn, plain, mod = (ans_decode.decode_streams_tans,
                              ans_decode.decode_streams_tans_plain,
                              "ans_decode")
            entry = "tans_decode"
            replaces = "src/repro/kernels/ans_decode.py:34"
        fn(m, c, *tabs, **kw)                       # warm-up
        torch.cuda.synchronize()
        queued_ms, _ = cuda_ms_queued(lambda: fn(m, c, *tabs, **kw),
                                      TIMED_LAUNCHES, clock_mhz)
        ms, got = cuda_ms(lambda: fn(m, c, *tabs, **kw), TIMED_LAUNCHES)
        # what the kernel counted in the last timed launch: the cycles of
        # its longest block (for the tANS chain, one dependent step a
        # symbol) and, for prefix, the sync passes
        passes, cycles = huffman_decode.launch_stats(entry, dev)
        measured = dict(block_cycles=cycles, cycles_per_step=cycles / mc)
        if kernel == "prefix":
            measured["sync_passes"] = passes
        plain_ms, ref = cuda_ms(lambda: plain(m, c, *tabs, **kw), 1)
        # the backend call the load path makes: host matrix in, host
        # symbols out (copy to the card, kernel, copy back, synchronised)
        backend = decode_backends.get_backend("cuda")
        t0 = time.perf_counter()
        for _ in range(TIMED_LAUNCHES):
            backend.decode_table(table, mat, counts)
        backend_ms = (time.perf_counter() - t0) * 1e3 / TIMED_LAUNCHES
        equal = torch.equal(got, ref)
        err = int((got.long() - ref.long()).abs().max())
        # what this chunk needs: its streams' bytes (not the pow2-padded
        # matrix), counts and tables read once, the symbols written once
        nbytes = (sum(s.nbytes for s in chunk.segs) + 4 * c.numel()
                  + sum(4 * t.numel() for t in tabs) + 4 * got.numel())
        ops = OPS_PER_SYMBOL * int(counts.sum())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / SCALAR_OPS_PER_S * 1e3
        row = dict(name=mod, route="cuda",
                   source="src/repro_torch/csrc/entropy_decode.cu",
                   entry_point=entry, replaces=replaces,
                   launches=launches[mod], max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   library_ms=None, bitwise_equal=equal,
                   tolerance="bitwise", codec=f"{table.codec_name}{table.bits}",
                   shape=[int(m.shape[0]), int(m.shape[1]), mc],
                   bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                   device_queued_ms=queued_ms, backend_call_ms=backend_ms,
                   **measured)
        # not measured: the host round trip as a host-clock time less a
        # device-event time
        emit("kernel", **row,
             estimates=dict(host_round_trip_ms=backend_ms - ms))
        if not equal:
            raise AssertionError(f"{mod} differs from its plain version")
        rows.append(row)

    # the raw codec's identity LUT through the prefix kernel, small case:
    # subsequences start on codewords, so no sync pass is needed
    for bits in (4, 8):
        rng = np.random.default_rng(2)
        syms = rng.integers(0, 1 << bits, (8, 4096)).astype(np.uint8)
        raw = RawCodeTable(np.bincount(syms.ravel(), minlength=1 << bits),
                           bits=bits)
        streams = [raw.encode(s)[0] for s in syms]
        width = max(len(s) for s in streams)
        mat = np.zeros((8, width), np.uint8)
        for i, s in enumerate(streams):
            mat[i, :len(s)] = s
        args = [torch.from_numpy(mat).to(dev),
                torch.full((8,), 4096, dtype=torch.int32, device=dev),
                torch.from_numpy(raw.lut_sym).to(dev),
                torch.from_numpy(raw.lut_len).to(dev)]
        got = huffman_decode.decode_streams(*args, max_len=bits,
                                            max_count=4096)
        passes = huffman_decode.sync_passes(dev)
        ref = huffman_decode.decode_streams_plain(*args, max_len=bits,
                                                  max_count=4096)
        ok = torch.equal(got, ref) and np.array_equal(got.cpu().numpy(),
                                                      syms)
        emit("kernel_raw", name="huffman_decode", codec=f"raw{bits}",
             shape=[8, width, 4096], bitwise_equal=ok, sync_passes=passes)
        if not ok:
            raise AssertionError(f"raw{bits} identity-LUT decode differs")
    return rows


def fused_kernel_rows(rw, launches, clock_mhz, dev, rows=FUSED_ROWS):
    """Each fused kernel on layer 0's handles of the resident path
    (``rows``: by default qwen3's ``wo`` prefix and ``wq``, ``wk``,
    ``w_down`` tANS), at the ``FUSED_M`` row counts.  A row marked so is
    held against the plain version, called once on the rows of every shape
    stacked (``plain_ms`` is that call's, ``plain_rows`` its rows), the
    others against ``x @ deq(symbols)``, the symbols from the decode kernel
    (the plain version's Python loop would cost the script seconds more a
    tensor): the plain version's own arithmetic on exact symbols.  Two
    launches must be bitwise equal, and one-hot rows of x bitwise the
    dequantized weight's rows.  Returns a summary row for each kernel with
    a plain-checked tensor."""
    import numpy as np
    import torch
    from repro_torch.core.scheduler import plan_fused_spans
    from repro_torch.kernels import ans_decode, huffman_decode
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq

    heads, worst = {}, {}
    for short, plain_checked in rows:
        fq = rw._fused_slots[0][short]
        name = f"fused_{fq.family}"
        entry = f"{name}_matmul"
        replaces = FUSED_REPLACES[fq.family]
        S, K, N = fq.mat.shape[0], fq.K, fq.N
        # the expected dequantized weight, through the decode kernel (held
        # bitwise against its own plain version in the rows above)
        counts = torch.full((S,), fq.seg, dtype=torch.int32, device=dev)
        if fq.family == "prefix":
            q = huffman_decode.decode_streams(fq.mat, counts, *fq.tabs,
                                              max_len=fq.tbits,
                                              max_count=fq.seg)
        else:
            q = ans_decode.decode_streams_tans(fq.mat, counts, *fq.tabs,
                                               table_log=fq.tbits,
                                               max_count=fq.seg)
        w = deq(QT(q.reshape(K, N).to(torch.uint8), fq.scale, fq.zero))
        span = plan_fused_spans(rw.model, rw.n_layers,
                                [f"layers/{short}"])[f"layers/{short}"][0]
        stream_bytes = sum(int(s.nbytes) for s in span.segs)
        xs = [torch.from_numpy(np.random.default_rng(M).normal(
            0, 1, (M, K)).astype(np.float32)).to(dev, torch.bfloat16)
            for M in FUSED_M]
        if plain_checked:
            # one plain call on every shape's rows stacked (its decode, the
            # Python loop, costs seconds; its product is row by row), cut
            # back into each shape's rows
            plain_ms, stacked = cuda_ms(
                lambda: fdm.fused_decode_matmul_plain(torch.cat(xs), fq), 1)
            plain_refs = stacked.split(list(FUSED_M))
        per_m = {}
        for i, (M, x) in enumerate(zip(FUSED_M, xs)):
            first = fdm.fused_decode_matmul(x, fq)           # warm-up
            torch.cuda.synchronize()
            queued_ms, _ = cuda_ms_queued(
                lambda: fdm.fused_decode_matmul(x, fq), TIMED_LAUNCHES,
                clock_mhz)
            ms, got = cuda_ms(lambda: fdm.fused_decode_matmul(x, fq),
                              TIMED_LAUNCHES)
            # what the kernel counted in the last timed launch
            passes, cycles = fdm.launch_stats(entry, dev)
            measured = dict(block_cycles=cycles)
            if fq.family == "prefix":
                measured["sync_passes"] = passes
            else:
                measured["cycles_per_step"] = cycles / fq.seg
            deterministic = torch.equal(first, got)
            dense_ms, dense = cuda_ms(lambda: x @ w, TIMED_LAUNCHES)
            if plain_checked:
                ref = plain_refs[i]
                against = "plain version"
            else:
                ref = dense
                against = "x @ deq(decode kernel's symbols)"
            err = float((got.float() - ref.float()).abs().max())
            close = bool(torch.allclose(got.float(), ref.float(),
                                        atol=FUSED_TOL, rtol=FUSED_TOL))
            pick = torch.tensor([0, 1, K // 2, K - 1], device=dev)
            onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=dev)
            onehot[torch.arange(4, device=dev), pick] = 1
            onehot_equal = torch.equal(fdm.fused_decode_matmul(onehot, fq),
                                       w[pick])
            # each input read once (the lanes' stream bytes, tables, affine,
            # x), the output written once; the decode's integer work and the
            # product's bf16 FLOPs
            nbytes = (stream_bytes + sum(4 * t.numel() for t in fq.tabs)
                      + 4 * (fq.scale.numel() + fq.zero.numel())
                      + 2 * M * K + 2 * M * N)
            int_ops, flops = OPS_PER_SYMBOL * K * N, 2 * M * K * N
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = (int_ops / SCALAR_OPS_PER_S
                      + flops / BF16_FLOPS_PER_S) * 1e3
            per_m[M] = dict(
                ms=ms, device_queued_ms=queued_ms,
                plain_ms=plain_ms if plain_checked else None,
                plain_rows=sum(FUSED_M) if plain_checked else None,
                max_abs_err=err, against=against,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                allclose=close, onehot_bitwise=onehot_equal,
                deterministic=deterministic,
                shape=[M, K, N], lanes=S, seg=fq.seg,
                lane_bytes=int(fq.mat.shape[1]), bytes=nbytes,
                int_ops=int_ops, flops=flops, bytes_ms=bytes_ms,
                ops_ms=ops_ms, partial_bytes=4 * S * M * N,
                dense_bf16_matmul_ms=dense_ms, **measured)
            emit("kernel", name=name, route="cuda",
                 source="src/repro_torch/csrc/fused_decode_matmul.cu",
                 replaces=replaces, tensor=f"layers/{short}[0]",
                 codec=f"{fq.family}{fq.bits}", tolerance=FUSED_TOL,
                 library_ms=None, launches=launches[name],
                 dense_bf16_matmul_is="a floor, not the same function: "
                 "torch.matmul of x on the weight dequantized beforehand",
                 **per_m[M])
            worst[name] = max(worst.get(name, 0.0), err)
            if not close:
                raise AssertionError(f"{name} {short} M={M} differs from "
                                     f"the {against} by {err}")
            if not onehot_equal:
                raise AssertionError(f"{name} {short}: one-hot rows are not "
                                     f"the dequantized weight's rows")
            if not deterministic:
                raise AssertionError(f"{name} {short} M={M}: two launches "
                                     f"differ")
        if plain_checked:
            heads[name] = (short, replaces, per_m)
    # one summary row a kernel, from its plain-checked tensor; the error is
    # the worst over all its shapes
    summary = []
    for name, (short, replaces, per_m) in heads.items():
        head = per_m[BATCH]
        at = lambda M: {k: per_m[M][k] for k in (  # noqa: E731
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "onehot_bitwise")}
        summary.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/fused_decode_matmul.cu",
            replaces=replaces, launches=launches[name],
            max_abs_err=worst[name], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=None, tolerance=FUSED_TOL,
            tensor=f"layers/{short}[0]", shape=head["shape"],
            onehot_bitwise=head["onehot_bitwise"],
            m128=at(BATCH * PROMPT), m8=at(N_SLOTS),
            m16=at(PREFILL_CHUNK)))
    return summary


def cuda_ms_cold(fn, n, flush):
    """Mean device time of ``fn`` over ``n`` launches, each timed alone with
    CUDA events after ``flush`` (a write larger than the 50 MB L2) has
    evicted what the previous launch left in L2."""
    import torch
    pairs = []
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def queued_launch_ms(fn, n, clock_mhz, flush=None):
    """Device times of ``n`` launches of ``fn`` (sorted, ms), each between
    its own pair of CUDA events, all queued behind a 20 ms spin kernel: the
    host enqueues them before the first runs, so its launch path adds no
    gap between an event and its launch.  Cold when ``flush`` (a write
    larger than the 50 MB L2) is written before each launch."""
    import torch
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(int(20e3 * clock_mhz))
    for start, end in pairs:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)


def dequant_operands(cm, params, dev):
    """Layer 0's quantized matrices and ``lm_head`` as the serve phase
    decoded them onto the card, in the kernel's layout: rANS-4 matrices
    unpacked from QT4's packing along N and re-packed along K
    (``ops.pack_nibbles``), Huffman-8 ones as uint8 symbols.  A layer
    matrix's scale and zero are the container's (one pair a layer);
    ``lm_head`` is quantized per row of K, which the kernel's per output
    channel affine cannot hold, so it takes the mean of its rows' scale and
    zero as scalars.  Last, ``w_down`` again with a seeded (N,) affine."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    cases = []
    for name in DQ_TENSORS:
        w = params[name]
        lw = layers.layer_slice(w, 0) if name.startswith("layers/") else w
        if isinstance(lw, layers.QT4):
            sym = layers._unpack4(lw.q)
            wq = torch.from_numpy(ops.pack_nibbles(sym.cpu().numpy())).to(dev)
        else:
            sym, wq = lw.q, lw.q.contiguous()
        if lw.scale.numel() == 1:
            affine = "per-tensor (container)"
            scale, zero = lw.scale.reshape(()), lw.zero.reshape(())
        else:
            affine = "mean of the container's per-row pairs"
            scale, zero = lw.scale.mean(), lw.zero.mean()
        t = cm.table_for(name)
        cases.append(dict(
            tensor=f"{name}[0]" if name.startswith("layers/") else name,
            codec=f"{t.codec_name}{t.bits}", wq=wq, sym=sym,
            int4=isinstance(lw, layers.QT4), scale=scale.float(),
            zero=zero.float(), affine=affine))
    base = next(c for c in cases if c["tensor"] == "layers/w_down[0]")
    N = base["sym"].shape[1]
    rng = np.random.default_rng(3)
    s0, z0 = float(base["scale"]), float(base["zero"])
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa
    cases.append(dict(base, affine="per-channel (N,), seeded",
                      scale=f32(s0 * rng.uniform(0.5, 1.5, N)),
                      zero=f32(z0 + abs(z0) * rng.uniform(-0.5, 0.5, N))))
    return cases


def dequant_matmul_phase(cm, params, clock_mhz, dev):
    """Compress -> container -> CUDA decode (the serve phase) ->
    ``ops.dequant_matmul`` on layer 0's matrices and ``lm_head`` at full
    width, at a decode step (M = 4) and a prefill (M = 128).  Launch counts
    are zeroed just before those calls and read just after, and the plan
    each call launched (variant, rows a tile, splits, workspace) is read
    from the wrapper after it; then each case against its plain version on
    the card, one-hot rows bitwise, and times."""
    import numpy as np
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import dequant_matmul as dm

    cases = dequant_operands(cm, params, dev)
    runs = []
    for c in cases:
        K = c["sym"].shape[0]
        for M in DQ_M:
            x = torch.from_numpy(np.random.default_rng(M + K).normal(
                0, 1, (M, K)).astype(np.float32)).to(dev, torch.bfloat16)
            runs.append((c, x))
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    outs, plans = [], []
    for c, x in runs:
        outs.append(ops.dequant_matmul(x, c["wq"], c["scale"], c["zero"],
                                       int4=c["int4"]))
        plans.append(dm.launch_plan(dev))
    torch.cuda.synchronize()
    launches = build.launches["dequant_matmul"]
    if launches != len(runs):
        raise AssertionError(f"dequant_matmul launched {launches} times for "
                             f"{len(runs)} calls")

    emit("dequant_matmul", calls=len(runs), launches=launches,
         timing=f"ms and dense_bf16_matmul_ms: mean of {DQ_TIMED} launches, "
         "each timed alone with CUDA events after a 256 MB write flushed "
         "L2; cold_queued_ms and dense_bf16_cold_queued_ms: the median of "
         f"{DQ_TIMED} such launches all queued behind a spin kernel "
         "(cold_queued_range: least and most)",
         dense_bf16_matmul_is="a floor, not the same function: torch.matmul "
         "of bf16 x on the weight dequantized beforehand",
         library_ms="none: no PyTorch call dequantizes an affine uint8 or "
         "K-packed uint4 weight and multiplies")
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    rows, worst = [], 0.0
    for (c, x), got, plan in zip(runs, outs, plans):
        M, K = x.shape
        N = c["sym"].shape[1]
        args = (x, c["wq"], c["scale"], c["zero"])
        if tuple(got.shape) != (M, N) or not bool(
                torch.isfinite(got.float()).all()):
            raise AssertionError(f"{c['tensor']} M={M}: output malformed")
        plain_ms, ref = cuda_ms(
            lambda: dm.dequant_matmul_plain(*args, int4=c["int4"]), 1)
        err = float((got.float() - ref.float()).abs().max())
        close = bool(torch.allclose(got.float(), ref.float(), atol=DQ_TOL,
                                    rtol=DQ_TOL))
        pick = torch.tensor([0, 1, K // 2, K - 1], device=dev)
        onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=dev)
        onehot[torch.arange(4, device=dev), pick] = 1
        w_rows = (c["sym"][pick].float() * c["scale"].reshape(1, -1)
                  + c["zero"].reshape(1, -1)).to(torch.bfloat16)
        onehot_equal = torch.equal(
            dm.dequant_matmul(onehot, *args[1:], int4=c["int4"]), w_rows)

        def fn():
            return dm.dequant_matmul(*args, int4=c["int4"])
        ms = cuda_ms_cold(fn, DQ_TIMED, flush)
        queued = queued_launch_ms(fn, DQ_TIMED, clock_mhz, flush)
        w_bf16 = (dm.unpack_k(c["wq"]) if c["int4"] else c["wq"]).float()
        w_bf16 = (w_bf16 * c["scale"].reshape(1, -1)
                  + c["zero"].reshape(1, -1)).to(torch.bfloat16)

        def dense():
            return torch.matmul(x, w_bf16)
        dense_ms = cuda_ms_cold(dense, DQ_TIMED, flush)
        dense_queued = queued_launch_ms(dense, DQ_TIMED, clock_mhz, flush)
        del w_bf16
        # each input read once (x, the weight at its stored width, scale
        # and zero), the output written once; the MMA's bf16 FLOPs and the
        # dequant's multiply and add per weight
        nbytes = (2 * M * K + c["wq"].numel()
                  + 4 * (c["scale"].numel() + c["zero"].numel()) + 2 * M * N)
        flops, deq_ops = 2 * M * K * N, 2 * K * N
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (flops / BF16_FLOPS_PER_S + deq_ops / SCALAR_OPS_PER_S) * 1e3
        row = dict(name="dequant_matmul", route="cuda",
                   source="src/repro_torch/csrc/dequant_matmul.cu",
                   replaces="src/repro/kernels/dequant_matmul.py:33",
                   tensor=c["tensor"], codec=c["codec"],
                   weight="uint4 packed along K" if c["int4"] else "uint8",
                   affine=c["affine"], shape=[M, K, N], launches=launches,
                   variant=plan.variant, bm=plan.bm, splits=plan.splits,
                   k_per_split=plan.k_per_split, blocks=plan.blocks,
                   workspace_bytes=plan.workspace_bytes,
                   ms=ms, cold_queued_ms=queued[len(queued) // 2],
                   cold_queued_range=[queued[0], queued[-1]],
                   plain_ms=plain_ms, max_abs_err=err,
                   tolerance=DQ_TOL, allclose=close,
                   onehot_bitwise=onehot_equal,
                   bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes=nbytes, flops=flops, dequant_ops=deq_ops,
                   bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=None,
                   dense_bf16_matmul_ms=dense_ms,
                   dense_bf16_cold_queued_ms=dense_queued[
                       len(dense_queued) // 2])
        emit("kernel", **row)
        if not close:
            raise AssertionError(f"dequant_matmul {c['tensor']} M={M} "
                                 f"differs from its plain version by {err}")
        if not onehot_equal:
            raise AssertionError(f"dequant_matmul {c['tensor']} M={M}: "
                                 f"one-hot rows are not the weight's rows")
        worst = max(worst, err)
        rows.append(row)
    del flush
    head = next(r for r in rows if r["tensor"] == "lm_head"
                and r["shape"][0] == DQ_M[0])
    return dict(
        {k: head[k] for k in (
            "name", "route", "source", "replaces", "launches", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "dense_bf16_matmul_ms", "tensor", "shape", "variant", "splits",
            "workspace_bytes", "tolerance")},
        max_abs_err=worst)


# ------------------------------------------------------------------ moe phase

def write_containers(dirpath, families):
    """Child process (``--containers DIR FAMILY...``): each family's phase
    config (:func:`family_config`) with seeded weights made on the host,
    compressed under its ``FAMILY_SPEC`` and saved to ``DIR/FAMILY.npz``,
    its timings beside it (``.json``); the family ``serve`` is the serve
    phase's (:func:`serve_config`, weights drawn on the card, ``SPEC``).
    Encodes on the host, beside the phases on the card."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.store import CompressedModel
    for family in families:
        t0 = time.perf_counter()
        if family == "serve":
            _, cfg = serve_config()
            host, spec = serve_host_weights(cfg), SPEC
        else:
            _, cfg = family_config(family)
            host, spec = family_host_weights(cfg), FAMILY_SPEC[family]
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cm = CompressedModel.compress(host, spec=parse_spec(spec))
        compress_s = time.perf_counter() - t0
        del host
        path = os.path.join(dirpath, f"{family}.npz")
        t0 = time.perf_counter()
        cm.save(path)
        with open(path + ".json", "w") as f:
            json.dump(dict(init_s=init_s, compress_s=compress_s,
                           save_s=time.perf_counter() - t0), f)
        del cm


def start_containers(*families):
    """Start this script as a child that writes ``families``' containers;
    returns (process, directory, families).  Its errors go to
    ``DIR/child.log``."""
    dirpath = os.path.join(ROOT, "build", "chip_smoke", "-".join(families))
    os.makedirs(dirpath, exist_ok=True)
    for name in os.listdir(dirpath):
        os.remove(os.path.join(dirpath, name))
    with open(os.path.join(dirpath, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--containers",
             dirpath, *families],
            stdout=subprocess.DEVNULL, stderr=log, cwd=ROOT)
    return proc, dirpath, families


def containers(proc, dirpath, families, keep=None):
    """Wait for a :func:`start_containers` child; returns {family:
    (container, its timings and the seconds waited)}.  The files of the
    families in ``keep`` ({family: arch}) move to :func:`mesh_container`'s
    place."""
    from repro_torch.core.store import CompressedModel
    t0 = time.perf_counter()
    rc = proc.wait()
    waited = time.perf_counter() - t0
    log = os.path.join(dirpath, "child.log")
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"container child {families} exited {rc}: "
                                 f"{f.read()[-2000:]}")
    out = {}
    for family in families:
        path = os.path.join(dirpath, f"{family}.npz")
        with open(path + ".json") as f:
            made = json.load(f)
        t0 = time.perf_counter()
        cm = CompressedModel.load(path)
        made["load_s"] = time.perf_counter() - t0
        made["waited_s"] = waited
        out[family] = (cm, made)
        os.remove(path + ".json")
        if family in (keep or {}):
            os.replace(path, mesh_container(keep[family]))
        else:
            os.remove(path)
    os.remove(log)
    return out


def start_static():
    """Start ``python -m repro_torch.analysis --json`` as a child on the
    host (no card visible, one thread); returns (process, directory, its
    start on the wall clock).  Its output goes to ``DIR/out.json``, its
    errors to ``DIR/err.log``."""
    dirpath = os.path.join(ROOT, "build", "chip_smoke", "static")
    os.makedirs(dirpath, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    with open(os.path.join(dirpath, "out.json"), "w") as out, \
            open(os.path.join(dirpath, "err.log"), "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis", "--json"],
            stdout=out, stderr=err, cwd=ROOT, env=env)
    return proc, dirpath, time.time()


def static_phase(child):
    """Wait for :func:`start_static`'s child and print the ``static``
    line (``wall_s``: from its start to its last write); a new finding
    (the gate exits 1) or a failed run raises."""
    proc, dirpath, t0 = child
    rc = proc.wait()
    out = os.path.join(dirpath, "out.json")
    wall = os.path.getmtime(out) - t0
    with open(out) as f:
        text = f.read()
    with open(os.path.join(dirpath, "err.log")) as f:
        err = f.read()
    if rc not in (0, 1) or not text.strip():
        raise AssertionError(f"static analysis exited {rc}: {err[-2000:]}")
    got = json.loads(text)
    new = got["findings"]
    emit("static", checkers=got["checkers"], baselined=got["accepted"],
         new=len(new), stale=len(got["stale_baseline"]),
         seconds=got["seconds"], wall_s=wall)
    if rc != 0 or new:
        raise AssertionError("static analysis: new findings: " + "; ".join(
            f"{f['file']}:{f['line']} {f['rule']} {f['message']}"
            for f in new))


@contextlib.contextmanager
def recorded_routes():
    """Records each ``moe.route`` call's (probs, top-k ids) on the host,
    in call order (one a layer a forward)."""
    from repro_torch.models import moe
    got, orig = [], moe.route

    def recording(x, router, k):
        out = orig(x, router, k)
        got.append((out[0].detach().float().cpu().numpy(),
                    out[2].cpu().numpy()))
        return out

    moe.route = recording
    try:
        yield got
    finally:
        moe.route = orig


def route_flips(routes, want):
    """Every router choice of ``routes`` that differs from ``want``'s (both
    from :func:`recorded_routes`), with the gap of ``want``'s probabilities
    between the experts the two picked and its near-tie limit (two bf16
    steps at the k-th probability: ROADMAP's rule)."""
    import math
    import numpy as np
    flips = []
    for layer, ((_, a), (probs, b)) in enumerate(zip(routes, want)):
        for r, s in zip(*np.nonzero((np.sort(a, -1) != np.sort(b, -1))
                                    .any(-1))):
            p = probs[r, s]
            gap = abs(float(p[np.setdiff1d(a[r, s], b[r, s])].min()
                            - p[np.setdiff1d(b[r, s], a[r, s])].max()))
            kth = float(np.sort(p)[-b.shape[-1]])
            limit = 2 * 2.0 ** (math.frexp(kth)[1] - 8)
            flips.append(dict(call=layer, row=int(r), pos=int(s), gap=gap,
                              limit=limit, near_tie=gap <= limit))
    return flips


def moe_prompt(cfg):
    """The moe phase's seeded lockstep prompt (its mesh world's too)."""
    import numpy as np
    return np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT))


def moe_dense(cm, made, cfg, full, dev):
    """Step 1: :func:`dense_serve` on the moe container, and a ``profile``
    of its decode steps."""
    prompt = moe_prompt(cfg)
    eng, out, _, launches, fields = dense_serve(
        cfg, cm, family_host_weights(cfg), SPEC, prompt, dev)
    profile_decode(eng, prompt, dev, what=f"{cfg.name} decode steps")
    emit("moe", step="dense", **fields,
         reduced={"n_layers": [full.n_layers, MOE_DEPTH]},
         heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd], d_ff=cfg.d_ff,
         experts=[cfg.moe.num_experts, cfg.moe.padded_experts(16)],
         top_k=cfg.moe.top_k, shared_experts=cfg.moe.shared_experts,
         capacity_factor=cfg.moe.capacity_factor, container=made)
    return eng.params, prompt, out.cpu(), launches


def serve_all(cfg, params, dev, trace, **engine_kw):
    """Every request of ``trace`` submitted at once, then served to the end
    (no arrival pacing: two runs pack their steps the same way)."""
    from repro_torch.serving import engine
    from repro_torch.serving.batching import ContinuousEngine
    ce = ContinuousEngine(cfg, params, engine.ServeConfig(max_len=CONT_MAX_LEN),
                          n_slots=N_SLOTS, prefill_chunk=PREFILL_CHUNK,
                          max_queue=MAX_QUEUE, device=dev, **engine_kw)
    reqs = [ce.submit(p, g) for _, p, g in trace]
    t0 = time.perf_counter()
    ce.run()
    makespan = time.perf_counter() - t0
    if not all(r.finish_reason == "length" for r in reqs):
        raise AssertionError("a request did not finish")
    toks = sum(len(r.output) for r in reqs)
    return ce, [r.output for r in reqs], dict(
        tokens=toks, makespan_s=makespan, tok_per_s=toks / makespan,
        n_decode_steps=ce.n_decode_steps, prefill_chunks=ce.n_prefill_chunks)


def moe_continuous(cfg, params, dev):
    """Steps 2 and 3: the ``TRAFFIC`` trace replayed through the
    ``ContinuousEngine`` at the published capacity (its low-capacity
    warning must fire), against each request's solo run; then the trace's
    requests, all submitted at once, through the slot pool and through bf16
    paged blocks of 16 without prefix sharing in a pool that never makes
    admission wait: the same packing, so the same capacity every step, and
    tokens bitwise equal request by request.  No kernel launches in
    either."""
    import warnings
    import torch
    from repro_torch.core.spec import KVCompressionSpec
    from repro_torch.kernels import build
    from repro_torch.serving import engine
    torch.cuda.synchronize()
    for k in build.launches:
        build.launches[k] = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ce, reqs, trace, run = serve_trace(cfg, params, "dense", dev)
    warned = [str(w.message) for w in caught
              if "capacity_factor" in str(w.message)]
    if not warned:
        raise AssertionError("moe: the low-capacity warning did not fire")
    solo = engine.Engine(cfg, params, engine.ServeConfig(max_len=CONT_MAX_LEN),
                         device=dev)
    same, pairs = 0, []
    for (_, prompt, gen), r in zip(trace, reqs):
        want = solo.generate(prompt[None], gen)[0].tolist()
        same += want == r.output
        pairs += list(zip(want, r.output))
    emit("moe", step="continuous", arch=cfg.name, n_slots=N_SLOTS,
         prefill_chunk=PREFILL_CHUNK, max_len=CONT_MAX_LEN, traffic=TRAFFIC,
         capacity_factor=cfg.moe.capacity_factor, warning=warned[0], **run,
         requests_equal_solo=same, solo_compared=len(trace),
         token_agreement_vs_solo=sum(a == b for a, b in pairs) / len(pairs),
         tokens_request0=reqs[0].output)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, slot_out, slot_run = serve_all(cfg, params, dev, trace)
        torch.cuda.reset_peak_memory_stats(dev)
        pce, paged_out, paged_run = serve_all(
            cfg, params, dev, trace,
            kv_spec=KVCompressionSpec.parse(MOE_PAGED_SPEC))
    launches = dict(build.launches)
    equal = sum(a == b for a, b in zip(paged_out, slot_out))
    emit("moe", step="paged", arch=cfg.name, kv_spec=MOE_PAGED_SPEC,
         kv_blocks=pce.slots.n_blocks, slot_pool=slot_run, paged=paged_run,
         peak_bytes=torch.cuda.max_memory_allocated(dev),
         requests_equal_slot_pool=equal, compared=len(trace),
         launches=launches, **pce.slots.stats())
    if paged_out != slot_out:
        raise AssertionError(f"moe paged bf16 differs from the slot pool: "
                             f"{equal} of {len(trace)} requests equal")
    if any(launches.values()):
        raise AssertionError(f"moe continuous / paged launches {launches}")


def moe_resident(cm, cfg, prompt, dense_tokens, dev):
    """Step 4: compressed-resident fused serving of the container: the
    attention matrices, the router and ``shared_w_down`` fused, the 4-D
    expert stacks and the shared gate / up (rows of 5632) on the per-layer
    decode; launch counts exact, as the resident phase holds them."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine
    from repro_torch.serving.resident import CompressedResidentWeights
    counters = ("resident.prefetch_hit", "resident.prefetch_wait",
                "resident.consume_wait_s")
    read = lambda: {c: obs_metrics.counter(c).total()  # noqa: E731
                    for c in counters}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in build.launches:
        build.launches[k] = 0
    t0 = time.perf_counter()
    rw = CompressedResidentWeights(cm, cfg, backend="cuda", fused=True,
                                   device=dev)
    build_s = time.perf_counter() - t0
    built = dict(build.launches)
    fused = {n: rw._fused_slots[0][n.split("/", 1)[1]].family
             for n in rw._fused}
    if fused != MOE_FUSED:
        raise AssertionError(f"moe fused tensors {fused}, expected "
                             f"{MOE_FUSED}")
    want = {n: "is not a stacked (L, K, N) matrix" for n in MOE_STACKS}
    want.update({f"layers/moe/shared_w_{g}": MOE_SHARED_FALLBACK
                 for g in ("gate", "up")})
    if set(rw.fused_fallback) != set(want) or not all(
            want[n] in r for n, r in rw.fused_fallback.items()):
        raise AssertionError(f"moe fallback {rw.fused_fallback}")
    eng = engine.Engine(cfg, rw, engine.ServeConfig(max_len=PROMPT + GEN),
                        device=dev, resident="compressed")
    c0 = read()
    # the port's spans over the generate, no device fences: where a forward
    # goes (the worker's layer decode and its decode calls, the engine's
    # layers and its waits for the worker)
    tracer = obs_trace.enable()
    out, met = eng.generate(prompt, MOE_RESIDENT_GEN, echo_metrics=True)
    speculative = rw.wait_prefetches()
    obs_trace.disable()
    launches, c1 = dict(build.launches), read()
    spans = {}
    for e in tracer.events:
        n, t = spans.get(e.name, (0, 0.0))
        spans[e.name] = (n + 1, t + e.dur_us / 1e6)
    peak = torch.cuda.max_memory_allocated(dev)
    for k in ("huffman_decode", "ans_decode", "fused_prefix", "fused_tans"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the moe resident "
                                 f"path")
    forwards = MOE_RESIDENT_GEN      # the prefill and the decode steps
    per_forward = fused_per_forward(rw)
    fused_launches = {k: launches[k] for k in per_forward}
    if fused_launches != {k: forwards * v for k, v in per_forward.items()}:
        raise AssertionError(f"moe fused launches {fused_launches}, expected "
                             f"{forwards} x {per_forward}")
    per_layer = fallback_calls_per_layer(rw)
    ans = dict(at_build=built["ans_decode"], per_forward=sum(per_layer),
               forwards=forwards, speculative_prefetches=speculative,
               per_prefetch=per_layer[0])
    ans["expected"] = (ans["at_build"] + forwards * ans["per_forward"]
                       + speculative * per_layer[0])
    if launches["ans_decode"] != ans["expected"]:
        raise AssertionError(f"moe ans_decode launched "
                             f"{launches['ans_decode']} times, expected {ans}")
    peak_resident, bf16 = rw.peak_resident_bytes(), rw.dense_bf16_bytes()
    if not peak_resident < bf16:
        raise AssertionError(f"moe peak resident {peak_resident} >= bf16 "
                             f"{bf16}")
    if tuple(out.shape) != (BATCH, MOE_RESIDENT_GEN):
        raise AssertionError(f"moe resident tokens {tuple(out.shape)}")
    rw.close()
    emit("moe", step="resident", arch=cfg.name, fused=fused,
         fallback=rw.fused_fallback, weights_build_s=build_s,
         gen=MOE_RESIDENT_GEN, ttft_s=met["ttft_s"],
         prefill_s=met["prefill_s"], decode_s=met["decode_s"],
         decode_tok_per_s=met["decode_tok_per_s"],
         e2e_tok_per_s=met["e2e_tok_per_s"], peak_bytes=peak,
         resident_bytes=rw.resident_bytes(),
         peak_resident_bytes=peak_resident,
         dense_resident_bytes=rw.dense_resident_bytes(),
         dense_bf16_bytes=bf16, launches=launches,
         fused_launches_per_forward=per_forward, ans_decode_launches=ans,
         prefetch_hits=c1["resident.prefetch_hit"]
         - c0["resident.prefetch_hit"],
         prefetch_waits=c1["resident.prefetch_wait"]
         - c0["resident.prefetch_wait"],
         consume_wait_s=c1["resident.consume_wait_s"]
         - c0["resident.consume_wait_s"],
         spans={n: {"count": c, "s": t} for n, (c, t) in sorted(spans.items())},
         token_agreement_vs_dense=float(
             (out.cpu() == dense_tokens[:, :MOE_RESIDENT_GEN]).float()
             .mean()),
         tokens=out[0].tolist())
    return rw, launches


def moe_phase(container, clock_mhz, dev):
    """qwen2-moe-a2.7b at full width, ``MOE_DEPTH`` layers: the child's
    ``container`` (the container and its timings, :func:`containers`)
    dense-resident, continuous, paged, then compressed-resident fused and
    the fused kernels at the router's and ``shared_w_down``'s shapes.
    Returns each kernel's launches by residency."""
    import torch
    full, cfg = family_config("moe")
    cm, made = container
    params, prompt, tokens, dense_launches = moe_dense(cm, made, cfg, full,
                                                       dev)
    moe_continuous(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    rw, resident_launches = moe_resident(cm, cfg, prompt, tokens, dev)
    fused_kernel_rows(rw, resident_launches, clock_mhz, dev,
                      rows=MOE_FUSED_ROWS)
    return {"dense": dense_launches, "resident": resident_launches}, \
        (cfg, prompt, tokens)


def family_config(family):
    """(published config, the config its phase serves: the moe cut to
    ``MOE_DEPTH`` layers, encdec to ``ENCDEC_DEPTH`` encoder and decoder
    layers, the others whole)."""
    from repro_torch.configs import registry
    full = registry.get(FAMILY_ARCHS[family])
    if family == "moe":
        return full, dataclasses.replace(full, n_layers=MOE_DEPTH)
    if family == "encdec":
        return full, dataclasses.replace(full, n_layers=ENCDEC_DEPTH,
                                         enc_layers=ENCDEC_DEPTH)
    return full, full


def family_host_weights(cfg, seed=0):
    """Seeded random weights of ``cfg``'s family, made on the host: the
    child that compresses them and the phase that checks the card's decode
    make the same ones."""
    import torch
    from repro_torch.models import api
    params = api.build(cfg).init(cfg, seed, torch.device("cpu"))
    return {k: v.float().numpy() for k, v in params.items()}


def carve_outs(host):
    """The names ``SSM_CARVE_OUTS`` keeps float32, sorted."""
    import fnmatch
    return sorted(n for n in host if any(fnmatch.fnmatchcase(n, p)
                                         for p in SSM_CARVE_OUTS))


def decode_launches_from_plan(cm, **sched):
    """The decode kernels' launches of a dense-resident load (or of the
    decode ``sched``'s scheduler arguments give: the checkpoint restore's
    one chunk a table): one a chunk of the plan, by the chunk's table."""
    kernel = {"prefix": "huffman_decode", "tans": "ans_decode"}
    want = {"huffman_decode": 0, "ans_decode": 0}
    for chunk in cm.scheduler(backend="numpy",
                              **(sched or dict(first=("embed",)))).plan():
        want[kernel[cm.table_for(chunk.segs[0].tensor).kernel]] += 1
    return want


def extension_check(eng, prompt, dev):
    """decode_step of the last token at position S-1, after a prefill of
    S-1 tokens, against prefill over all S tokens (the JAX package's
    teacher-forcing check): the logits within ``EXTEND_TOL``, and every
    leaf of the cache the step leaves (the SSM and conv states; the
    self-attention and cross K / V) within ``EXTEND_STATE_RTOL`` of the
    prefill's, layer by layer, relative to the layer's largest |value|.
    Returns the readings, and the bytes of the prefill's cache (the one
    ``Engine.generate`` fills)."""
    import numpy as np
    import torch
    from repro_torch.serving import engine
    full = engine.lockstep_batch(prompt, dev)
    toks = prompt_tokens(full)
    part = (dict(full, tokens=toks[:, :-1]) if isinstance(full, dict)
            else toks[:, :-1])
    with torch.inference_mode():
        want, want_cache = eng.steps.prefill_fn(eng.params, full)
        _, cache = eng.steps.prefill_fn(eng.params, part)
        got, cache = eng.steps.decode_fn(eng.params, toks[:, -1:], cache,
                                         toks.shape[1] - 1)
    a = want[:, -1].float().cpu().numpy()
    b = got[:, -1].float().cpu().numpy()
    ok = bool(np.all(np.abs(a - b) <= EXTEND_TOL["atol"]
                     + EXTEND_TOL["rtol"] * np.abs(b)))
    states = {}
    for key, w in want_cache.items():
        w = w.float().reshape(w.shape[0], -1)
        size = w.abs().amax(1)
        err = (cache[key].float().reshape(w.shape) - w).abs().amax(1)
        held = bool((size > 0).all()
                    and (err <= EXTEND_STATE_RTOL * size).all())
        states[key] = dict(max_rel_err=float((err / size).max()),
                           min_size=float(size.min()), within=held)
        ok = ok and held
    return dict(max_abs_err=float(np.abs(a - b).max()), tol=EXTEND_TOL,
                state_rtol=EXTEND_STATE_RTOL, states=states, within=ok,
                positions=int(toks.shape[1]),
                cache_bytes=sum(v.nbytes for v in want_cache.values()))


def family_prompt(cfg, batch, length, seed=0):
    """Seeded lockstep prompt: tokens, and for encdec the stub frontend's
    ``SRC_FRAMES`` frames (normal, bf16) drawn after them."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, length))
    if cfg.family != "encdec":
        return toks
    return {"tokens": toks, "src_embeds": torch.from_numpy(rng.normal(
        0, 1, (batch, SRC_FRAMES, cfg.d_model))).to(torch.bfloat16)}


def family_dense(family, cm, made, dev):
    """:func:`dense_serve` on a family's container (its float32 carve-outs
    unquantized), the prefill-extension check and a decode-step profile.
    Returns (engine, the phase's fields, launches)."""
    full, cfg = family_config(family)
    prompt = family_prompt(cfg, BATCH, PROMPT)
    host = family_host_weights(cfg)
    carved = carve_outs(host)
    if not set(carved) <= set(cm.unquantized):
        raise AssertionError(f"{family}: carve-outs quantized: "
                             f"{sorted(set(carved) - set(cm.unquantized))}")
    eng, _, _, launches, fields = dense_serve(cfg, cm, host,
                                              FAMILY_SPEC[family], prompt, dev)
    del host
    ext = extension_check(eng, prompt, dev)
    if not ext["within"]:
        raise AssertionError(f"{family} decode vs prefill extension {ext}")
    profile_decode(eng, prompt, dev, what=f"{cfg.name} decode steps")
    fields.update(family=family, container=made, fp32_carve_outs=len(carved),
                  cache_bytes=ext.pop("cache_bytes"), extension=ext)
    if family == "encdec":
        fields.update(reduced={"enc_layers": [full.enc_layers, ENCDEC_DEPTH],
                               "n_layers": [full.n_layers, ENCDEC_DEPTH]},
                      heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd],
                      d_ff=cfg.d_ff, src_frames=SRC_FRAMES)
    else:
        fields.update(reduced={}, n_layers=cfg.n_layers,
                      ssm=dataclasses.asdict(cfg.ssm),
                      ssm_heads=cfg.ssm.n_heads(cfg.d_model))
    return eng, fields, launches


def ssd_check(cfg, dev):
    """``ssd_chunked`` against a loop of ``ssd_step`` at ``SSD_SHAPE`` (the
    model's heads, state and chunk; a partial last chunk; an initial state),
    in float32 on the card, with each one's time."""
    import numpy as np
    import torch
    from repro_torch.models import mamba2
    B, S, H, P, N = (SSD_SHAPE[k] for k in "BSHPN")
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.normal(size=(B, S, H, P)))
    dt = t(rng.uniform(0.01, 0.2, size=(B, S, H)))
    A = t(-rng.uniform(0.5, 4.0, size=(H,)))
    Bm, Cm = t(rng.normal(size=(B, S, N))), t(rng.normal(size=(B, S, N)))
    h0 = t(rng.normal(size=(B, H, P, N)))

    def stepwise():
        h, ys = h0, []
        for i in range(S):
            y, h = mamba2.ssd_step(x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i],
                                   h)
            ys.append(y)
        return torch.stack(ys, 1), h

    chunked = lambda: mamba2.ssd_chunked(  # noqa: E731
        x, dt, A, Bm, Cm, cfg.ssm.chunk, h0=h0)
    chunked()
    ms, (y, h) = cuda_ms(chunked, 3)
    step_ms, (ys, hs) = cuda_ms(stepwise, 1)
    errs = {}
    for name, got, want in (("y", y, ys), ("h", h, hs)):
        d = (got - want).abs()
        errs[name] = dict(
            max_abs_err=float(d.max()), max_abs=float(want.abs().max()),
            within=bool((d <= SSD_TOL["atol"]
                         + SSD_TOL["rtol"] * want.abs()).all()))
    row = dict(shape=SSD_SHAPE, chunk=cfg.ssm.chunk, tol=SSD_TOL,
               chunked_ms=ms, stepwise_ms=step_ms, **errs)
    if not (errs["y"]["within"] and errs["h"]["within"]):
        raise AssertionError(f"ssd_chunked vs stepwise {row}")
    return row


def ssm_phase(cm, made, dev):
    """mamba2-370m whole: :func:`family_dense`, then a prompt of
    ``LONG_PROMPT`` tokens (three SSD chunks, the last partial) and the
    full-shape SSD check.  Returns the kernels' launches."""
    import torch
    from repro_torch.serving import engine
    eng, fields, launches = family_dense("ssm", cm, made, dev)
    cfg = eng.cfg
    long_eng = engine.Engine(cfg, eng.params,
                             engine.ServeConfig(max_len=LONG_PROMPT + GEN),
                             device=dev)
    long_prompt = family_prompt(cfg, BATCH, LONG_PROMPT, seed=1)
    torch.cuda.reset_peak_memory_stats()
    out, met = long_eng.generate(long_prompt, GEN, echo_metrics=True)
    if tuple(out.shape) != (BATCH, GEN):
        raise AssertionError(f"ssm long prompt tokens {tuple(out.shape)}")
    long = dict(prompt=LONG_PROMPT, ttft_s=met["ttft_s"],
                prefill_s=met["prefill_s"],
                decode_tok_per_s=met["decode_tok_per_s"],
                e2e_tok_per_s=met["e2e_tok_per_s"],
                decode_tok_per_s_vs_short=met["decode_tok_per_s"]
                / fields["decode_tok_per_s"],
                peak_bytes=torch.cuda.max_memory_allocated(dev))
    rows = fields["cache_bytes"] / (cfg.n_layers * BATCH)
    emit("ssm", **fields, cache_bytes_per_layer_row=rows, long=long,
         ssd=ssd_check(cfg, dev))
    return launches


def encdec_phase(cm, made, dev):
    """seamless-m4t-medium at full width, ``ENCDEC_DEPTH`` encoder and
    decoder layers: :func:`family_dense` on the batch of ``SRC_FRAMES``
    frames and the target prompt.  Returns the kernels' launches."""
    _, fields, launches = family_dense("encdec", cm, made, dev)
    emit("encdec", **fields)
    return launches


def families_phase(child, dev):
    """The ssm and encdec phases on the families child's containers."""
    import torch
    made = containers(*child)
    launches = {"ssm": ssm_phase(*made.pop("ssm"), dev)}
    torch.cuda.empty_cache()
    launches["encdec"] = encdec_phase(*made.pop("encdec"), dev)
    return launches


def reduced_reference_check(dev):
    """The reduced qwen2-moe-a2.7b (under ``SPEC``) and the reduced ssm,
    hybrid and encdec families (under ``FAMILY_SPEC``): the port on the
    card against the port on the CPU, from one container each: decoded
    weights identical, every router choice compared (one that differs must
    be a near-tie), prefill logits within ``REF_ATOL`` when every choice
    agrees; greedy token agreement reported."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.store import CompressedModel
    from repro_torch.serving import engine
    for family, arch in FAMILY_ARCHS.items():
        cfg = registry.reduced(registry.get(arch))
        host = family_host_weights(cfg, seed=1)
        cm = CompressedModel.compress(host, spec=parse_spec(
            FAMILY_SPEC[family] + REDUCED_SEGMENTS))
        quantized = sorted(set(carve_outs(host)) - set(cm.unquantized))
        if quantized:
            raise AssertionError(f"{family}: carve-outs quantized {quantized}")
        prompt = family_prompt(cfg, 2, 8, seed=1)
        runs = []
        for d, backend in ((dev, "cuda"), (torch.device("cpu"), "torch")):
            params = engine.load_params_from_compressed(cm, backend=backend,
                                                        device=d)
            eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=16),
                                device=d)
            with torch.inference_mode(), recorded_routes() as routes:
                logits, _ = eng.steps.prefill_fn(
                    params, engine.lockstep_batch(prompt, d))
            runs.append((params, logits.float().cpu(), routes,
                         eng.generate(prompt, 8).cpu()))
        (pc, lc, rc, tc), (pp, lp, rp, tp) = runs
        for name in pp:
            a, b = pc[name], pp[name]
            parts = zip(a, b) if isinstance(a, tuple) else [(a, b)]
            for x, y in parts:
                assert torch.equal(x.cpu(), y), name
        flips = route_flips(rc, rp)
        err = float((lc - lp).abs().max())
        emit("reference", arch=cfg.name, family=family, router_calls=len(rp),
             router_choices_compared=sum(r[1].shape[0] * r[1].shape[1]
                                         for r in rp),
             router_flips=flips, logits_max_abs_err=err, atol=REF_ATOL,
             logits_held=not flips,
             greedy_token_agreement=float((tc == tp).float().mean()),
             argmax_equal_first_token=bool((tc[:, 0] == tp[:, 0]).all()))
        if not all(f["near_tie"] for f in flips):
            raise AssertionError(f"{family} router choices differ beyond a "
                                 f"near-tie: {flips}")
        if not flips and not err <= REF_ATOL:
            raise AssertionError(f"{family} card vs CPU logits differ by "
                                 f"{err}")


# ------------------------------------------------------------------- train

class StepClock:
    """Train hook: the host time of each step, read after its metrics came
    back to the host (so each interval ends with the step's device work)."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def __call__(self, i, params, opt_state, metrics):
        self.t.append(time.perf_counter())

    def ms(self):
        return [1e3 * (b - a) for a, b in zip(self.t, self.t[1:])]


def train_config(**kw):
    from repro_torch.training import optimizer as opt, train_loop
    q8 = kw.pop("quantized_state", False)
    return train_loop.TrainConfig(opt=opt.AdamWConfig(
        schedule=opt.Schedule(**TRAIN_SCHEDULE), quantized_state=q8), **kw)


def train_source(cfg, **kw):
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    return SyntheticSource(DataConfig(vocab=cfg.vocab,
                                      **dict(TRAIN_DATA, **kw)))


def train_run(cfg, tc, dev, *, steps=None, params=None, state=None,
              start=0, hooks=()):
    """``steps`` steps of ``train_loop.train`` from seed-0 weights (or the
    given state) over ``TRAIN_DATA`` from batch ``start``; every loss and
    gradient norm must be finite.  Returns (params, state, losses, grad
    norms, step ms, steps/s)."""
    import math
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt, train_loop
    steps = TRAIN_STEPS if steps is None else steps
    if params is None:
        params = api.build(cfg).init(cfg, 0, dev)
    if state is None:
        state = opt.init_state(tc.opt, params)
    clock = StepClock()
    # handed over without a reference left here, so the first step's
    # inputs are freed once it returns (the JAX package donates them)
    held = [params, state]
    del params, state
    params, state, info = train_loop.train(
        cfg, tc, held.pop(0), held.pop(0),
        train_source(cfg).iter_from(start), steps,
        hooks=(clock,) + tuple(hooks))
    losses = [h["loss"] for h in info["history"]]
    norms = [h["grad_norm"] for h in info["history"]]
    if not all(math.isfinite(v) for v in losses + norms):
        raise AssertionError(f"{cfg.name}: non-finite loss or grad norm "
                             f"{losses} {norms}")
    return params, state, losses, norms, clock.ms(), info["steps_per_s"]


def assert_falls(what, losses, drop=TRAIN_DROP):
    if not losses[-1] < losses[0] - drop:
        raise AssertionError(f"train {what}: loss {losses[0]} -> "
                             f"{losses[-1]} did not fall by {drop}")


def profile_train_step(cfg, tc, params, state, dev):
    """One train step (on the run's final state, results dropped) timed
    without and with ``torch.profiler`` (:func:`device_profile`)."""
    import torch
    from repro_torch.training import train_loop
    step = train_loop.make_train_step(cfg, tc)
    batch = train_loop.to_device(train_source(cfg).batch(TRAIN_STEPS), dev)

    def steps(window):
        torch.cuda.synchronize()
        with window as prof:
            t0 = time.perf_counter()
            out = step(params, state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        del out
        return ms, prof

    return dict(device_profile(steps), steps=1)


def train_full(dev):
    """``full``: qwen3-1.7b whole, f32 moments; then ``q8``: the same run
    with EntroLLM-quantized moments.  Returns the full run's losses."""
    import math
    import statistics
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import dense
    from repro_torch.training import optimizer as opt
    cfg = registry.get(TRAIN_ARCH)
    B, S = TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"]
    tokens = B * (S - 1)
    out = {}
    for run, q8 in (("full", False), ("q8", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tc = train_config(quantized_state=q8)
        shapes = {k: math.prod(s.shape) for k, s in dense.schema(cfg).items()}
        n = sum(shapes.values())
        # the model-FLOP count's N: lm_head is a matmul a token, the
        # input embedding a row lookup
        nonemb = n - shapes["embed"]
        params, state, losses, norms, ms, sps = train_run(cfg, tc, dev)
        peak = torch.cuda.max_memory_allocated(dev)
        if int(state.step) != TRAIN_STEPS:
            raise AssertionError(f"train {run}: step {int(state.step)}")
        if run == "full":
            assert_falls(run, losses)
        steady = statistics.median(ms[1:])
        tok_s = tokens / (steady / 1e3)
        held = n * 2 + n * 2 + 2 * n * 4
        fields = dict(
            arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
            heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd], d_ff=cfg.d_ff,
            padded_vocab=cfg.padded_vocab(), params=n,
            non_embedding_params=nonemb, steps=TRAIN_STEPS,
            batch=[B, S], tokens_per_step=tokens, schedule=TRAIN_SCHEDULE,
            remat=tc.remat, quantized_state=q8, loss_first=losses[0],
            loss_last=losses[-1], losses=losses, grad_norms=norms,
            first_step_ms=ms[0], steady_step_ms=steady, step_ms=ms,
            steps_per_s_steady=1e3 / steady, steps_per_s_wall=sps,
            tokens_per_s=tok_s,
            mfu=6 * nonemb * tok_s / PEAK_BF16_FLOPS,
            mfu_formula=f"6 * {nonemb} * tokens_per_s / {PEAK_BF16_FLOPS:g}",
            peak_bytes=peak, moment_bytes=opt.moment_bytes(state),
            f32_moment_bytes=2 * n * 4,
            params_grads_f32_moments_bytes=held)
        if run == "full":
            fields["profile"] = profile_train_step(cfg, tc, params, state,
                                                   dev)
        else:
            # recorded, not asserted: at the published vocabulary the JAX
            # package's Q8 moments fail this criterion too (ROADMAP queue
            # 3; tests/test_torch_train_q8_vocab.py)
            fields.update(loss_last_full=out["full"][-1],
                          q8_vs_full_tol=TRAIN_Q8_TOL,
                          q8_within_tol=abs(losses[-1] - out["full"][-1])
                          < TRAIN_Q8_TOL)
        emit("train", run=run, **fields)
        out[run] = losses
        del params, state
    return out["full"]


def per_layer_select(params, prefix, n):
    """The layer views the forward took before ``stacked_layers``: one
    ``select`` of each stacked leaf a layer."""
    from repro_torch.models.layers import layer_slice
    pre = prefix + "/"
    return [{k[len(pre):]: layer_slice(v, l) for k, v in params.items()
             if k.startswith(pre)} for l in range(n)]


def train_unbind(dev):
    """``unbind``: ``UNBIND_STEPS`` steps of the ``full`` run with the
    forward's layer views taken by one ``torch.unbind`` a leaf (the port)
    and by one ``select`` a layer (before): steady step time and peak
    memory of each, and the losses (equal: the same values either way)."""
    import statistics
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import dense, layers
    cfg = registry.get(TRAIN_ARCH)
    fields = {}
    for variant, views in (("unbind", layers.stacked_layers),
                           ("select", per_layer_select)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dense.stacked_layers = views
        try:
            params, state, losses, _, ms, _ = train_run(
                cfg, train_config(), dev, steps=UNBIND_STEPS)
        finally:
            dense.stacked_layers = layers.stacked_layers
        fields[variant] = dict(
            steady_step_ms=statistics.median(ms[1:]), step_ms=ms,
            peak_bytes=torch.cuda.max_memory_allocated(dev), losses=losses)
        del params, state
    emit("train", run="unbind", arch=cfg.name, steps=UNBIND_STEPS, **fields)
    if fields["unbind"]["losses"] != fields["select"]["losses"]:
        raise AssertionError(f"train unbind: losses differ {fields}")


def train_microbatch(dev):
    """One step from the same weights and batch at 1 and 2 microbatches."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import dense
    from repro_torch.training import optimizer as opt, train_loop
    cfg = registry.get(TRAIN_ARCH)
    torch.cuda.empty_cache()
    params = dense.init(cfg, 0, dev)
    batch = train_loop.to_device(train_source(cfg).batch(0), dev)
    outs = {}
    for mb in (1, 2):
        tc = train_config(microbatches=mb)
        t0 = time.perf_counter()
        p2, _, m = train_loop.make_train_step(cfg, tc)(
            params, opt.init_state(tc.opt, params), batch)
        loss = float(m["loss"])
        outs[mb] = (p2, loss, (time.perf_counter() - t0) * 1e3)
    dloss = abs(outs[1][1] - outs[2][1])
    dparam = max(float((outs[1][0][k].float() - outs[2][0][k].float())
                       .abs().max()) for k in params)
    emit("train", run="microbatch", arch=cfg.name, loss_mb1=outs[1][1],
         loss_mb2=outs[2][1], loss_abs_diff=dloss, param_max_abs_diff=dparam,
         step_ms_mb1=outs[1][2], step_ms_mb2=outs[2][2],
         tol=TRAIN_MB_TOL)
    if not (dloss < TRAIN_MB_TOL["loss"] and dparam <= TRAIN_MB_TOL["atol"]):
        raise AssertionError(f"train microbatch: loss diff {dloss}, params "
                             f"{dparam}")


def train_variants(full_losses, dev):
    """``compress``: int8 gradient wire format; ``ste``: 8-bit quantized
    weights in the forward with straight-through gradients (both whole)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.distributed.grad_compress import wire_bytes
    cfg = registry.get(TRAIN_ARCH)
    for run, kw in (("compress", dict(grad_compress=True)),
                    ("ste", dict(q8_gather=8))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, state, losses, norms, ms, sps = train_run(
            cfg, train_config(**kw), dev)
        fields = dict(arch=cfg.name, n_layers=cfg.n_layers, **kw,
                      loss_first=losses[0], loss_last=losses[-1],
                      losses=losses, loss_last_full=full_losses[-1],
                      first_step_ms=ms[0], step_ms=ms, steps_per_s_wall=sps,
                      peak_bytes=torch.cuda.max_memory_allocated(dev))
        if run == "compress":
            fields.update(wire_bytes_compressed=wire_bytes(
                params, compressed=True),
                wire_bytes_raw=wire_bytes(params, compressed=False))
        else:
            fields["ste_vs_full_tol"] = TRAIN_STE_TOL
        emit("train", run=run, **fields)
        del params, state
        assert_falls(run, losses)
        if run == "ste" and not abs(losses[-1] - full_losses[-1]) \
                < TRAIN_STE_TOL:
            raise AssertionError(f"train ste: last loss {losses[-1]} vs "
                                 f"{full_losses[-1]}")


def nondeterministic_grads(cfg, tc, params, batch):
    """Names whose gradients differ between two runs of the same step on
    the same inputs."""
    import torch
    from repro_torch.training import train_loop
    grads = train_loop.make_grad_fn(cfg, tc)
    _, a = grads(params, batch)
    _, b = grads(params, batch)
    return sorted(n for n in a if not torch.equal(a[n], b[n]))


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_restart(dev):
    """``restart``: full width at ``DEPTH`` layers with Q8 moments: 10
    steps with an async checkpoint at step 5, then a "crash", a restore
    into fresh trees on the card and steps 5-9 again."""
    import dataclasses as dc
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.configs import registry
    from repro_torch.distributed.fault_tolerance import CheckpointHook
    from repro_torch.models import dense
    from repro_torch.training import optimizer as opt, train_loop
    cfg = dc.replace(registry.get(TRAIN_ARCH), n_layers=DEPTH)
    tc = train_config(quantized_state=True)
    root = os.path.join(ROOT, "build", "chip_smoke", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    try:
        ck = Checkpointer(CheckpointConfig(root=root))
        hook = CheckpointHook(ck, RESTART_AT)
        save_s = []

        def timed(i, p, s, m):
            t0 = time.perf_counter()
            hook(i, p, s, m)
            if (i + 1) % RESTART_AT == 0:
                save_s.append(time.perf_counter() - t0)

        params, state, want, _, _, _ = train_run(cfg, tc, dev,
                                                 steps=RESTART_STEPS,
                                                 hooks=(timed,))
        t0 = time.perf_counter()
        ck.wait()
        wait_s = time.perf_counter() - t0
        del params, state
        fresh = dense.init(cfg, 1, dev)
        like = (fresh, opt.init_state(tc.opt, fresh))
        t0 = time.perf_counter()
        step, (params, state) = ck.restore(RESTART_AT, like=like, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del like, fresh
        if step != RESTART_AT or int(state.step) != RESTART_AT:
            raise AssertionError(f"restored step {step} / {int(state.step)}")
        nondet = nondeterministic_grads(
            cfg, tc, params, train_loop.to_device(
                train_source(cfg).batch(RESTART_AT), dev))
        _, _, got, _, _, _ = train_run(cfg, tc, dev,
                                       steps=RESTART_STEPS - RESTART_AT,
                                       params=params, state=state,
                                       start=RESTART_AT)
        want = want[RESTART_AT:]
        diffs = [abs(a - b) for a, b in zip(got, want)]
        ckpt_bytes = dir_bytes(os.path.join(root, f"step_{RESTART_AT:09d}"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("train", run="restart", arch=cfg.name, n_layers=cfg.n_layers,
         quantized_state=True, checkpoint_at=RESTART_AT,
         checkpoint_bytes=ckpt_bytes, save_sync_s=save_s, wait_s=wait_s,
         restore_s=restore_s, resumed_losses=got, uninterrupted_losses=want,
         loss_abs_diffs=diffs, tol=RESTART_TOL,
         bitwise=sum(a == b for a, b in zip(got, want)), of=len(want),
         nondeterministic_grad_leaves=nondet,
         nondeterministic_op=(NONDETERMINISTIC_OPS.get(nondet[0], "unknown")
                              if nondet else None))
    if not max(diffs) <= RESTART_TOL:
        raise AssertionError(f"train restart: resumed losses differ by "
                             f"{diffs}")


def train_entro(dev):
    """``entro``: the reduced qwen3-1.7b, 3 steps, saved under
    ``ENTRO_SPEC`` (Huffman-8 parameters, rANS-8 moments), restored on the
    card through the decode kernels (launches equal to the restore plan's
    chunks), bitwise a CPU restore, then 3 more steps."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.configs import registry
    from repro_torch.core.store import CompressedModel
    from repro_torch.kernels import build
    cfg = registry.reduced(registry.get(TRAIN_ARCH))
    tc = train_config()
    root = os.path.join(ROOT, "build", "chip_smoke", "train_entro")
    shutil.rmtree(root, ignore_errors=True)
    try:
        params, state, _, _, _, _ = train_run(cfg, tc, dev, steps=ENTRO_STEPS)
        ck = Checkpointer(CheckpointConfig(root=root, compress="entro",
                                           entro_spec=ENTRO_SPEC))
        t0 = time.perf_counter()
        ck.save(ENTRO_STEPS, (params, state))
        save_s = time.perf_counter() - t0
        step_dir = os.path.join(root, f"step_{ENTRO_STEPS:09d}")
        cm = CompressedModel.load(os.path.join(step_dir,
                                               "shard_00000_entro.npz"))
        want = decode_launches_from_plan(cm, chunk_symbols=None,
                                         prefetch=False)
        like = (params, state)
        torch.cuda.synchronize()
        for k in build.launches:
            build.launches[k] = 0
        t0 = time.perf_counter()
        _, (p_card, s_card) = ck.restore(ENTRO_STEPS, like=like, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        launches = dict(build.launches)
        _, (p_cpu, s_cpu) = ck.restore(ENTRO_STEPS, like=like,
                                       device=torch.device("cpu"))
        nbytes = dir_bytes(step_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if 0 in want.values() or launches != dict({k: 0 for k in launches},
                                              **want):
        raise AssertionError(f"train entro: launches {launches}, expected "
                             f"the restore plan's {want}, each kernel once "
                             f"at least")
    from repro_torch.checkpoint.checkpointer import flatten_with_path
    n_leaves = 0
    for (path, a), (_, b) in zip(flatten_with_path((p_card, s_card)),
                                 flatten_with_path((p_cpu, s_cpu))):
        if a.device.type != dev.type or not torch.equal(a.cpu(), b):
            raise AssertionError(f"train entro: leaf {'/'.join(path)}")
        n_leaves += 1
    del p_cpu, s_cpu
    _, state, losses, _, _, _ = train_run(cfg, tc, dev, steps=ENTRO_STEPS,
                                          params=p_card, state=s_card,
                                          start=ENTRO_STEPS)
    st = cm.stats()
    emit("train", run="entro", arch=cfg.name, spec=ENTRO_SPEC,
         checkpoint_bytes=nbytes, effective_bits=st.effective_bits,
         quantized_params=st.quantized_params, save_s=save_s,
         restore_s=restore_s, launches=launches, launches_expected=want,
         leaves_bitwise_cpu_restore=n_leaves, resumed_losses=losses,
         step=int(state.step))
    return launches


def masked_loss(cfg, labels):
    """The family's loss with ``labels`` in place of the batch's shifted
    tokens (labels >= vocab are masked), written as its ``loss_fn`` is."""
    from repro_torch.models import api, dense
    from repro_torch.models.layers import softmax_xent
    mod = api.build(cfg)

    def loss(cfg, params, batch, *, remat, q_block):
        out = mod.forward(cfg, params, batch["tokens"][:, :-1], remat=remat)
        x = softmax_xent(dense.logits_fn(cfg, params, out[0]), labels,
                         cfg.vocab)
        return x + 0.01 * out[2] if len(out) == 3 else x
    return loss


def leaf_errors(got, want):
    """Worst per-leaf relative L2 and cosine of ``got`` against ``want``."""
    import torch
    worst_rel, worst_cos = (0.0, None), (1.0, None)
    for n in want:
        a, b = got[n].double().cpu(), want[n].double()
        nb = float(torch.linalg.vector_norm(b))
        rel = float(torch.linalg.vector_norm(a - b)) / max(nb, 1e-30)
        cos = float((a * b).sum()) / max(
            float(torch.linalg.vector_norm(a)) * nb, 1e-30)
        if rel > worst_rel[0]:
            worst_rel = (rel, n)
        if cos < worst_cos[0]:
            worst_cos = (cos, n)
    return worst_rel, worst_cos


def train_reference(dev):
    """``reference``: one train step of the reduced qwen3-1.7b and
    qwen2-moe-a2.7b (``capacity_factor`` 8.0) on the card and on the CPU
    from the same seeded weights and batch: loss, every gradient and every
    updated parameter within ``TRAIN_REF``; router choices compared, and a
    row's labels masked from a differing (near-tie) choice on."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.training import optimizer as opt, train_loop
    cpu = torch.device("cpu")
    for arch in (TRAIN_ARCH, MOE_ARCH):
        cfg = registry.reduced(registry.get(arch))
        if cfg.moe:
            cfg = dc.replace(cfg, moe=dc.replace(cfg.moe,
                                                 capacity_factor=8.0))
        host = family_host_weights(cfg, seed=1)
        batch = train_source(cfg, seq_len=17, global_batch=4,
                             seed=1).batch(0)
        tc = train_config(remat=False)

        def step(d, loss_fn=None):
            params = convert.params_from_numpy(cfg, host, d)
            with recorded_routes() as routes:
                loss, grads = train_loop.make_grad_fn(cfg, tc, loss_fn)(
                    params, train_loop.to_device(batch, d))
            new, _, _ = opt.apply_updates(tc.opt, params, grads,
                                          opt.init_state(tc.opt, params))
            return float(loss), grads, new, routes

        card, ref = step(dev), step(cpu)
        flips = route_flips(card[3], ref[3])
        if not all(f["near_tie"] for f in flips):
            raise AssertionError(f"train reference {arch}: router choices "
                                 f"differ beyond a near-tie: {flips}")
        if flips:
            labels = np.array(batch["tokens"][:, 1:])
            for f in flips:
                labels[f["row"], f["pos"]:] = cfg.vocab
            card, ref = (step(d, masked_loss(cfg, torch.as_tensor(
                labels, device=d))) for d in (dev, cpu))
        dloss = abs(card[0] - ref[0])
        (grel, gname), (gcos, cname) = leaf_errors(card[1], ref[1])
        (prel, pname), _ = leaf_errors(card[2], ref[2])
        emit("train", run="reference", arch=cfg.name, loss_card=card[0],
             loss_cpu=ref[0], loss_abs_diff=dloss,
             grad_worst_rel_l2=[grel, gname], grad_worst_cos=[gcos, cname],
             param_worst_rel_l2=[prel, pname], router_flips=flips,
             labels_masked_from_flips=bool(flips), tol=TRAIN_REF)
        if not (dloss <= TRAIN_REF["loss"] and grel <= TRAIN_REF["rel_l2"]
                and gcos >= TRAIN_REF["cos"]
                and prel <= TRAIN_REF["rel_l2"]):
            raise AssertionError(f"train reference {arch}: loss {dloss}, "
                                 f"grads {grel} / {gcos}, params {prel}")


def train_phase(dev):
    """Every ``train`` run in order; returns the decode kernels' launches
    of the entro restore."""
    import torch
    full_losses = train_full(dev)
    train_unbind(dev)
    train_microbatch(dev)
    train_variants(full_losses, dev)
    train_restart(dev)
    torch.cuda.empty_cache()
    launches = train_entro(dev)
    train_reference(dev)
    return launches

# ------------------------------------------------------------------ mesh

def mesh_container(arch):
    """Where a container the mesh phase's ranks load waits for them."""
    path = os.path.join(ROOT, "build", "chip_smoke", "mesh", f"{arch}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def expected_rank_bytes(cfg, params, mesh_shape):
    """The weight bytes one rank holds by the resolved exact-TP specs: each
    part of each tensor, divided by the ranks along its sharded axes."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    from repro_torch.models.layers import QT, QT4

    class Shape:
        shape = mesh_shape
    axes = api.param_specs(cfg)
    total = 0
    for name, v in params.items():
        spec = shd.leaf_shardings(axes[name], v,
                                  shd.serve_tp_table(cfg, Shape, axes[name]),
                                  Shape)
        pairs = zip(v, spec) if isinstance(v, (QT, QT4)) else [(v, spec)]
        for t, sp in pairs:
            n = t.numel() * t.element_size()
            for e in sp:
                n //= shd.mesh_prod(Shape, shd.entry_axes(e))
            total += n
    return total


def mesh_rank_setup(mesh, path):
    """A rank's start: the card (never the CPU), the container, the launch
    and collective counts zeroed."""
    import torch
    from repro_torch.core.store import CompressedModel
    from repro_torch.distributed import collectives
    from repro_torch.kernels import build
    if mesh.device.type != "cuda":
        raise AssertionError(f"rank {mesh.rank} on {mesh.device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cm = CompressedModel.load(path)
    for k in build.launches:
        build.launches[k] = 0
    collectives.reset_counts()
    return cm


def mesh_load(cfg, cm, mesh):
    """The load through the ``cuda`` decode backend with the mesh's placer;
    the decode launches must equal the load plan's."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.serving import engine
    load = {}
    params = engine.load_params_from_compressed(
        cm, backend="cuda", device=mesh.device, metrics=load,
        placer=engine.make_param_placer(cfg, mesh))
    torch.cuda.synchronize()
    launches = dict(build.launches)
    want = decode_launches_from_plan(cm)
    if launches != dict({k: 0 for k in launches}, **want):
        raise AssertionError(f"rank {mesh.rank}: load launches {launches}, "
                             f"the plan's {want}")
    return params, launches, load["decode_load_s"]


def mesh_dense_rank(mesh, cfg, path, prompt, jobs):
    """One rank of the qwen3 mesh: load, lockstep (a warm call, then the
    serve phase's generate), ``jobs`` through a 4-slot continuous engine."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.serving import engine
    from repro_torch.serving.batching import ContinuousEngine
    t_start = time.perf_counter()
    cm = mesh_rank_setup(mesh, path)
    params, launches, load_s = mesh_load(cfg, cm, mesh)
    weight_bytes = engine.per_device_bytes(params, mesh)
    eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=PROMPT + GEN),
                        mesh=mesh)
    eng.generate(prompt, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, GEN)
    torch.cuda.synchronize()
    lockstep_s = time.perf_counter() - t0
    ce = ContinuousEngine(cfg, params,
                          engine.ServeConfig(max_len=CONT_MAX_LEN),
                          n_slots=FLEET_SLOTS, prefill_chunk=PREFILL_CHUNK,
                          max_queue=MAX_QUEUE, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = run_single(ce, jobs)
    torch.cuda.synchronize()
    continuous_s = time.perf_counter() - t0
    if mesh.rank == 0:
        os.remove(path)
    return dict(coord=mesh.key(), device=str(mesh.device),
                launches=launches, load_s=load_s, weight_bytes=weight_bytes,
                cache_bytes=eng.cache_bytes,
                slot_cache_bytes=engine.local_bytes(ce.slots.cache),
                slot_rows=[ce.slots.rows.start, ce.slots.rows.stop],
                tokens=out.cpu().tolist(), lockstep_s=lockstep_s,
                outs=outs, continuous_s=continuous_s,
                decode_steps=ce.n_decode_steps,
                prefill_chunks=ce.n_prefill_chunks,
                collectives=dict(collectives.counts),
                peak_bytes=torch.cuda.max_memory_allocated(mesh.device),
                wall_s=time.perf_counter() - t_start)


def mesh_moe_rank(mesh, cfg, path, prompt):
    """One rank of the moe mesh: load, exact-TP lockstep, then layer 0's
    feed-forward through expert parallelism against the single-device
    forward on the same rank."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import (ShardingHints, local_block,
                                             set_hints)
    from repro_torch.models import moe
    from repro_torch.models.layers import (deq, gather_weight, layer_slice,
                                           rms_norm, take_rows)
    from repro_torch.serving import engine
    t_start = time.perf_counter()
    cm = mesh_rank_setup(mesh, path)
    params, launches, load_s = mesh_load(cfg, cm, mesh)
    weight_bytes = engine.per_device_bytes(params, mesh)
    eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=PROMPT + GEN),
                        mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, GEN)
    torch.cuda.synchronize()
    lockstep_s = time.perf_counter() - t0
    collective_counts = dict(collectives.counts)

    # EP: layer 0's moe weights gathered once (pure data movement) and
    # dequantized as the model does (bf16); x the prompt's normed
    # embeddings; every rank runs the single-device forward too
    hints = ShardingHints(mesh=mesh, model_axis=None, batch_axes=(),
                          seq_sp=False, exact_tp=True)
    with torch.inference_mode():
        set_hints(hints)
        try:
            wts = {k[len("layers/moe/"):]: deq(gather_weight(
                layer_slice(v, 0))) for k, v in params.items()
                if k.startswith("layers/moe/")}
            x = take_rows(params["embed"], torch.as_tensor(
                prompt, device=mesh.device))
        finally:
            set_hints(None)
        x = rms_norm(x, layer_slice(params["layers/mlp_norm"], 0))
        E = cfg.moe.padded_experts(16)
        y_single, _ = moe.moe_mlp(x, wts, cfg.moe, E)
        ctx = moe.EPContext(mesh, batch_sharded=True)
        local = dict(wts)
        for k, spec in moe.ep_weight_specs(ctx).items():
            local[k] = local_block(wts[k], spec, mesh).contiguous()
        moe.set_ep_context(ctx)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_ep, _ = moe.moe_mlp(x, local, cfg.moe, E)
            torch.cuda.synchronize()
            ep_s = time.perf_counter() - t0
        finally:
            moe.set_ep_context(None)
        err = float((y_ep.float() - y_single.float()).abs().max())
        scale = float(y_single.float().abs().max())
    if mesh.rank == 0:
        os.remove(path)
    return dict(coord=mesh.key(), device=str(mesh.device),
                launches=launches, load_s=load_s, weight_bytes=weight_bytes,
                cache_bytes=eng.cache_bytes, tokens=out.cpu().tolist(),
                lockstep_s=lockstep_s, collectives=collective_counts,
                ep_max_abs_err=err, ep_max_abs_y=scale, ep_s=ep_s,
                ep_experts_local=E // mesh.shape["model"],
                peak_bytes=torch.cuda.max_memory_allocated(mesh.device),
                wall_s=time.perf_counter() - t_start)


def mesh_spawn(fn, shape, args):
    """``fn`` on every rank of a fresh ``shape`` world sharing the card;
    any failed or hung rank raises.  Returns (ranks' results, wall)."""
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    got = mesh_lib.spawn(fn, *shape, backend=MESH_BACKEND, device="cuda",
                         timeout_s=MESH_TIMEOUT_S, args=args, threads=0)
    return got, time.perf_counter() - t0


def mesh_line(label, shape, got, wall, tokens, seconds, **fields):
    """Emit a ``mesh`` line: what every rank reported, side by side."""
    emit("mesh", run=label, mesh=list(shape), ranks=len(got),
         backend=MESH_BACKEND,
         shared_card="every rank on cuda:0: the times are one card's "
                     "shared by the ranks, not a multi-card figure; the "
                     "port hands gloo card tensors, and gloo copies them "
                     "through host memory inside each collective",
         devices=sorted({r["device"] for r in got}),
         collectives=[r["collectives"] for r in got],
         weight_bytes_per_rank=[r["weight_bytes"][tuple(r["coord"])]
                                for r in got],
         cache_bytes_per_rank=[r["cache_bytes"] for r in got],
         load_s=[r["load_s"] for r in got], tokens=tokens,
         tok_per_s=tokens / max(seconds, 1e-9), seconds=seconds,
         wall_s=wall, rank_wall_s=[r["wall_s"] for r in got],
         peak_bytes=[r["peak_bytes"] for r in got],
         launches=[r["launches"] for r in got], **fields)


def mesh_phase(cm, params, dense_tokens, want_slots, dev):
    """The serve phase's container on ``MESH`` ranks sharing the card:
    every rank's load launches the decode kernels as the plan says, holds
    less than one device's weight bytes (exactly its resolved shards), and
    its lockstep tokens and every continuous request are bitwise the
    single engine's.  The moe container's ``MESH_MOE`` world runs beside
    it (its ranks are held to the moe phase's tokens there,
    :func:`mesh_moe_phase`).  Returns (rank 0's launches, the moe world's
    (ranks' results, wall))."""
    import concurrent.futures as cf
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.serving import engine
    cfg = dataclasses.replace(registry.get("qwen3-1.7b"), n_layers=DEPTH)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (BATCH, PROMPT))
    _, jobs = fleet_jobs(cfg)
    _, moe_cfg = family_config("moe")
    with cf.ThreadPoolExecutor(2) as pool:
        moe_world = pool.submit(
            mesh_spawn, mesh_moe_rank, MESH_MOE,
            (moe_cfg, mesh_container(MOE_ARCH), moe_prompt(moe_cfg)))
        got, wall = mesh_spawn(mesh_dense_rank, MESH,
                               (cfg, mesh_container("qwen3-1.7b"), prompt,
                                jobs))
        moe_world = moe_world.result()
    from repro_torch.serving.kvcache import kv_cache_bytes
    single = engine.local_bytes(params)
    per_rank = expected_rank_bytes(cfg, params, dict(zip(("data", "model"),
                                                         MESH)))
    # rows over data, KV heads (8) over model: a rank holds 1 / (D x M)
    cache = kv_cache_bytes(cfg, BATCH, PROMPT + GEN) // (MESH[0] * MESH[1])
    slot_cache = kv_cache_bytes(cfg, FLEET_SLOTS, CONT_MAX_LEN) \
        // (MESH[0] * MESH[1])
    want_tokens = dense_tokens.tolist()
    for r in got:
        wb = r["weight_bytes"]
        if len(wb) != len(got) or set(wb.values()) != {per_rank} \
                or not per_rank < single:
            raise AssertionError(f"mesh weight bytes {wb}: expected "
                                 f"{per_rank} a rank, below {single}")
        if (r["cache_bytes"], r["slot_cache_bytes"]) != (cache, slot_cache):
            raise AssertionError(
                f"mesh rank {r['coord']}: cache bytes {r['cache_bytes']} / "
                f"{r['slot_cache_bytes']}, expected {cache} / {slot_cache}")
        if r["tokens"] != want_tokens:
            raise AssertionError(f"mesh rank {r['coord']}: lockstep tokens "
                                 f"differ from the serve phase's")
        if r["outs"] != want_slots:
            n = sum(a != b for a, b in zip(r["outs"], want_slots))
            raise AssertionError(f"mesh rank {r['coord']}: {n} continuous "
                                 f"requests differ from the single engine")
    r0 = got[0]
    toks = BATCH * GEN
    mesh_line("lockstep", MESH, got, wall, toks, r0["lockstep_s"],
              arch=cfg.name, single_device_weight_bytes=single,
              expected_weight_bytes_per_rank=per_rank,
              expected_cache_bytes_per_rank=cache,
              plan=decode_launches_from_plan(cm),
              tokens_equal_serve_phase=True)
    toks = sum(len(o) for o in want_slots)
    mesh_line("continuous", MESH, got, wall, toks, r0["continuous_s"],
              arch=cfg.name, n_slots=FLEET_SLOTS,
              slot_rows=[r["slot_rows"] for r in got],
              slot_cache_bytes_per_rank=[r["slot_cache_bytes"] for r in got],
              expected_slot_cache_bytes_per_rank=slot_cache,
              decode_steps=r0["decode_steps"],
              prefill_chunks=r0["prefill_chunks"],
              requests_equal_single=len(want_slots))
    return r0["launches"], moe_world


def mesh_moe_phase(cfg, prompt, tokens, world):
    """The moe phase's container on ``MESH_MOE`` (``world``: the ranks'
    results and wall, :func:`mesh_phase` ran them on ``prompt``): exact-TP
    lockstep bitwise the moe phase's tokens, and EP's layer-0 forward
    within ``EP_TOL``.  Returns rank 0's launches."""
    from repro_torch.serving.kvcache import kv_cache_bytes
    got, wall = world
    want = tokens.tolist()
    # the KV heads (16) over model: a rank holds 1 / M of the cache
    cache = kv_cache_bytes(cfg, BATCH, PROMPT + GEN) // MESH_MOE[1]
    for r in got:
        if r["tokens"] != want:
            raise AssertionError(f"mesh moe rank {r['coord']}: exact-TP "
                                 f"tokens differ from the moe phase's")
        if r["cache_bytes"] != cache:
            raise AssertionError(f"mesh moe rank {r['coord']}: cache bytes "
                                 f"{r['cache_bytes']}, expected {cache}")
        if not r["ep_max_abs_err"] <= EP_TOL * r["ep_max_abs_y"]:
            raise AssertionError(f"mesh moe rank {r['coord']}: EP max |diff| "
                                 f"{r['ep_max_abs_err']} over "
                                 f"{EP_TOL} x {r['ep_max_abs_y']}")
    mesh_line("moe", MESH_MOE, got, wall, BATCH * GEN, got[0]["lockstep_s"],
              arch=cfg.name, tokens_equal_moe_phase=True,
              expected_cache_bytes_per_rank=cache,
              ep=dict(tol=EP_TOL, layer=0,
                      experts_per_rank=got[0]["ep_experts_local"],
                      max_abs_err=[r["ep_max_abs_err"] for r in got],
                      max_abs_y=[r["ep_max_abs_y"] for r in got],
                      seconds=[r["ep_s"] for r in got]))
    return got[0]["launches"]


# ------------------------------------------------------------- production

def production_cells():
    """Every applicable (arch, shape) of ``PROD_ARCHS``, as ``all_cells``
    lists them."""
    from repro_torch.configs import registry
    from repro_torch.launch import specs
    return [(a, s) for a, s, ok in specs.all_cells(
        {a: registry.get(a) for a in PROD_ARCHS}) if ok]


def dryrun_cell(cell):
    """One cell's dry-run on the 16 x 16 mesh (a pool worker's task)."""
    from repro_torch.launch import dryrun
    return dryrun.run_cell(*cell, verbose=False)


def production_card(dev):
    """(b): each ``PROD_CARD`` cell dry-run and run on the card; the
    predicted peak within ``PROD_PEAK_RTOL`` of the measured one."""
    import torch
    from repro_torch.launch import dryrun
    for shape, batch in PROD_CARD:
        torch.cuda.empty_cache()
        steps = 1 if shape.startswith("prefill") else PROD_DECODE_STEPS
        d = dryrun.run_on_device("qwen3-1.7b", shape, device=dev,
                                 batch=batch, steps=steps)
        pred, got = d["memory_analysis"]["peak"], d["measured_peak"]
        emit("production", run="card", arch=d["arch"], shape=shape,
             mesh=d["mesh"], rows=batch, q_block=d["meta"].get("q_block"),
             step_ms=[t * 1e3 for t in d["measured_step_s"]],
             predicted_step_ms=d["step_s"] * 1e3, dominant=d["dominant"],
             compute_ms=d["compute_s"] * 1e3, memory_ms=d["memory_s"] * 1e3,
             collective_ms=d["collective_s"] * 1e3,
             flops=d["flops_per_chip"], flops_ratio=d["flops_ratio"],
             argument_bytes=d["memory_analysis"]["argument_size"],
             predicted_peak_bytes=pred, max_memory_allocated=got,
             peak_rel_err=(pred - got) / got, peak_rtol=PROD_PEAK_RTOL,
             logits_shape=list(d["logits_shape"]),
             logits_finite=d["logits_finite"])
        if not d["logits_finite"]:
            raise AssertionError(f"production {shape}: logits not finite")
        if abs(pred - got) > PROD_PEAK_RTOL * got:
            raise AssertionError(f"production {shape}: predicted peak {pred} "
                                 f"against {got} measured")


def production_train_rank(mesh, cfg, tokens):
    """(c), one rank: ``PROD_TRAIN["steps"]`` steps of the mesh train step
    from seeded params; rank 0 then runs the single-device steps on the card
    from the same params and compares (the update's relative L2 a leaf)."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt, train_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    dev = mesh.device
    params = api.build(cfg).init(cfg, 0, dev)
    tc = train_loop.TrainConfig(opt=opt.AdamWConfig(schedule=opt.Schedule(
        base_lr=1e-3, warmup_steps=1, total_steps=4)))
    batches = [{"tokens": torch.as_tensor(t, device=dev)} for t in tokens]
    collectives.reset_counts()
    step = train_loop.make_train_step(cfg, tc, mesh)
    placed, state = train_loop.shard_train_state(cfg, tc, params, mesh)
    out = dict(coord=mesh.key(), losses=[], grad_norms=[], step_s=[])
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, state, m = step(placed, state, train_loop.shard_batch(b,
                                                                     mesh))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["collectives"] = dict(collectives.counts)
    got = train_loop.gather_params(placed, mesh)
    del placed, state
    if mesh.rank == 0:
        ref = train_loop.make_train_step(cfg, tc)
        p, s = params, opt.init_state(tc.opt, params)
        out["single_losses"], out["single_grad_norms"] = [], []
        for b in batches:
            p, s, m = ref(p, s, b)
            out["single_losses"].append(float(m["loss"]))
            out["single_grad_norms"].append(float(m["grad_norm"]))
        out["update_rel_l2"] = max(
            float(torch.linalg.vector_norm((got[n] - p[n]).float())
                  / torch.linalg.vector_norm((p[n] - params[n]).float()))
            for n in p)
        del p, s
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def production_train():
    """(c): the mesh train line, asserted within ``PROD_TRAIN_TOL`` of the
    single-device steps."""
    import numpy as np
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get("qwen3-1.7b"),
                              n_layers=PROD_TRAIN["layers"])
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, cfg.vocab, (PROD_TRAIN["batch"],
                                          PROD_TRAIN["seq_len"] + 1))
              for _ in range(PROD_TRAIN["steps"])]
    got, wall = mesh_spawn(production_train_rank, PROD_TRAIN_MESH,
                           (cfg, tokens))
    r0 = got[0]
    tol = PROD_TRAIN_TOL
    for r in got:
        for k, want in (("losses", "single_losses"),
                        ("grad_norms", "single_grad_norms")):
            lim = tol["loss" if k == "losses" else "grad_norm"]
            for a, b in zip(r[k], r0[want]):
                if abs(a - b) > lim * abs(b):
                    raise AssertionError(f"mesh train rank {r['coord']}: "
                                         f"{k} {r[k]}, one device {r0[want]}")
    if not r0["update_rel_l2"] <= tol["update"]:
        raise AssertionError(f"mesh train: update rel L2 "
                             f"{r0['update_rel_l2']} over {tol['update']}")
    emit("mesh", run="train", mesh=list(PROD_TRAIN_MESH), ranks=len(got),
         backend=MESH_BACKEND, arch=cfg.name, layers=cfg.n_layers,
         batch=PROD_TRAIN["batch"], seq_len=PROD_TRAIN["seq_len"],
         shared_card="every rank on cuda:0 over gloo: not a multi-card "
                     "figure",
         losses=[r["losses"] for r in got], grad_norms=r0["grad_norms"],
         single_losses=r0["single_losses"],
         single_grad_norms=r0["single_grad_norms"],
         update_rel_l2=r0["update_rel_l2"], tol=tol,
         step_s=[r["step_s"] for r in got],
         collectives=[r["collectives"] for r in got],
         peak_bytes=[r["peak_bytes"] for r in got], wall_s=wall,
         rank_wall_s=[r["wall_s"] for r in got])


def start_dryruns():
    """Phase 11 (a), started ahead of its phase: every production cell's
    dry-run in a pool of ``PROD_WORKERS`` host processes, which run beside
    the card's phases.  Returns (pool, [(cell, future)])."""
    import concurrent.futures as cf
    import multiprocessing as mp
    pool = cf.ProcessPoolExecutor(PROD_WORKERS,
                                  mp_context=mp.get_context("spawn"))
    return pool, [(c, pool.submit(dryrun_cell, c)) for c in production_cells()]


def stop_dryruns(pool):
    """Stop a :func:`start_dryruns` pool, its running cells too."""
    for p in list((pool._processes or {}).values()):
        if p.is_alive():
            p.kill()
    pool.shutdown(wait=True, cancel_futures=True)


def production_phase(dev, dryruns):
    """Phase 11: (b) and (c) on the card, then (a)'s results from the
    ``dryruns`` pool (:func:`start_dryruns`).  Returns the kernels'
    launches on the path (all 0)."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    pool, futs = dryruns
    for k in build.launches:
        build.launches[k] = 0
    production_card(dev)
    production_train()
    launches = dict(build.launches)
    cells = [(c, f.result(timeout=PROD_DRYRUN_TIMEOUT_S)) for c, f in futs]
    pool.shutdown(wait=True)
    for (arch, shape), d in cells:
        ma = d["memory_analysis"]
        emit("production", run="dryrun", arch=arch, shape=shape,
             mesh=d["mesh"], kind=d["kind"], args_bytes=ma["argument_size"],
             peak_bytes=ma["peak"], fits=d["fits"],
             compute_ms=d["compute_s"] * 1e3, memory_ms=d["memory_s"] * 1e3,
             collective_ms=d["collective_s"] * 1e3, dominant=d["dominant"],
             flops_ratio=d["flops_ratio"], step_ms=d["step_s"] * 1e3,
             collective_counts=d["collective_detail"]["counts"],
             kv_seq_reference=d["meta"].get("kv_seq_reference"),
             kv_port=d["meta"].get("kv_port"), host_s=d["run_s"])
    if any(launches.values()):
        raise AssertionError(f"the production path launched kernels: "
                             f"{launches}")
    emit("production", run="phase", seconds=time.perf_counter() - t0,
         cells=len(cells))
    return launches


def sharded_config(arch):
    """``arch`` at full width cut to ``DEPTH`` layers (the encdec to
    ``ENCDEC_DEPTH`` encoder and decoder layers, the hybrid to one period
    with ``SHARDED_HYBRID_CUT``).  A routed config admits every choice
    (``capacity_factor`` = E / top_k): the sharded dispatch sizes the
    capacity by each data rank's rows and one device by the whole batch's,
    which drop alike only while nothing is dropped."""
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(
            cfg, n_layers=cfg.attn_period,
            moe=dataclasses.replace(cfg.moe, **SHARDED_HYBRID_CUT))
    elif cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_layers=ENCDEC_DEPTH,
                                  enc_layers=ENCDEC_DEPTH)
    else:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH)
    if cfg.moe:
        cf = float(cfg.moe.padded_experts(16) // cfg.moe.top_k)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def sharded_cut(arch):
    """What the sharded case of ``arch`` cut from the published config."""
    cfg = sharded_config(arch)
    cut = {"n_layers": cfg.n_layers}
    if cfg.family == "encdec":
        cut["enc_layers"] = cfg.enc_layers
    if cfg.family == "hybrid":
        cut.update(SHARDED_HYBRID_CUT, moe_ffns=cfg.n_layers
                   // cfg.moe.every_n, experts=cfg.moe.padded_experts(16))
    if cfg.moe:
        cut["capacity_factor"] = cfg.moe.capacity_factor
    return cut


# a tensor of more elements than SHARDED_DRAW_WHOLE is drawn in chunks of
# SHARDED_DRAW_CHUNK: its float32 draw would otherwise double the card's
# transient on every rank at once (jamba's expert stacks: 3.2 G elements)
SHARDED_DRAW_WHOLE = 1 << 30
SHARDED_DRAW_CHUNK = 1 << 28


def sharded_weights(cfg, dev):
    """``cfg``'s weights from ``SHARDED_SEED``, one (name, tensor) at a
    time in sorted name order: ``mod.init``'s draws (one generator on
    ``dev``) where a tensor has at most ``SHARDED_DRAW_WHOLE`` elements,
    else drawn a chunk at a time (so the single device and every rank,
    which all draw this way, hold the same weights)."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.layers import init_param
    gen = torch.Generator(device=dev)
    gen.manual_seed(SHARDED_SEED)
    schema = api.build(cfg).schema(cfg)
    for name in sorted(schema):
        spec = schema[name]
        n = 1
        for d in spec.shape:
            n *= d
        if n <= SHARDED_DRAW_WHOLE or not isinstance(spec.init, float):
            yield name, init_param(gen, spec, dev)
            continue
        out = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
        flat = out.view(-1)
        for i in range(0, n, SHARDED_DRAW_CHUNK):
            m = min(SHARDED_DRAW_CHUNK, n - i)
            flat[i:i + m] = (spec.init * torch.randn(
                m, generator=gen, dtype=torch.float32, device=dev)
            ).to(spec.dtype)
        yield name, out


def sharded_inputs(cfg):
    """The case's prompt (BATCH x PROMPT tokens from ``SHARDED_SEED``) and,
    for the encdec, PROMPT source frames (normal, drawn after them)."""
    import numpy as np
    rng = np.random.default_rng(SHARDED_SEED)
    prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT))
    src = rng.normal(0, 1, (BATCH, PROMPT, cfg.d_model)).astype(
        np.float32) if cfg.family == "encdec" else None
    return prompt, src


def _sharded_prompt(prompt, src, rows, dev):
    import torch
    toks = rows(torch.as_tensor(prompt, dtype=torch.int64, device=dev))
    if src is None:
        return toks
    return {"tokens": toks, "src_embeds": rows(
        torch.as_tensor(src, device=dev).to(torch.bfloat16))}


def sharded_rank_check(mesh):
    """A sharded rank computes on the card, never the CPU."""
    if mesh.device.type != "cuda":
        raise AssertionError(f"rank {mesh.rank} on {mesh.device}")


def sharded_rank(mesh, arch, mode, prompt, fed, routes=()):
    """One rank of a sharded case: the weights made from ``SHARDED_SEED``
    on the card one tensor at a time (:func:`sharded_weights`, as the
    single device makes them), each cut into this rank's blocks by the
    cells' specs (the decode cell's own placement only where its specs
    differ), then the prefill cell on ``prompt`` and ``GEN`` steps of the
    decode cell fed the single device's greedy tokens ``fed`` and, in a
    routed config, its router choices ``routes`` (:func:`replayed_routes`),
    so that every step of every row is compared.  Rank 0 returns every
    step's logits; every rank the argmax of each step, a fingerprint of
    its logits, its bytes, counts and times, and its router calls' largest
    probability difference and own-choice differences."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import collectives
    from repro_torch.kernels import build
    from repro_torch.launch import specs
    from repro_torch.serving import engine
    t_start = time.perf_counter()
    sharded_rank_check(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = sharded_config(arch)
    B, P = prompt.shape
    T = P + GEN
    pcell = specs.build_prefill_cell(
        cfg, ShapeConfig("prefill_32k", P, B, "prefill"), mesh,
        weights="bf16", max_len=T)
    dcell = specs.build_decode_cell(
        cfg, ShapeConfig("decode_32k", T, B, "decode"), mesh,
        weights="bf16", serve_mode=mode)
    shared = pcell.param_specs == dcell.param_specs
    torch.cuda.reset_peak_memory_stats(mesh.device)
    pp, dp = {}, {}
    for name, t in sharded_weights(cfg, mesh.device):
        pp.update(pcell.place({name: t}))
        if not shared:
            dp.update(dcell.place({name: t}))
        del t
    if shared:
        dp = pp
    torch.cuda.empty_cache()
    for k in build.launches:
        build.launches[k] = 0
    collectives.reset_counts()
    _, src = sharded_inputs(cfg)

    def whole(logits, cell):
        if cell.row_axes:
            logits = collectives.all_gather(mesh, logits, 0, cell.row_axes)
        return logits[:, -1].float()

    logits_out, toks, prints = [], [], []
    rows = [pcell.local_rows]
    with torch.inference_mode(), replayed_routes(routes, rows) as seen:
        first = _sharded_prompt(prompt, src, pcell.local_rows, mesh.device)
        fed = torch.as_tensor(fed, dtype=torch.int64, device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = pcell.fn(pp, first)
        lg = whole(lg, pcell)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rows[0] = dcell.local_rows
        t0 = time.perf_counter()
        for i in range(GEN + 1):
            toks.append(torch.argmax(lg, dim=-1)[:, None])
            prints.append(float(lg.double().sum()))
            if mesh.rank == 0:
                logits_out.append(lg.cpu().numpy())
            if i == GEN:
                break
            lg, cache = dcell.fn(dp, dcell.local_rows(fed[:, i:i + 1]),
                                 cache, P + i)
            lg = whole(lg, dcell)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    return dict(coord=mesh.key(), device=str(mesh.device),
                logits=logits_out, prints=prints,
                tokens=torch.cat(toks, 1).cpu().numpy(),
                prefill_s=prefill_s, decode_s=decode_s,
                collectives=dict(collectives.counts),
                launches=dict(build.launches),
                weight_bytes=engine.local_bytes(dp),
                cache_bytes=engine.local_bytes(cache),
                cache_shape={k: list(v.shape) for k, v in cache.items()},
                peak_bytes=torch.cuda.max_memory_allocated(mesh.device),
                wall_s=time.perf_counter() - t_start,
                routes=seen, rows=np.int64(B))


def sharded_single(arch, prompt, dev):
    """The single device's greedy run of the same weights: its tokens and
    each step's logits, and its weight and cache bytes."""
    import torch
    from repro_torch.models import api
    from repro_torch.serving import engine
    cfg = sharded_config(arch)
    mod = api.build(cfg)
    P = prompt.shape[1]
    params = dict(sharded_weights(cfg, dev))
    _, src = sharded_inputs(cfg)
    logits, toks = [], []
    with torch.inference_mode(), recording_routes() as routes:
        lg, cache = mod.prefill(cfg, params, _sharded_prompt(
            prompt, src, lambda t: t, dev), max_len=P + GEN)
        for i in range(GEN + 1):
            last = lg[:, -1].float()
            logits.append(last.cpu().numpy())
            toks.append(torch.argmax(last, dim=-1)[:, None])
            if i < GEN:
                lg, cache = mod.decode_step(cfg, params, toks[-1], cache,
                                            P + i)
    out = dict(logits=logits, tokens=torch.cat(toks, 1).cpu().numpy(),
               weight_bytes=engine.local_bytes(params),
               cache_bytes=engine.local_bytes(cache), routes=routes)
    del params, cache
    torch.cuda.empty_cache()
    return out


def bf16_step(x):
    """The spacing of bf16 numbers at ``|x|``."""
    import math
    return 2.0 ** (math.frexp(abs(x))[1] - 8)


@contextlib.contextmanager
def recording_routes():
    """Record every MoE router call inside the block: a list of (float32
    probabilities, top-k indices) numpy pairs, in call order."""
    from repro_torch.models import moe
    real, calls = moe.route, []

    def route(x, router, K):
        probs, gates, idx = real(x, router, K)
        calls.append((probs.detach().float().cpu().numpy(),
                      idx.cpu().numpy()))
        return probs, gates, idx
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


@contextlib.contextmanager
def replayed_routes(routes, rows):
    """Feed one device's router choices ``routes`` (its calls' (float32
    probabilities, top-k indices), whole batch) to the sharded run, call by
    call, as its greedy tokens are fed: each call routes this rank's rows
    (``rows[0]``, the current cell's ``local_rows``) to one device's
    experts, with gates from the call's own probabilities over them,
    renormalised as ``moe.route`` does.  The sharded layout rounds the
    router's input otherwise than one device, and at full width that moves
    a probability by up to a few hundredths (jamba on an H100: 0.036):
    enough to flip an expert that is no near-tie, which moves that token
    by far more than rounding.  Yields a list, a call each, of (the largest
    |probability difference| against one device's, the tokens whose own
    top-k differs from the one fed)."""
    import torch
    from repro_torch.models import moe
    real, seen = moe.route, []

    def route(x, router, K):
        probs, _, idx = real(x, router, K)
        want_p, want_i = (rows[0](torch.as_tensor(a, device=x.device))
                          for a in routes[len(seen)])
        flips = (torch.sort(idx, -1)[0] != torch.sort(want_i, -1)[0]).any(-1)
        seen.append((float((probs.detach() - want_p).abs().max()),
                     int(flips.sum())))
        gates = probs.gather(-1, want_i)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True),
                                          min=1e-9), want_i
    moe.route = route
    try:
        yield seen
    finally:
        moe.route = real


def sharded_compare(got, want):
    """Every step's sharded logits against the single device's, both fed
    the single device's greedy tokens (and router choices): within
    ``SHARDED_TOL_STEPS`` bf16 steps of the largest |logit|; each sharded
    greedy choice the single device's, or a near-tie of its logits (within
    ``SHARDED_NEAR_TIE`` bf16 steps of its best).  Returns (max |delta|,
    the limit, the largest |delta| at each step, compared tokens,
    near-ties)."""
    import numpy as np
    scale = max(float(np.abs(w).max()) for w in want["logits"])
    tol = SHARDED_TOL_STEPS * bf16_step(scale)
    by_step = [float(np.abs(g - w).max())
               for g, w in zip(got["logits"], want["logits"])]
    err, compared, ties = max(by_step), 0, 0
    for i, w in enumerate(want["logits"]):
        for r in range(w.shape[0]):
            compared += 1
            a, b = int(got["tokens"][r, i]), int(want["tokens"][r, i])
            if a != b:
                best = float(w[r].max())
                if best - float(w[r, a]) > SHARDED_NEAR_TIE * bf16_step(best):
                    raise AssertionError(
                        f"sharded row {r} step {i}: token {a} against {b}, "
                        f"not a near-tie ({best - float(w[r, a])})")
                ties += 1
    if not err <= tol:
        raise AssertionError(f"sharded logits max |delta| {err} > {tol} "
                             f"({SHARDED_TOL_STEPS} bf16 steps at {scale}); "
                             f"by step {by_step}")
    if compared < SHARDED_MIN_COMPARED:
        raise AssertionError(f"sharded: {compared} tokens compared, fewer "
                             f"than {SHARDED_MIN_COMPARED}")
    return err, tol, by_step, compared, ties


def sharded_phase(dev):
    """Phase 12: each ``SHARDED_CASES`` case through the production cells'
    step functions on ranks sharing the card, held against the single
    device, then each ``SHARDED_TRAIN_CASES`` case through the train
    cells' step, held against one device's steps (run by rank 0); the
    cases of one mesh shape run in one world, the single device's runs
    first, then the worlds by ``SHARDED_WAVES``.  Any failed case raises.
    Returns the kernels' launches on the path (all 0: the cells
    dequantize in-graph)."""
    import concurrent.futures as cf
    import torch
    t_phase = time.perf_counter()
    launches = {}
    shapes = list(dict.fromkeys(
        [shape for _, shape, _ in SHARDED_CASES]
        + [shape for _, shape, _ in SHARDED_TRAIN_CASES]))
    if sorted(sum(SHARDED_WAVES, ())) != sorted(shapes):
        raise AssertionError(f"SHARDED_WAVES {SHARDED_WAVES} do not hold "
                             f"each mesh shape once: {shapes}")
    plans = {}
    for shape in shapes:
        cases = [(a, m) for a, sh, m in SHARDED_CASES if sh == shape]
        train = [(a, q) for a, sh, q in SHARDED_TRAIN_CASES if sh == shape]
        wants, jobs = [], []
        for arch, mode in cases:
            prompt, _ = sharded_inputs(sharded_config(arch))
            wants.append(sharded_single(arch, prompt, dev))
            jobs.append((arch, mode, prompt, wants[-1]["tokens"][:, :GEN],
                         wants[-1]["routes"]))
            torch.cuda.empty_cache()
        plans[shape] = (cases, train, wants, jobs)
    worlds = {}
    for wave in SHARDED_WAVES:
        with cf.ThreadPoolExecutor(len(wave)) as pool:
            futs = {shape: pool.submit(mesh_spawn, sharded_ranks, shape,
                                       (plans[shape][3], plans[shape][1]))
                    for shape in wave}
            for shape, fut in futs.items():
                worlds[shape] = fut.result()
    for shape in shapes:
        cases, train, wants, _ = plans[shape]
        ranks, wall = worlds[shape]
        for i, ((arch, mode), want) in enumerate(zip(cases, wants)):
            launches = _sharded_case(arch, shape, mode, want,
                                     [r[0][i] for r in ranks], wall,
                                     launches)
        for i, (arch, q8) in enumerate(train):
            launches = _sharded_train_case(arch, shape, q8,
                                           [r[1][i] for r in ranks], wall,
                                           launches)
    if any(launches.values()):
        raise AssertionError(f"the sharded path launched kernels: "
                             f"{launches}")
    emit("sharded", run="phase", seconds=time.perf_counter() - t_phase,
         waves=[[list(sh) for sh in wave] for wave in SHARDED_WAVES])
    return launches


def sharded_ranks(mesh, jobs, train=()):
    """:func:`sharded_rank` of each job in turn, then
    :func:`sharded_train_rank` of each ``(arch, q8_gather)`` of ``train``,
    in one world (a world of each mesh shape: its ranks start once)."""
    serve = [sharded_rank(mesh, *job) for job in jobs]
    return serve, [sharded_train_rank(mesh, *job) for job in train]


def _sharded_case(arch, shape, mode, want, got, wall, launches):
    """Hold one case's ranks ``got`` to the single device's run ``want``,
    emit its ``sharded`` line and add its launches to ``launches``."""
    import numpy as np
    r0 = got[0]
    for r in got[1:]:
        if not (np.array_equal(r["tokens"], r0["tokens"])
                and r["prints"] == r0["prints"]):
            raise AssertionError(f"sharded rank {r['coord']} differs "
                                 f"from rank 0")
    err, tol, by_step, compared, ties = sharded_compare(r0, want)
    for r in got:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    emit("sharded", arch=arch, mesh=list(shape), serve_mode=mode,
         cut=sharded_cut(arch), ranks=len(got), backend=MESH_BACKEND,
         shared_card="every rank on cuda:0: one card's times shared by "
                     "the ranks over gloo (through host memory), not a "
                     "multi-card figure",
         batch=BATCH, prompt=PROMPT, decode_steps=GEN,
         world_wall_s=wall, wall_s=r0["wall_s"],
         rank_wall_s=[r["wall_s"] for r in got],
         prefill_s=[r["prefill_s"] for r in got],
         decode_s=[r["decode_s"] for r in got],
         decode_tok_per_s=BATCH * GEN / max(r0["decode_s"], 1e-9),
         collectives=[r["collectives"] for r in got],
         weight_bytes_per_rank=[r["weight_bytes"] for r in got],
         single_device_weight_bytes=want["weight_bytes"],
         cache_bytes_per_rank=[r["cache_bytes"] for r in got],
         single_device_cache_bytes=want["cache_bytes"],
         cache_shape=r0["cache_shape"],
         peak_bytes=[r["peak_bytes"] for r in got],
         max_abs_err=err, tol=tol, max_abs_err_by_step=by_step,
         logits_scale=float(max(np.abs(w).max()
                                for w in want["logits"])),
         tokens_compared=compared, near_ties=ties,
         router_max_abs_dp=max([d for d, _ in r0["routes"]],
                               default=None),
         router_own_choice_differs=sum(f for _, f in r0["routes"]),
         launches=[r["launches"] for r in got])
    return launches


def sharded_train_config(arch):
    """``arch`` at full width cut to ``SHARDED_TRAIN_DEPTH`` layers (the
    encdec's encoder and decoder each; the hybrid by
    ``SHARDED_TRAIN_HYBRID_CUT``), a routed config admitting every choice
    (:func:`sharded_config`)."""
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, **SHARDED_TRAIN_HYBRID_CUT)
        cf = float(cfg.moe.padded_experts(16) // cfg.moe.top_k)
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    cfg = sharded_config(arch)
    depth = SHARDED_TRAIN_DEPTH[arch]
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=depth, enc_layers=depth)
    return dataclasses.replace(cfg, n_layers=depth)


def sharded_train_cut(arch):
    """What the sharded train case of ``arch`` cut from the published
    config."""
    cfg = sharded_train_config(arch)
    cut = {"n_layers": cfg.n_layers}
    if cfg.family == "encdec":
        cut["enc_layers"] = cfg.enc_layers
    if cfg.family == "hybrid":
        cut.update(SHARDED_TRAIN_HYBRID_CUT, moe_ffns=cfg.n_layers
                   // cfg.moe.every_n, experts=cfg.moe.padded_experts(16),
                   capacity_factor=cfg.moe.capacity_factor)
    return cut


def sharded_train_batches(cfg):
    """``PROD_TRAIN["steps"]`` batches of ``PROD_TRAIN``'s shape from
    ``SHARDED_SEED`` (numpy): each step's tokens and, for the encdec, its
    float32 source frames (normal, drawn from the same generator after
    every step's tokens; the step takes them in bf16)."""
    import numpy as np
    rng = np.random.default_rng(SHARDED_SEED)
    B, S = PROD_TRAIN["batch"], PROD_TRAIN["seq_len"]
    batches = [{"tokens": rng.integers(0, cfg.vocab, (B, S + 1))}
               for _ in range(PROD_TRAIN["steps"])]
    if cfg.family == "encdec":
        for b in batches:
            b["src_embeds"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
                np.float32)
    return batches


def sharded_train_tc(q8):
    from repro_torch.training import optimizer as opt, train_loop
    return train_loop.TrainConfig(
        opt=opt.AdamWConfig(schedule=opt.Schedule(
            base_lr=1e-3, warmup_steps=1, total_steps=4)),
        remat=True, q8_gather=q8)


def _rel_parts(a, b):
    """(|a - b|^2, |b|^2) in float64."""
    import torch
    d = (a.double() - b.double())
    return float(torch.sum(d * d)), float(torch.sum(b.double() ** 2))


def sharded_train_rank(mesh, arch, q8):
    """One rank of a sharded train case.  Rank 0 first runs one device's
    steps on the card from the seeded weights (:func:`sharded_weights`),
    recording its router calls, which every rank is then fed; every rank
    cuts the same weights into its ZeRO blocks and, with ``q8``, holds its
    blocks' quantized symbols, scales and zeros to one device's (bitwise),
    then runs the train cell's step (``specs.train_contexts``)
    ``PROD_TRAIN["steps"]`` times, timed, its collectives recorded.  Rank
    0 holds each leaf's update and first moment on its own blocks to one
    device's (no block crosses the wire for the comparison; one device's
    tensor is cut as the train state is, an SSM's ``in_zx`` re-blocked
    first, ``train_loop.zx_split``).  Every rank
    reports its losses and grad norms, its weight, moment and peak bytes,
    its collectives and the FSDP all-gathers it issued."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ctx import Sharded, local_block
    from repro_torch.kernels import build
    from repro_torch.launch import specs
    from repro_torch.models.layers import QTG
    from repro_torch.models.mamba2 import zx_blocks
    from repro_torch.serving import engine
    from repro_torch.training import optimizer as opt, train_loop
    t_start = time.perf_counter()
    sharded_rank_check(mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = sharded_train_config(arch)
    tc = sharded_train_tc(q8)
    batches = [{k: torch.as_tensor(v, device=dev).to(torch.bfloat16)
                if k == "src_embeds" else torch.as_tensor(v, device=dev)
                for k, v in b.items()} for b in sharded_train_batches(cfg)]
    whole = dict(sharded_weights(cfg, dev))
    out = dict(coord=mesh.key(), arch=arch, q8_gather=q8)
    single, routes = None, []
    if mesh.rank == 0:
        step = train_loop.make_train_step(cfg, tc)
        p, s = dict(whole), opt.init_state(tc.opt, whole)
        losses, norms, times = [], [], []
        with recording_routes() as routes:
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, s, m = step(p, s, b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        single = dict(losses=losses, grad_norms=norms, step_s=times,
                      params=p, moments=s.m)
        del s
        torch.cuda.empty_cache()
    routes = collectives.gather_object(routes)[0]
    hints, ep = specs.train_contexts(cfg, mesh)
    step = train_loop.make_train_step(cfg, tc, mesh, hints=hints, ep=ep)
    placed, state = train_loop.shard_train_state(cfg, tc, whole, mesh)
    out["weight_bytes"] = engine.local_bytes(placed)
    out["moment_bytes"] = opt.moment_bytes(state)

    def block(t, p, name=""):
        """This rank's block of one device's ``t`` as ``p`` rests (the
        leaf ``name``'s columns re-blocked as the train state's)."""
        if not isinstance(p, Sharded):
            return t
        t = zx_blocks(t, train_loop.zx_split(cfg, name, p.spec, mesh))
        return local_block(t, p.spec, mesh)

    if q8:
        want = train_loop.ste_quantize_params(whole, q8)
        got = train_loop.ste_quantize_params(placed, q8, mesh)
        n_data = mesh.shape["data"]
        payload, same, leaves = set(), True, 0
        for n, w in got.items():
            if not isinstance(w, QTG):
                continue
            leaves += 1
            for g, wt, name in zip(w[:3], want[n][:3], (n, "", "")):
                same = same and torch.equal(
                    g.local if isinstance(g, Sharded) else g,
                    block(wt, g, name))
            # what a step may gather of it over data: a layer's symbols
            # (of a stack) and a per-row scale / zero split over data
            if n_data > 1 and isinstance(w.q, Sharded) \
                    and "data" in w.q.spec:
                q = w.q.local
                layer = q[0] if w.q.spec[0] is None and q.dim() > 2 else q
                payload.add(("uint8", layer.numel() * n_data))
                for part in (w.scale, w.zero):
                    if isinstance(part, Sharded):
                        payload.add(("float32",
                                     part.local.numel() * 4 * n_data))
        out.update(q8_bitwise=bool(same), q8_leaves=leaves,
                   q8_payload=sorted(payload))
        del want, got
    if mesh.rank != 0:
        del whole
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rows = lambda t: local_block(t, ("data",), mesh)  # noqa: E731
    for k in build.launches:
        build.launches[k] = 0
    collectives.reset_counts()
    losses, norms, times = [], [], []
    with collectives.recording() as records, \
            replayed_routes(routes, [rows]) as seen:
        for b in batches:
            b = train_loop.shard_batch(b, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            placed, state, m = step(placed, state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out.update(losses=losses, grad_norms=norms, step_s=times,
               collectives=dict(collectives.counts),
               launches=dict(build.launches), routes=seen,
               peak_bytes=torch.cuda.max_memory_allocated(dev))
    gathers = {}
    for r in records:
        if r["kind"] == "all-gather" and r["axis"] in ("pod", "data"):
            k = (r["dtype"], r["bytes"])
            gathers[k] = gathers.get(k, 0) + 1
    out["data_gathers"] = sorted((d, b, n) for (d, b), n in gathers.items())
    if mesh.rank == 0:
        upd, mom = {}, {}
        for n, p in placed.items():
            mine = p.local if isinstance(p, Sharded) else p
            upd[n] = _rel_parts(mine - block(whole[n], p, n),
                                block(single["params"][n] - whole[n], p, n))
            mom[n] = _rel_parts(state.m[n],
                                block(single["moments"][n], p, n))
        out["update_rel_l2"] = {n: (a / max(b, 1e-300)) ** 0.5
                                for n, (a, b) in upd.items()}
        out["update_rel_l2_all"] = (sum(a for a, _ in upd.values())
                                    / sum(b for _, b in upd.values())) ** 0.5
        out["moment_rel_l2"] = {n: (a / max(b, 1e-300)) ** 0.5
                                for n, (a, b) in mom.items()}
        out["single"] = {k: single[k]
                         for k in ("losses", "grad_norms", "step_s")}
        del single, whole
    del placed, state
    torch.cuda.empty_cache()
    out["rows"] = np.int64(PROD_TRAIN["batch"])
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _sharded_train_case(arch, shape, q8, got, wall, launches):
    """Hold one train case's ranks to one device (rank 0 compared them),
    emit its ``sharded`` line and add its launches to ``launches``."""
    r0 = got[0]
    tol = SHARDED_TRAIN_TOL
    for r in got:
        for k, want, lim in (("losses", "losses", tol["loss"]),
                             ("grad_norms", "grad_norms", tol["grad_norm"])):
            for a, b in zip(r[k], r0["single"][want]):
                if abs(a - b) > lim * abs(b):
                    raise AssertionError(
                        f"sharded train {arch} {shape} rank {r['coord']}: "
                        f"{k} {r[k]}, one device {r0['single'][want]}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    worst_u = max(r0["update_rel_l2"].items(), key=lambda kv: kv[1])
    worst_m = max(r0["moment_rel_l2"].items(), key=lambda kv: kv[1])
    if worst_u[1] > tol["update"] or worst_m[1] > tol["moment"]:
        raise AssertionError(f"sharded train {arch} {shape}: update "
                             f"{worst_u}, moment {worst_m} over {tol}")
    if q8:
        for r in got:
            if not (r["q8_bitwise"] and r["q8_leaves"]):
                raise AssertionError(
                    f"sharded train {arch} rank {r['coord']}: q8_gather "
                    f"symbols differ from one device's")
            want = {tuple(x) for x in r["q8_payload"]}
            moved = {(d, b) for d, b, _ in r["data_gathers"]}
            if not moved <= want or (want and not moved):
                raise AssertionError(
                    f"sharded train {arch} q8: the FSDP gathers moved "
                    f"{sorted(moved - want)}, not the quantized payload "
                    f"{sorted(want)}")
    emit("sharded", run="train", arch=arch, mesh=list(shape),
         q8_gather=q8, cut=sharded_train_cut(arch),
         batch=PROD_TRAIN["batch"], seq_len=PROD_TRAIN["seq_len"],
         steps=PROD_TRAIN["steps"], ranks=len(got), backend=MESH_BACKEND,
         shared_card="every rank on cuda:0 over gloo (through host "
                     "memory): one card's times shared by the ranks, not "
                     "a multi-card figure",
         losses=[r["losses"] for r in got], grad_norms=r0["grad_norms"],
         single_losses=r0["single"]["losses"],
         single_grad_norms=r0["single"]["grad_norms"],
         update_rel_l2_max=list(worst_u), moment_rel_l2_max=list(worst_m),
         update_rel_l2_all=r0["update_rel_l2_all"], tol=tol,
         compared="updates and moments on rank 0's blocks; q8 symbols on "
                  "every rank's",
         step_ms=[[1e3 * t for t in r["step_s"]] for r in got],
         single_step_ms=[1e3 * t for t in r0["single"]["step_s"]],
         weight_bytes_per_rank=[r["weight_bytes"] for r in got],
         moment_bytes_per_rank=[r["moment_bytes"] for r in got],
         peak_bytes=[r["peak_bytes"] for r in got],
         collectives=[r["collectives"] for r in got],
         data_all_gathers=r0["data_gathers"],
         q8_leaves=[r.get("q8_leaves") for r in got],
         router_max_abs_dp=max([d for d, _ in r0["routes"]], default=None),
         router_own_choice_differs=sum(f for _, f in r0["routes"]),
         world_wall_s=wall, rank_wall_s=[r["wall_s"] for r in got],
         launches=[r["launches"] for r in got])
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    # outside a checkout this import fails, before any child is started
    from repro_torch.kernels import build  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    emit("device", kind=kind, count=count, torch=torch.__version__,
         cuda=torch.version.cuda, max_sm_clock_mhz=clock_mhz)
    print(smi_line, flush=True)

    children = [start_containers("serve"), start_containers("moe")]
    static = start_static()
    pools = []
    try:
        return run_phases(children, pools, kind, count, smi_line, clock_mhz,
                          dev, static)
    finally:
        for child, *_ in children + [static]:
            if child.poll() is None:
                child.kill()
                child.wait()
        for pool in pools:
            stop_dryruns(pool)


def run_phases(children, pools, kind, count, smi_line, clock_mhz, dev,
               static):
    """Every phase in order; the container children, the static analysis
    and the production dry-runs run meanwhile on the host.  The serve and moe children start
    first (the reference checks run while the serve container is
    encoded); the families' child and the dry-runs start once the serve
    phase has been measured, so that one encoder, not more, shares the
    host with it."""
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(build.lib_path().relative_to(ROOT)),
         ptxas=[ln.strip() for ln in report.splitlines()
                if "Compiling" in ln or "registers" in ln or "spill" in ln])

    # the reference checks run while the serve child encodes
    reference_check(dev)
    reduced_reference_check(dev)
    t0 = time.perf_counter()
    cm, launches, eng, prompt, dense_logits, dense_tokens = \
        serve_main_path(children[0], dev)
    serve_s = time.perf_counter() - t0
    children.append(start_containers("ssm", "encdec"))
    dryruns = start_dryruns()
    pools.append(dryruns[0])
    profile_decode(eng, prompt, dev)
    t0 = time.perf_counter()
    continuous_launches = continuous_phase(cm, eng.params, dev)
    continuous_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    paged_launches = paged_phase(eng.params, dev)
    paged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet_launches, want_slots = fleet_phase(cm, eng.params, dev)
    fleet_s = time.perf_counter() - t0
    # the moe container, for its mesh world (beside qwen3's) and its phase
    moe_container = containers(*children[1], keep={"moe": MOE_ARCH})["moe"]
    t0 = time.perf_counter()
    qwen3_launches, moe_world = mesh_phase(cm, eng.params, dense_tokens,
                                           want_slots, dev)
    mesh_launches = {"qwen3": qwen3_launches}
    mesh_s = time.perf_counter() - t0
    dq_row = dequant_matmul_phase(cm, eng.params, clock_mhz, dev)
    del eng
    t0 = time.perf_counter()
    rw, resident_launches = resident_phase(cm, prompt, dense_logits,
                                           dense_tokens, dev)
    resident_s = time.perf_counter() - t0
    rows = kernel_phase(cm, launches, clock_mhz, dev)
    rows += fused_kernel_rows(rw, resident_launches, clock_mhz, dev)
    rows.append(dq_row)
    del rw, cm
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_launches, moe_served = moe_phase(moe_container, clock_mhz, dev)
    del moe_container
    moe_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches["moe"] = mesh_moe_phase(*moe_served, moe_world)
    mesh_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    family_launches = families_phase(children[2], dev)
    families_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = train_phase(dev)
    train_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    production_launches = production_phase(dev, dryruns)
    production_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_launches = sharded_phase(dev)
    sharded_s = time.perf_counter() - t0
    for row in rows:
        row["launches_continuous"] = continuous_launches.get(row["name"], 0)
        row["launches_paged"] = paged_launches.get(row["name"], 0)
        row["launches_fleet"] = fleet_launches.get(row["name"], 0)
        row["launches_mesh"] = {k: v.get(row["name"], 0)
                                for k, v in mesh_launches.items()}
        row["launches_moe"] = {k: v.get(row["name"], 0)
                               for k, v in moe_launches.items()}
        for family, got in family_launches.items():
            row[f"launches_{family}"] = got.get(row["name"], 0)
        row["launches_train"] = train_launches.get(row["name"], 0)
        row["launches_production"] = production_launches.get(row["name"], 0)
        row["launches_sharded"] = sharded_launches.get(row["name"], 0)
    static_phase(static)
    emit("done", serve_phase_s=serve_s, continuous_phase_s=continuous_s,
         paged_phase_s=paged_s, fleet_phase_s=fleet_s, mesh_phase_s=mesh_s,
         resident_phase_s=resident_s,
         moe_phase_s=moe_s, families_phase_s=families_s,
         train_phase_s=train_s, production_phase_s=production_s,
         sharded_phase_s=sharded_s, script_s=time.perf_counter() - START)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def train_only():
    """``chip_smoke.py --train-only``: the build and the train phase alone
    (a quicker rehearsal of that phase on the card; prints no result
    line)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"), flush=True)
    build.build()
    t0 = time.perf_counter()
    launches = train_phase(torch.device("cuda"))
    emit("done", train_phase_s=time.perf_counter() - t0,
         launches_train=launches, script_s=time.perf_counter() - START)
    return 0


def sharded_only():
    """``chip_smoke.py --sharded-only``: the sharded phase alone (prints no
    result line)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    launches = sharded_phase(torch.device("cuda"))
    emit("done", sharded_phase_s=time.perf_counter() - t0,
         launches_sharded=launches, script_s=time.perf_counter() - START)
    return 0


def production_only():
    """``chip_smoke.py --production-only``: the production phase alone
    (prints no result line)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    dryruns = start_dryruns()
    try:
        launches = production_phase(torch.device("cuda"), dryruns)
    finally:
        stop_dryruns(dryruns[0])
    emit("done", production_phase_s=time.perf_counter() - t0,
         launches_production=launches, script_s=time.perf_counter() - START)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--production-only"]:
        sys.exit(production_only())
    if sys.argv[1:2] == ["--sharded-only"]:
        sys.exit(sharded_only())
    if sys.argv[1:2] == ["--containers"]:
        write_containers(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    if sys.argv[1:2] == ["--train-only"]:
        sys.exit(train_only())
    sys.exit(main())
