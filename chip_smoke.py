#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

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
   ``wo``, rANS-4 for the other layer matrices, fp32 norms), saved and
   loaded as a container, decoded onto the card through the ``cuda``
   backend (both decode kernels), held bitwise against the symbols
   ``quant.quantize`` gives, and served with ``Engine.generate`` (batch 4,
   prompt 32, 16 greedy tokens).  Launch counts are zeroed just before the
   load and read just after the generate.
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
   ``REF_ATOL``; greedy token agreement is reported.
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

Then the ``kernels`` summary line (measured fields and ``bound_ms`` only;
``launches_continuous``: each kernel's launches on the continuous phase's
compressed-resident run),
and as the last line
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

ROOT = os.path.dirname(os.path.abspath(__file__))
DEPTH = 2
SPEC = ("*norm*:fp32; layers/wo:bits=8,codec=huffman; "
        "layers/*:bits=4,codec=rans; *:bits=8,codec=huffman")
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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def serve_main_path(dev):
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec
    from repro_torch.core.store import CompressedModel
    from repro_torch.kernels import build
    from repro_torch.models import dense
    from repro_torch.serving import engine

    full = registry.get("qwen3-1.7b")
    cfg = dataclasses.replace(full, n_layers=DEPTH)
    spec = CompressionSpec.parse(SPEC,
                                 default_granularity=Granularity.PER_CHANNEL)
    t0 = time.perf_counter()
    params = dense.init(cfg, 0, dev)
    host = {k: v.float().cpu().numpy() for k, v in params.items()}
    del params
    init_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cm = CompressedModel.compress(host, spec=spec)
    compress_s = time.perf_counter() - t0
    st = cm.stats()
    path = os.path.join(ROOT, "build", "chip_smoke", "qwen3-1.7b.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    cm.save(path)
    cm = CompressedModel.load(path)
    os.remove(path)
    save_load_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in build.launches:
        build.launches[k] = 0
    load = {}
    params = engine.load_params_from_compressed(
        cm, backend="cuda", device=dev, metrics=load)
    eng = engine.Engine(cfg, params, engine.ServeConfig(max_len=PROMPT + GEN),
                        device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (BATCH, PROMPT))
    t0 = time.perf_counter()
    eng.generate(prompt, 2)          # first call: library and cache set-up
    first_generate_s = time.perf_counter() - t0
    out, met = eng.generate(prompt, GEN, echo_metrics=True)
    launches = dict(build.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    for k in ("huffman_decode", "ans_decode"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the main path")

    n_checked = check_decoded(cm, host, params, spec, dev)
    Vp = cfg.padded_vocab()
    if tuple(out.shape) != (BATCH, GEN) or out.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(out.shape)} {out.dtype}")
    if not bool(((out >= 0) & (out < Vp)).all()):
        raise AssertionError("token outside the padded vocabulary")
    with torch.inference_mode():
        logits, _ = eng.steps.prefill_fn(
            params, torch.as_tensor(prompt, device=dev))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("non-finite prefill logits")
    emit("serve", arch=cfg.name, reduced={"n_layers": [full.n_layers, DEPTH]},
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads, cfg.hd],
         d_ff=cfg.d_ff, padded_vocab=Vp, spec=SPEC,
         params=st.param_count, effective_bits=st.effective_bits,
         groups={g.table_id: {"params": g.param_count,
                              "achieved_bits": g.effective_bits,
                              "entropy_bits": g.entropy_bits}
                 for g in st.groups},
         encoded_bytes=st.encoded_bytes, init_s=init_s,
         first_generate_s=first_generate_s,
         compress_s=compress_s, save_load_s=save_load_s,
         decode_backend=load["decode_backend"],
         decode_load_s=load["decode_load_s"],
         ttfw_s=load["time_to_first_weight_s"], ttft_s=met["ttft_s"],
         ttft_incl_load_s=load["decode_load_s"] + met["ttft_s"],
         prefill_s=met["prefill_s"], decode_s=met["decode_s"],
         decode_tok_per_s=met["decode_tok_per_s"],
         e2e_tok_per_s=met["e2e_tok_per_s"], peak_bytes=peak,
         launches=launches, tensors_checked=n_checked,
         tokens=out[0].tolist())
    return cm, launches, eng, prompt, logits.float().cpu(), out.cpu()


def profile_decode(eng, prompt, dev):
    """Where a decode step's time goes: ``PROFILE_STEPS`` greedy steps after
    a prefill, timed once without the profiler and once under
    ``torch.profiler``: device time by operator and the device's idle share
    of the profiled window (the profiler's own host overhead counts as
    idle)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    S = prompt.shape[1]

    def steps(window):
        """Prefill, then the decode steps alone inside ``window``."""
        with torch.inference_mode():
            logits, cache = eng.steps.prefill_fn(
                eng.params, torch.as_tensor(prompt, device=dev))
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
    emit("profile", what="decode steps", steps=PROFILE_STEPS,
         unprofiled_wall_ms=unprofiled_wall_ms,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=1 - busy_ms / wall_ms,
         top_ops=[{"name": e.key, "device_ms": dev_us(e) / 1e3,
                   "calls": e.count} for e in ops])


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


def serve_trace(cfg, weights, resident, dev):
    """The continuous phase's trace through a fresh ``ContinuousEngine``;
    returns the engine, the requests in trace order, the trace and the
    summary metrics."""
    from repro_torch.obs.metrics import percentile
    from repro_torch.serving import engine
    from repro_torch.serving.batching import (ContinuousEngine,
                                              poisson_trace, replay)
    trace = poisson_trace(vocab=cfg.vocab, **TRAFFIC)
    ce = ContinuousEngine(cfg, weights,
                          engine.ServeConfig(max_len=CONT_MAX_LEN),
                          n_slots=N_SLOTS, prefill_chunk=PREFILL_CHUNK,
                          max_queue=MAX_QUEUE, resident=resident, device=dev)
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
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec
    from repro_torch.core.store import CompressedModel
    from repro_torch.models import dense
    from repro_torch.serving import engine
    from repro_torch.serving.resident import CompressedResidentWeights

    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    spec = CompressionSpec.parse(SPEC + "; defaults:segment_symbols=4096",
                                 default_granularity=Granularity.PER_CHANNEL)
    host = {k: v.float().numpy()
            for k, v in dense.init(cfg, 1, torch.device("cpu")).items()}
    cm = CompressedModel.compress(host, spec=spec)
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


def fused_kernel_rows(rw, launches, clock_mhz, dev):
    """Each fused kernel on layer 0's handles of the resident path (``wo``
    prefix; ``wq``, ``wk``, ``w_down`` tANS), at the path's two row counts.
    ``wo`` and ``wq`` are held against the plain version; ``wk`` and
    ``w_down`` against ``x @ deq(symbols)``, the symbols from the decode
    kernel (the plain version's Python loop would cost the script a minute
    more a case): the plain version's own arithmetic on exact symbols.  Two
    launches must be bitwise equal, and one-hot rows of x bitwise the
    dequantized weight's rows."""
    import numpy as np
    import torch
    from repro_torch.core.scheduler import plan_fused_spans
    from repro_torch.kernels import ans_decode, huffman_decode
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq

    heads, worst = {}, {}
    for short, plain_checked in FUSED_ROWS:
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
        per_m = {}
        for M in FUSED_M:
            x = torch.from_numpy(np.random.default_rng(M).normal(
                0, 1, (M, K)).astype(np.float32)).to(dev, torch.bfloat16)
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
                plain_ms, ref = cuda_ms(
                    lambda: fdm.fused_decode_matmul_plain(x, fq), 1)
                against = "plain version"
            else:
                plain_ms, ref = None, dense
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
                ms=ms, device_queued_ms=queued_ms, plain_ms=plain_ms,
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
    rows = []
    for name, (short, replaces, per_m) in heads.items():
        head = per_m[BATCH]
        at = lambda M: {k: per_m[M][k] for k in (  # noqa: E731
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "onehot_bitwise")}
        rows.append(dict(
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
    return rows


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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

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

    t0 = time.perf_counter()
    report = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         library=str(build.lib_path().relative_to(ROOT)),
         ptxas=[ln.strip() for ln in report.splitlines()
                if "Compiling" in ln or "registers" in ln or "spill" in ln])

    t0 = time.perf_counter()
    cm, launches, eng, prompt, dense_logits, dense_tokens = \
        serve_main_path(dev)
    serve_s = time.perf_counter() - t0
    profile_decode(eng, prompt, dev)
    t0 = time.perf_counter()
    continuous_launches = continuous_phase(cm, eng.params, dev)
    continuous_s = time.perf_counter() - t0
    dq_row = dequant_matmul_phase(cm, eng.params, clock_mhz, dev)
    del eng
    t0 = time.perf_counter()
    rw, resident_launches = resident_phase(cm, prompt, dense_logits,
                                           dense_tokens, dev)
    resident_s = time.perf_counter() - t0
    reference_check(dev)
    rows = kernel_phase(cm, launches, clock_mhz, dev)
    rows += fused_kernel_rows(rw, resident_launches, clock_mhz, dev)
    rows.append(dq_row)
    for row in rows:
        row["launches_continuous"] = continuous_launches.get(row["name"], 0)
    emit("done", serve_phase_s=serve_s, continuous_phase_s=continuous_s,
         resident_phase_s=resident_s)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
