#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and count; the next line is nvidia-smi's
   ``name, power.limit`` for the card.
2. build   — compiles the CUDA decode kernels
   (``src/repro_torch/csrc/entropy_decode.cu``) from the checkout's source
   into one library.
3. serve   — the main path at full width: qwen3-1.7b (d_model 2048, 16 heads
   and 8 KV heads of 128, d_ff 6144, padded vocab 152064, qk-norm) with its
   depth cut from 28 to ``DEPTH`` layers and seeded random weights.  The
   weights are compressed under ``SPEC`` (Huffman-8 embed and lm_head, rANS-4
   layer stacks, fp32 norms), saved and loaded as a container, decoded onto
   the card through the ``cuda`` backend (both kernels), held bitwise
   against the symbols ``quant.quantize`` gives, and served with
   ``Engine.generate`` (batch 4, prompt 32, 16 greedy tokens).  Launch counts
   are zeroed just before the load and read just after the generate.
   Then ``profile``: the same few decode steps timed without and then with
   ``torch.profiler``, and device time by operator under it.
4. reference — the reduced qwen3-1.7b served on the card and on the CPU
   through the same port: decoded weights must be identical and prefill
   logits within ``REF_ATOL``; greedy token agreement is reported.
5. kernels — each kernel on the first chunk the main path decoded with it,
   held bitwise against its plain PyTorch version on the card, with its
   time, the plain version's time, its bounds, and the time of the whole
   ``cuda`` backend call around it (host matrix in, host symbols out).
   The per-kernel line also carries two labelled estimates that no run
   reads directly: the dependent-chain time at an assumed step latency, and
   the host round trip as backend call time minus kernel time.

Then the ``kernels`` summary line (measured fields and ``bound_ms`` only),
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
SPEC = "*norm*:fp32; layers/*:bits=4,codec=rans; *:bits=8,codec=huffman"
BATCH, PROMPT, GEN = 4, 32, 16
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# integer work of one decode step (window bytes, shift, mask, table loads,
# add), against the data sheet's non-tensor float32 peak: the card's
# fastest scalar rate, so this bound errs low
OPS_PER_SYMBOL = 12
SCALAR_OPS_PER_S = 67e12
# assumed shortest dependent step of a decode lane, for an estimate only:
# one L1-hit window load (~33 cycles) and one shared-memory table load (~30
# cycles); ALU work ignored
DEP_STEP_CYCLES = 63
# card vs CPU bf16 logits of the reduced model: cuBLAS and the CPU sum the
# products in other orders, so logits may move by a few bf16 steps
REF_ATOL = 5e-2
TIMED_LAUNCHES = 10
PROFILE_STEPS = 8


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
    for k, n in launches.items():
        if n <= 0:
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
    return cm, launches, eng, prompt


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
    (pc, lc, tc), (pp, lp, tp) = runs["cuda"], runs["cpu"]
    for name in pp:
        a, b = pc[name], pp[name]
        parts = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in parts:
            assert torch.equal(x.cpu(), y), name
    err = float((lc - lp).abs().max())
    agree = float((tc == tp).float().mean())
    emit("reference", arch=cfg.name, logits_max_abs_err=err,
         atol=REF_ATOL, greedy_token_agreement=agree,
         argmax_equal_first_token=bool((tc[:, 0] == tp[:, 0]).all()))
    if not err <= REF_ATOL:
        raise AssertionError(f"card vs CPU logits differ by {err}")


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
        ms, got = cuda_ms(lambda: fn(m, c, *tabs, **kw), TIMED_LAUNCHES)
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
                   backend_call_ms=backend_ms)
        # not measured: the chain at the assumed DEP_STEP_CYCLES a step, and
        # the host round trip as a host-clock time less a device-event time
        estimates = dict(
            chain_ms=mc * DEP_STEP_CYCLES / (clock_mhz * 1e3),
            chain_assumes_cycles_per_step=DEP_STEP_CYCLES,
            host_round_trip_ms=backend_ms - ms)
        emit("kernel", **row, estimates=estimates)
        if not equal:
            raise AssertionError(f"{mod} differs from its plain version")
        rows.append(row)

    # the raw codec's identity LUT through the prefix kernel, small case
    rng = np.random.default_rng(2)
    syms = rng.integers(0, 16, (8, 4096)).astype(np.uint8)
    raw = RawCodeTable(np.bincount(syms.ravel(), minlength=16), bits=4)
    streams = [raw.encode(s)[0] for s in syms]
    width = max(len(s) for s in streams)
    mat = np.zeros((8, width), np.uint8)
    for i, s in enumerate(streams):
        mat[i, :len(s)] = s
    args = [torch.from_numpy(mat).to(dev),
            torch.full((8,), 4096, dtype=torch.int32, device=dev),
            torch.from_numpy(raw.lut_sym).to(dev),
            torch.from_numpy(raw.lut_len).to(dev)]
    got = huffman_decode.decode_streams(*args, max_len=4, max_count=4096)
    ref = huffman_decode.decode_streams_plain(*args, max_len=4,
                                              max_count=4096)
    ok = torch.equal(got, ref) and np.array_equal(got.cpu().numpy(), syms)
    emit("kernel_raw", name="huffman_decode", codec="raw4",
         shape=[8, width, 4096], bitwise_equal=ok)
    if not ok:
        raise AssertionError("raw identity-LUT decode differs")
    return rows


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
    cm, launches, eng, prompt = serve_main_path(dev)
    serve_s = time.perf_counter() - t0
    profile_decode(eng, prompt, dev)
    del eng
    reference_check(dev)
    rows = kernel_phase(cm, launches, clock_mhz, dev)
    emit("done", serve_phase_s=serve_s)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
