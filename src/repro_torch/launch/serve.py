"""Serving launcher (PyTorch port): EntroLLM end to end, lockstep or
continuous batching.

Pipeline: seeded random weights -> mixed-quantize + entropy-encode into the
compressed container (``--codec`` picks the coder; ``--compress-spec`` sets
per-tensor bits / codec / fp32 rules — see :mod:`repro_torch.core.spec`) ->
*streaming* parallel decode (chunked, double-buffered prefetch through a
named decoder backend; on a card, the CUDA decode kernels) -> serve with
quantized (QT) weights resident, dequantized at use:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --bits 8 --batch 4 --prompt-len 32 --gen 16 [--device cpu]

``--resident compressed`` keeps the container entropy-coded and decodes
each layer just before its matmuls; ``--fused`` adds the fused
decode→dequant→matmul kernels for the tile-aligned tensors:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --resident compressed --fused [--device cpu]

``--batch-slots N`` serves independently arriving requests through an
N-slot continuous-batching engine instead of one lockstep batch (either
residency); ``--traffic R`` replays R seeded Poisson arrivals with ragged
prompts and generation lengths:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch-slots 4 --traffic 8 --prompt-len 16 --gen 8 [--device cpu]

It serves the reduced variant of ``--arch`` (``registry.reduced``), like the
JAX launcher; ``chip_smoke.py`` drives the full width.  Runs on the card
unless ``--device cpu`` is given.  The JAX launcher's other serving modes
(paged KV, fleets, meshes) are not ported yet and their flags exit with a
message saying so.
"""
import argparse
import sys
import time

# flags of the JAX launcher whose serving modes the port does not have yet
_NOT_PORTED_FLAGS = (
    "--kv-spec", "--kv-block",
    "--prefix-sharing", "--replicas", "--router", "--disaggregate", "--mesh",
    "--production", "--shape", "--multi-pod")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--bits", type=int, default=8,
                   help="uniform quantization bit-width, 1..8 (subsumed by "
                        "--compress-spec)")
    p.add_argument("--codec", default="huffman",
                   help="entropy codec for the whole model (huffman / rans / "
                        "raw); subsumed by --compress-spec")
    p.add_argument("--compress-spec", default=None, metavar="SPEC",
                   help="per-tensor compression rules, e.g. "
                        "'*norm*:fp32;layers/*:bits=4,codec=rans;*:bits=8' "
                        "(see repro_torch.core.spec); overrides --bits/--codec")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--no-quantized-serving", action="store_true",
                   help="dequantize to dense fp32 at load (baseline mode)")
    p.add_argument("--resident", choices=("dense", "compressed"),
                   default="dense",
                   help="weight residency: 'dense' decodes the container "
                        "into resident QT params at load; 'compressed' "
                        "keeps the entropy-coded payload resident and "
                        "decodes each layer just before its matmuls "
                        "(bit-identical greedy outputs)")
    p.add_argument("--fused", action="store_true",
                   help="with --resident compressed: hand tile-aligned "
                        "tensors to the fused decode→dequant→matmul kernel "
                        "as payload handles; other tensors fall back "
                        "per tensor to the per-layer decode path")
    p.add_argument("--fused-impl", default=None,
                   help="only 'auto' (the handle's device picks the CUDA "
                        "kernel or its plain version); the JAX launcher's "
                        "other choices are not ported")
    p.add_argument("--decode-backend", default=None,
                   help="decoder backend name (numpy / torch / cuda); "
                        "default: follow --device")
    p.add_argument("--chunk-symbols", type=int, default=None,
                   help="streaming decode chunk budget in symbols "
                        "(default: scheduler per-layer budget)")
    p.add_argument("--no-stream", action="store_true",
                   help="monolithic decode_all load")
    p.add_argument("--batch-slots", type=int, default=0, metavar="N",
                   help="serve with an N-slot continuous-batching engine "
                        "instead of one lockstep batch (0 = lockstep)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission-queue bound for --batch-slots")
    p.add_argument("--prefill-chunk", type=int, default=16,
                   help="chunked-prefill step for --batch-slots")
    p.add_argument("--traffic", type=int, default=0, metavar="R",
                   help="with --batch-slots: replay R synthetic Poisson "
                        "arrivals (ragged prompts/gen) instead of one "
                        "uniform request wave")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda; raises "
                        "when no card is present)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome/Perfetto trace_event JSON of the "
                        "serve (load + prefill + decode spans)")
    p.add_argument("--metrics-out", default=None, metavar="FILE",
                   help="write the metrics-registry snapshot as JSON lines")
    p.add_argument("--trace-sync", action="store_true",
                   help="synchronize the device inside spans so durations "
                        "measure device time, not launch enqueue")
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED_FLAGS:
            p.error(f"{flag} is not ported yet (the PyTorch port serves "
                    f"lockstep and continuous batches, dense or compressed "
                    f"resident)")
    args = p.parse_args(argv)
    if args.traffic > 0 and args.batch_slots < 1:
        p.error("--traffic replays arrivals through --batch-slots N")
    if args.fused_impl not in (None, "auto"):
        p.error(f"--fused-impl {args.fused_impl} is not ported yet (the "
                f"port picks the fused kernel by the tensor's device)")
    if args.resident == "compressed":
        if args.no_quantized_serving:
            p.error("--resident compressed always serves QT weights "
                    "(the per-layer slots hold quantized triples); "
                    "drop --no-quantized-serving")
        if args.no_stream:
            p.error("--no-stream only applies to the load-time decode of "
                    "--resident dense")
    elif args.fused or args.fused_impl:
        p.error("--fused/--fused-impl require --resident compressed (the "
                "fused kernel consumes the entropy-coded payload handles "
                "that mode keeps resident)")

    # validate names against the registries before any expensive work
    from repro_torch.core.codecs import codec_names
    from repro_torch.core.decode_backends import (available_backends,
                                                  backend_names)
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec, spec_from_legacy
    if args.decode_backend not in (None, "auto"):
        if args.decode_backend not in backend_names():
            p.error(f"unknown decoder backend {args.decode_backend!r}; "
                    f"registered: {backend_names()}")
        if args.decode_backend not in available_backends():
            p.error(f"decoder backend {args.decode_backend!r} is not "
                    f"available on this host; available: "
                    f"{available_backends()}")
    if args.compress_spec is not None:
        try:
            # PER_CHANNEL default: one (s, z) per leading index, i.e. per
            # layer on the layer-stacked tensors (the JAX launcher's rule)
            compress_spec = CompressionSpec.parse(
                args.compress_spec,
                default_granularity=Granularity.PER_CHANNEL)
        except (ValueError, KeyError) as e:
            p.error(f"bad --compress-spec: {e}")
    else:
        if args.codec not in codec_names():
            p.error(f"unknown codec {args.codec!r}; "
                    f"registered: {codec_names()}")
        if not 1 <= args.bits <= 8:
            p.error(f"--bits must be in [1, 8], got {args.bits}")
        compress_spec = spec_from_legacy(args.bits, Granularity.PER_CHANNEL,
                                         codec=args.codec)

    import numpy as np
    from repro_torch import device as _device
    from repro_torch.configs import registry
    from repro_torch.core.store import CompressedModel
    from repro_torch.models import api
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine

    dev = _device.resolve(args.device)
    if args.trace_out or args.trace_sync:
        obs_trace.enable(sync=args.trace_sync)

    cfg = registry.reduced(registry.get(args.arch))
    mod = api.build(cfg)
    params = mod.init(cfg, 0, dev)
    host = {k: v.float().cpu().numpy() for k, v in params.items()}
    del params

    t0 = time.perf_counter()
    cm = CompressedModel.compress(host, spec=compress_spec)
    t_comp = time.perf_counter() - t0
    st = cm.stats()
    print(f"compressed {st.param_count/1e6:.1f}M params: "
          f"{st.bits:.3g}b quant -> {st.effective_bits:.2f} effective bits "
          f"(entropy {st.entropy_bits:.2f}); "
          f"{st.reduction_vs_quant*100:.1f}% below quantized, "
          f"{st.reduction_vs_fp16*100:.1f}% below fp16  [{t_comp:.1f}s]")
    for g in st.groups:
        print(f"  [{g.table_id}] {g.param_count/1e6:.2f}M params: "
              f"{g.bits}b {g.codec} -> {g.effective_bits:.2f} achieved bits "
              f"(bound {g.entropy_bits:.2f}, {g.shannon_ratio:.3f}x)")

    load_metrics = {}
    load_kw = {}
    if args.chunk_symbols is not None:
        load_kw["chunk_symbols"] = args.chunk_symbols
    if args.resident == "compressed":
        from repro_torch.serving.resident import CompressedResidentWeights
        # absent --chunk-symbols: the JAX launcher's tighter 64k budget (the
        # int32 scratch is part of the resident peak)
        load_kw.setdefault("chunk_symbols", 64 * 1024)
        t0 = time.perf_counter()
        serve_params = CompressedResidentWeights(
            cm, cfg, backend=args.decode_backend, fused=args.fused,
            device=dev, **load_kw)
        load_metrics["decode_load_s"] = time.perf_counter() - t0
        load_metrics["decode_backend"] = serve_params.backend.name
        if args.fused:
            via = "cuda kernel" if dev.type == "cuda" else "plain torch"
            print(f"  fused decode→dequant→matmul: "
                  f"{len(serve_params._fused)} tensors "
                  f"{sorted(serve_params._fused)} via {via}; "
                  f"{len(serve_params.fused_fallback)} fall back "
                  f"{serve_params.fused_fallback or ''}")
        rb = serve_params.resident_bytes()
        peak = serve_params.peak_resident_bytes()
        print(f"compressed-resident load [{load_metrics['decode_backend']}]: "
              f"{load_metrics['decode_load_s']:.2f}s (globals + carve-outs "
              f"decoded; {len(serve_params.plan)} layers stay entropy-coded)")
        print(f"  peak resident weights {peak/2**20:.2f} MiB "
              f"(payload {rb['payload']/2**20:.2f} + tables/qmeta "
              f"{(rb['tables']+rb['qmeta'])/2**20:.2f} + globals "
              f"{(rb['globals']+rb['stacked'])/2**20:.2f} + 2x layer slot "
              f"{rb['layer_slot']/2**20:.2f} + scratch "
              f"{rb['scratch']/2**20:.2f}) vs dense-resident QT "
              f"{serve_params.dense_resident_bytes()/2**20:.2f} MiB, "
              f"dense bf16 {serve_params.dense_bf16_bytes()/2**20:.2f} MiB")
    else:
        serve_params = engine.load_params_from_compressed(
            cm, quantized=not args.no_quantized_serving,
            backend=args.decode_backend, stream=not args.no_stream,
            device=dev, metrics=load_metrics, **load_kw)
        print(f"{'streamed' if not args.no_stream else 'monolithic'} decode "
              f"+ load [{load_metrics['decode_backend']}]: "
              f"{load_metrics['decode_load_s']:.2f}s "
              f"(first weight resident after "
              f"{load_metrics['time_to_first_weight_s']*1e3:.0f}ms; "
              f"quantized residency: {not args.no_quantized_serving})")

    # slot mode pads prompts to a prefill-chunk multiple, so its cache needs
    # that much headroom; the lockstep path keeps the exact footprint
    headroom = args.prefill_chunk if args.batch_slots > 0 else 0
    sc = engine.ServeConfig(max_len=args.prompt_len + args.gen + headroom)
    rng = np.random.default_rng(0)
    if args.batch_slots > 0:
        rc = _serve_continuous(cfg, serve_params, sc, args, rng,
                               load_metrics, dev)
        if args.resident == "compressed":
            serve_params.close()
        _write_obs(args)
        return rc

    eng = engine.Engine(cfg, serve_params, sc, device=dev,
                        resident=args.resident)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    out, metrics = eng.generate(prompt, args.gen, echo_metrics=True)
    if args.resident == "compressed":
        serve_params.close()
    ttft = load_metrics["decode_load_s"] + metrics["ttft_s"]
    print(f"generated {tuple(out.shape)} tokens: prefill "
          f"{metrics['prefill_s']:.2f}s, decode {metrics['decode_s']:.2f}s "
          f"({metrics['decode_tok_per_s']:.1f} decode tok/s, "
          f"{metrics['e2e_tok_per_s']:.1f} e2e tok/s); "
          f"time-to-first-token incl. weight load: {ttft:.2f}s")
    _write_obs(args)
    return 0


def _serve_continuous(cfg, serve_params, sc, args, rng, load_metrics, dev):
    """--batch-slots path: slot-batched serving of independent requests."""
    import numpy as np
    from repro_torch.obs.metrics import percentile
    from repro_torch.serving.batching import (ContinuousEngine,
                                              QueueFullError, poisson_trace,
                                              replay)

    ce = ContinuousEngine(cfg, serve_params, sc, n_slots=args.batch_slots,
                          max_queue=args.max_queue,
                          prefill_chunk=args.prefill_chunk,
                          resident=args.resident, device=dev)
    n = args.traffic if args.traffic > 0 else args.batch
    shed = 0
    t0 = time.monotonic()
    if args.traffic > 0:        # Poisson replay: ragged prompts + gen lengths
        trace = poisson_trace(n, rate_per_s=100.0, prompt_max=args.prompt_len,
                              gen_max=args.gen, vocab=cfg.vocab, seed=0)
        _, shed, _ = replay(ce, trace, shed_on_full=True)
    else:                       # one wave of uniform requests
        for _ in range(n):
            prompt = rng.integers(0, cfg.vocab, (args.prompt_len,)
                                  ).astype(np.int32)
            while True:
                try:
                    ce.submit(prompt, args.gen)
                    break
                except QueueFullError:   # drain some work, then re-offer
                    ce.step()
        ce.run()
    span = time.monotonic() - t0
    fin = ce.finished
    if not fin:
        print(f"continuous batching: no requests completed "
              f"({shed} shed by backpressure)")
        return 1
    toks = sum(len(r.output) for r in fin)
    lat = [r.latency_s for r in fin]
    ttft = [r.ttft_s for r in fin]
    wait = [r.queue_wait_s for r in fin]
    print(f"continuous batching [{args.batch_slots} slots, queue bound "
          f"{args.max_queue}]: {len(fin)}/{n} requests"
          + (f" ({shed} shed by backpressure)" if shed else "")
          + f", {toks} tok in "
          f"{span:.2f}s = {toks/max(span, 1e-9):.1f} tok/s aggregate")
    print(f"  ttft p50 {percentile(ttft, 50)*1e3:.0f}ms "
          f"(+{load_metrics['decode_load_s']:.2f}s "
          f"weight load) | latency p50 {percentile(lat, 50)*1e3:.0f}ms "
          f"p99 {percentile(lat, 99)*1e3:.0f}ms | "
          f"{ce.n_decode_steps} fused decode steps")
    print(f"  queue wait [admitted] p50 {percentile(wait, 50)*1e3:.0f}ms "
          f"p99 {percentile(wait, 99)*1e3:.0f}ms over {len(fin)} requests"
          + (f"; {shed} shed before admission" if shed else ""))
    return 0


def _write_obs(args):
    """Export the trace / metrics-registry snapshot the serve recorded."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    if args.trace_out or args.trace_sync:
        tracer = obs_trace.disable()
        if args.trace_out and tracer is not None:
            n = tracer.save(args.trace_out)
            print(f"trace: {n} events -> {args.trace_out}")
    if args.metrics_out:
        n = obs_metrics.default_registry().write_jsonl(args.metrics_out)
        print(f"metrics: {n} rows -> {args.metrics_out}")


if __name__ == "__main__":
    sys.exit(main())
