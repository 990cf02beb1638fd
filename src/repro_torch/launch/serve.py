"""Serving launcher (PyTorch port): EntroLLM end to end, lockstep.

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

It serves the reduced variant of ``--arch`` (``registry.reduced``), like the
JAX launcher; ``chip_smoke.py`` drives the full width.  Runs on the card
unless ``--device cpu`` is given.  The JAX launcher's other serving modes
(continuous batching, paged KV, fleets, meshes) are not ported yet and their
flags exit with a message saying so.
"""
import argparse
import sys
import time

# flags of the JAX launcher whose serving modes the port does not have yet
_NOT_PORTED_FLAGS = (
    "--batch-slots", "--max-queue",
    "--prefill-chunk", "--traffic", "--kv-spec", "--kv-block",
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
                    f"lockstep batches, dense or compressed resident)")
    args = p.parse_args(argv)
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

    sc = engine.ServeConfig(max_len=args.prompt_len + args.gen)
    rng = np.random.default_rng(0)
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
