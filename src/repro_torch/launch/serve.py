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

``--kv-spec`` / ``--kv-block`` / ``--prefix-sharing`` serve the slot batch
through the paged KV block pool (dense residency, one device); with
``--prefix-sharing`` the traffic opens with two shared system prompts:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch-slots 3 --traffic 4 --prefix-sharing \\
        --kv-spec bits=4,codec=rans [--device cpu]

``--replicas N`` serves the traffic through a fleet of N continuous
engines behind a request router (``--router round-robin`` or
``least-loaded``; one shared weight tree, lockstep drive); ``--disaggregate
P:D`` splits it into P prefill and D decode replicas, the prompt KV
crossing as entropy-coded paged blocks (needs ``--kv-spec``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch-slots 2 --traffic 4 --replicas 2 --disaggregate 1:1 \\
        --kv-spec bits=16 [--device cpu]

Every family of the registry is ported: dense and moe through every mode
above; ssm (mamba2-370m), hybrid (jamba-1.5-large-398b) and encdec
(seamless-m4t-medium, its batch the target tokens and stub frontend
frames) lockstep and dense-resident only, as in the JAX package:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --batch 2 --prompt-len 8 --gen 4 [--device cpu]

``--mesh DxM`` serves one model sharded over a ``data x model`` mesh of
ranks, one process each (``--dist-backend``: ``nccl`` for one card a rank,
``gloo`` on the CPU or for ranks sharing one card): weights rest sharded
along output channels and are all-gathered at use, batch rows (or slots)
split over data, and greedy tokens equal one device's:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --mesh 1x2 --device cpu --dist-backend gloo [--batch-slots 4]

It serves the reduced variant of ``--arch`` (``registry.reduced``), like the
JAX launcher; ``chip_smoke.py`` drives the full width.  Runs on the card
unless ``--device cpu`` is given.

``--production`` dry-runs the full config's serving step of ``--shape``
(default ``decode_32k``) on the 16 x 16 production mesh (``--multi-pod``:
2 x 16 x 16, memory only), priced on H100 terms (``launch/dryrun.py``; it
runs on the host, on ``meta`` tensors):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --production --shape decode_32k
"""
import argparse
import sys
import time

# a spawned world that has not finished in this time is stopped
MESH_TIMEOUT_S = 3600.0


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
    p.add_argument("--kv-spec", default=None, metavar="SPEC",
                   help="with --batch-slots: serve through the paged KV "
                        "block pool under this compression policy, e.g. "
                        "'bits=4,block=16,codec=rans,sharing' (see "
                        "repro_torch.core.spec.KVCompressionSpec; bits=16 "
                        "keeps dense bf16 blocks, bit-identical to the slot "
                        "pool)")
    p.add_argument("--kv-block", type=int, default=0, metavar="B",
                   help="override the paged KV block size (tokens per "
                        "block); implies --kv-spec when given alone")
    p.add_argument("--prefix-sharing", action="store_true",
                   help="share identical prompt-prefix KV blocks across "
                        "requests (implies --kv-spec when given alone, and "
                        "makes --traffic replay shared system prompts)")
    p.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="with --batch-slots: serve through a fleet of N "
                        "data-parallel continuous-batching replicas behind "
                        "a request router (one shared weight tree, lockstep "
                        "drive)")
    p.add_argument("--router", default="round-robin",
                   choices=("round-robin", "least-loaded"),
                   help="fleet placement policy for --replicas")
    p.add_argument("--disaggregate", default=None, metavar="P:D",
                   help="with --replicas: split the fleet into P prefill "
                        "replicas + D decode replicas (P+D = N); finished "
                        "prompt KV ships prefill->decode as entropy-coded "
                        "block payloads, so requires --kv-spec")
    p.add_argument("--mesh", default=None, metavar="DxM",
                   help="serve on a (data, model) mesh of DxM ranks, e.g. "
                        "2x4: weights tensor-parallel over model (QT "
                        "q/scale/zero sharded consistently along output "
                        "channels, gathered at use), batch rows / slots "
                        "over data, placement at load-stream time")
    p.add_argument("--dist-backend", default="nccl",
                   choices=("nccl", "gloo"),
                   help="torch.distributed backend of --mesh: nccl (one "
                        "card a rank), or gloo (the CPU, or ranks sharing "
                        "one card)")
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
    p.add_argument("--production", action="store_true",
                   help="dry-run the full config's serving step on the "
                        "production mesh (launch/dryrun.py)")
    p.add_argument("--shape", default=None,
                   choices=("prefill_32k", "decode_32k", "long_500k"),
                   help="with --production: the input shape (default "
                        "decode_32k)")
    p.add_argument("--multi-pod", action="store_true",
                   help="with --production: the 2x16x16 mesh, memory only")
    args = p.parse_args(argv)
    if args.production:
        if args.mesh:
            p.error("--production dry-runs its own production mesh; drop "
                    "--mesh")
        from repro_torch.launch import dryrun
        d = dryrun.run_cell(args.arch, args.shape or "decode_32k",
                            multi_pod=args.multi_pod,
                            compile_only=args.multi_pod)
        return 0 if "error" not in d else 1
    for flag, given in (("--shape", args.shape is not None),
                        ("--multi-pod", args.multi_pod)):
        if given:
            p.error(f"{flag} applies to --production only")
    args.mesh_dims = None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh_spec
        try:
            args.mesh_dims = parse_mesh_spec(args.mesh)
        except ValueError as e:
            p.error(f"--mesh: {e}")
        if min(args.mesh_dims) < 1:
            p.error(f"--mesh: mesh axes must be >= 1, got {args.mesh}")
    if args.traffic > 0 and args.batch_slots < 1:
        p.error("--traffic replays arrivals through --batch-slots N")
    if args.traffic > 0 and args.mesh:
        p.error("--traffic paces arrivals and sheds on a full queue by each "
                "rank's own clock, but on a --mesh every rank must take the "
                "same admission decisions; drop --traffic (the uniform "
                "--batch wave is admitted alike on every rank) or --mesh")
    if args.fused_impl not in (None, "auto"):
        p.error(f"--fused-impl {args.fused_impl} is not ported yet (the "
                f"port picks the fused kernel by the tensor's device)")
    if args.resident == "compressed":
        if args.mesh:
            p.error("--resident compressed is single-device (per-layer "
                    "decode targets the bandwidth-bound single-accelerator "
                    "regime); drop --mesh or use --resident dense")
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

    # paged KV: parse and validate the policy upfront; the paged pool rides
    # dense residency on one device
    kv_spec = None
    if args.kv_spec is not None or args.kv_block or args.prefix_sharing:
        if args.batch_slots <= 0:
            p.error("--kv-spec/--kv-block/--prefix-sharing require "
                    "--batch-slots (the paged KV cache is a "
                    "continuous-batching feature)")
        if args.resident != "dense":
            p.error("paged KV (--kv-spec) needs --resident dense: the "
                    "compressed-resident per-layer drivers have no paged "
                    "step twins")
        if args.mesh:
            p.error("paged KV (--kv-spec) is single-device today; drop "
                    "--mesh")
        from repro_torch.core.spec import KVCompressionSpec
        overrides = {}
        if args.kv_block:
            overrides["block_size"] = args.kv_block
        if args.prefix_sharing:
            overrides["sharing"] = True
        try:
            kv_spec = KVCompressionSpec.parse(args.kv_spec or "", **overrides)
        except (ValueError, KeyError) as e:
            p.error(f"bad --kv-spec: {e}")
        if kv_spec.sharing and args.prefill_chunk % kv_spec.block_size:
            p.error(f"--prefix-sharing needs --prefill-chunk divisible by "
                    f"the KV block size (chunk {args.prefill_chunk}, block "
                    f"{kv_spec.block_size}): the prefix-skip boundary must "
                    f"be a chunk boundary")

    # fleet flags: the same upfront validation as the JAX launcher; the
    # parsed P:D split rides on args so _serve_fleet sees a tuple, not text
    args.disaggregate_split = None
    if args.disaggregate and args.replicas <= 0:
        p.error("--disaggregate requires --replicas")
    if args.replicas:
        if args.replicas < 1:
            p.error(f"--replicas must be >= 1, got {args.replicas}")
        if args.batch_slots <= 0:
            p.error("--replicas requires --batch-slots (fleet replicas are "
                    "continuous-batching engines)")
        if args.mesh:
            p.error("--replicas is data parallelism over single-device "
                    "engines; the mesh layer shards ONE engine — drop "
                    "--mesh or serve a single replica")
        if args.resident != "dense":
            p.error("--replicas needs --resident dense: the per-layer "
                    "compressed-resident drivers are single-engine today")
        if args.disaggregate:
            try:
                n_pre, n_dec = (int(x) for x in args.disaggregate.split(":"))
            except ValueError:
                p.error(f"bad --disaggregate {args.disaggregate!r}: "
                        f"want P:D, e.g. 1:1")
            if n_pre < 1 or n_dec < 1:
                p.error("--disaggregate needs at least one prefill and one "
                        "decode replica")
            if n_pre + n_dec != args.replicas:
                p.error(f"--disaggregate {args.disaggregate} must sum to "
                        f"--replicas ({args.replicas})")
            if kv_spec is None:
                p.error("--disaggregate requires --kv-spec: the prefill->"
                        "decode handoff ships paged KV blocks entropy-coded "
                        "on the wire")
            args.disaggregate_split = (n_pre, n_dec)

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
    args.compress_spec_parsed = compress_spec
    args.kv_spec_parsed = kv_spec
    if args.mesh_dims is None:
        return _serve(args)
    from repro_torch import device as _device
    from repro_torch.launch import mesh as mesh_lib
    dev = _device.resolve(args.device)
    if args.dist_backend == "nccl" and dev.type != "cuda":
        p.error("--dist-backend nccl runs on cards; ranks on the CPU take "
                "--dist-backend gloo")
    data, model = args.mesh_dims
    rcs = mesh_lib.spawn(_serve_rank, data, model,
                         backend=args.dist_backend, device=str(dev),
                         timeout_s=MESH_TIMEOUT_S, args=(args,), threads=0)
    return max(rcs)


def _serve_rank(mesh, args) -> int:
    """One rank of ``--mesh``: the whole serve, every rank alike; rank 0
    alone prints."""
    import contextlib
    import os
    if mesh.rank == 0:
        return _serve(args, mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _serve(args, mesh)


def _serve(args, mesh=None) -> int:
    """Compress, load and serve (on ``mesh`` when given: this rank's part
    of it)."""
    import numpy as np
    import torch
    from repro_torch import device as _device
    from repro_torch.configs import registry
    from repro_torch.core.store import CompressedModel
    from repro_torch.models import api
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serving import engine

    compress_spec, kv_spec = args.compress_spec_parsed, args.kv_spec_parsed
    dev = mesh.device if mesh is not None else _device.resolve(args.device)
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
        if mesh is not None:
            # default placer profile: per-tensor output-channel TP (exact
            # numerics); the mesh rules steer cache / batch rows in engines
            load_kw["placer"] = engine.make_param_placer(cfg, mesh)
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
    if mesh is not None:
        pb = engine.per_device_bytes(serve_params, mesh)
        lo, hi = min(pb.values()), max(pb.values())
        print(f"mesh {args.mesh_dims[0]}x{args.mesh_dims[1]} (data x model): "
              f"weights placed over {len(pb)} ranks "
              f"[{args.dist_backend}, {dev}], "
              f"{lo/2**20:.1f}-{hi/2**20:.1f} MiB/rank "
              f"({sum(pb.values())/2**20:.1f} MiB total)")

    # slot mode pads prompts to a prefill-chunk multiple, so its cache needs
    # that much headroom; the lockstep path keeps the exact footprint.
    # Prefix-shared traffic prepends a block-aligned system prompt, so the
    # prompt budget grows to cover prefix + at least one unique token.
    kv_prefix_len = 0
    if kv_spec is not None and kv_spec.sharing and args.traffic > 0:
        b = kv_spec.block_size
        kv_prefix_len = max(b, args.prompt_len // (2 * b) * b)
    prompt_budget = max(args.prompt_len, kv_prefix_len + 1)
    headroom = args.prefill_chunk if args.batch_slots > 0 else 0
    sc = engine.ServeConfig(max_len=prompt_budget + args.gen + headroom)
    rng = np.random.default_rng(0)
    if kv_spec is None:
        # true serving peak is weights + KV: the KV term the weight lines
        # above leave out (a paged pool prints its own bytes)
        from repro_torch.serving.kvcache import kv_cache_bytes
        kv_rows = args.batch_slots if args.batch_slots > 0 else args.batch
        kvb = kv_cache_bytes(cfg, kv_rows, sc.max_len)
        print(f"  KV cache {kvb/2**20:.2f} MiB resident "
              f"({kv_rows} x {sc.max_len} bf16 rows) — true serving peak = "
              f"weights + KV")
    if args.batch_slots > 0:
        rc = _serve_continuous(cfg, serve_params, sc, args, rng,
                               load_metrics, dev, kv_spec=kv_spec,
                               kv_prefix_len=kv_prefix_len, mesh=mesh)
        if args.resident == "compressed":
            serve_params.close()
        _write_obs(args, mesh)
        return rc

    eng = engine.Engine(cfg, serve_params, sc, device=dev,
                        resident=args.resident, mesh=mesh)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    if cfg.family == "encdec":
        # the stub frontend's frames, drawn after the tokens from the same
        # generator (the JAX launcher's batch, value for value)
        prompt = {"tokens": prompt,
                  "src_embeds": torch.from_numpy(rng.normal(
                      0, 1, (args.batch, args.prompt_len, cfg.d_model))
                  ).to(torch.bfloat16)}
    out, metrics = eng.generate(prompt, args.gen, echo_metrics=True)
    if args.resident == "compressed":
        serve_params.close()
    ttft = load_metrics["decode_load_s"] + metrics["ttft_s"]
    print(f"generated {tuple(out.shape)} tokens: prefill "
          f"{metrics['prefill_s']:.2f}s, decode {metrics['decode_s']:.2f}s "
          f"({metrics['decode_tok_per_s']:.1f} decode tok/s, "
          f"{metrics['e2e_tok_per_s']:.1f} e2e tok/s); "
          f"time-to-first-token incl. weight load: {ttft:.2f}s")
    _write_obs(args, mesh)
    return 0


def _serve_continuous(cfg, serve_params, sc, args, rng, load_metrics, dev,
                      kv_spec=None, kv_prefix_len=0, mesh=None):
    """--batch-slots path: slot-batched serving of independent requests."""
    import numpy as np
    from repro_torch.obs.metrics import percentile
    from repro_torch.serving.batching import (ContinuousEngine,
                                              QueueFullError, poisson_trace,
                                              replay)

    if args.replicas > 0:
        return _serve_fleet(cfg, serve_params, sc, args, load_metrics, dev,
                            kv_spec=kv_spec, kv_prefix_len=kv_prefix_len)

    ce = ContinuousEngine(cfg, serve_params, sc, n_slots=args.batch_slots,
                          max_queue=args.max_queue,
                          prefill_chunk=args.prefill_chunk,
                          resident=args.resident, kv_spec=kv_spec,
                          device=dev, mesh=mesh)
    if kv_spec is not None:
        print(f"  paged KV [{kv_spec.describe()}]: pool "
              f"{ce.slots.pool_bytes/2**20:.2f} MiB resident "
              f"({ce.slots.n_blocks} x {kv_spec.block_size}-token blocks) — "
              f"true serving peak = weights + KV")
    n = args.traffic if args.traffic > 0 else args.batch
    shed = 0
    t0 = time.monotonic()
    if args.traffic > 0:        # Poisson replay: ragged prompts + gen lengths
        prefix_kw = {}
        if kv_spec is not None and kv_spec.sharing:
            # shared system prompts exercise prefix sharing: 2 distinct
            # block-aligned prefixes, ragged unique suffixes
            prefix_kw = dict(prefix_pool=2, prefix_len=kv_prefix_len)
        trace = poisson_trace(n, rate_per_s=100.0, prompt_max=args.prompt_len,
                              gen_max=args.gen, vocab=cfg.vocab, seed=0,
                              **prefix_kw)
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
    if kv_spec is not None:
        st = ce.slots.stats()
        print(f"  paged KV: prefix hit rate {st['prefix_hit_rate']*100:.0f}% "
              f"({st['shared_hits']} hits / {st['shared_misses']} misses), "
              f"{st['blocks_free']}/{st['blocks_total']} blocks free, cold "
              f"tier {st['cold_bytes']/2**10:.1f} KiB "
              f"({st['cold_evictions']} evictions, {st['cold_restores']} "
              f"restores, {st['dropped_evictions']} dropped)")
    return 0


def _serve_fleet(cfg, serve_params, sc, args, load_metrics, dev,
                 kv_spec=None, kv_prefix_len=0):
    """--replicas path: DP fleet of continuous engines behind the router,
    driven in lockstep (deterministic, and per-request bit-identical to a
    single engine)."""
    from repro_torch.obs.metrics import percentile
    from repro_torch.serving.batching import poisson_trace, replay_fleet
    from repro_torch.serving.fleet import FleetDriver

    split = args.disaggregate_split
    fd = FleetDriver(cfg, serve_params, sc, n_replicas=args.replicas,
                     policy=args.router, n_slots=args.batch_slots,
                     max_queue=args.max_queue,
                     prefill_chunk=args.prefill_chunk,
                     kv_spec=kv_spec, disaggregate=split, devices=[dev])
    wb = fd.weight_bytes()
    topo = (f"{split[0]} prefill + {split[1]} decode, disaggregated"
            if split else f"{args.replicas}x data-parallel")
    print(f"fleet [{topo}; router {args.router}]: "
          f"{wb['copies']} weight cop{'y' if wb['copies'] == 1 else 'ies'} "
          f"resident ({wb['total_bytes']/2**20:.2f} MiB, "
          f"mode {wb['mode']})")
    n = args.traffic if args.traffic > 0 else args.batch
    prefix_kw = {}
    if kv_spec is not None and kv_spec.sharing:
        prefix_kw = dict(prefix_pool=2, prefix_len=kv_prefix_len)
    trace = poisson_trace(n, rate_per_s=100.0, prompt_max=args.prompt_len,
                          gen_max=args.gen, vocab=cfg.vocab, seed=0,
                          **prefix_kw)
    t0 = time.monotonic()
    replay_fleet(fd, trace, shed_on_full=True)
    span = time.monotonic() - t0
    fin = fd.finished
    n_shed = len(fd.shed)
    if not fin:
        print(f"fleet: no requests completed ({n_shed} shed)")
        return 1
    toks = sum(len(r.output) for r in fin)
    ttft = [r.ttft_s for r in fin]
    lat = [r.latency_s for r in fin]
    per_replica = ", ".join(
        f"r{h.idx}[{h.state.name.lower()}] "
        f"{sum(len(r.output) for r in h.engine.finished)} tok"
        for h in fd.replicas)
    print(f"fleet serve: {len(fin)}/{n} requests"
          + (f" ({n_shed} shed)" if n_shed else "")
          + f", {toks} tok in {span:.2f}s = "
          f"{toks/max(span, 1e-9):.1f} tok/s aggregate")
    print(f"  per replica: {per_replica}")
    print(f"  ttft p50 {percentile(ttft, 50)*1e3:.0f}ms "
          f"p99 {percentile(ttft, 99)*1e3:.0f}ms "
          f"(+{load_metrics['decode_load_s']:.2f}s weight load) | "
          f"latency p50 {percentile(lat, 50)*1e3:.0f}ms "
          f"p99 {percentile(lat, 99)*1e3:.0f}ms | {fd.n_steps} fleet steps")
    if fd.handoff is not None:
        print(f"  handoff: {fd.handoff.n_handoffs} prefill->decode "
              f"payloads, {fd.handoff.bytes_on_wire/2**10:.1f} KiB "
              f"entropy-coded on the wire")
    return 0


def _write_obs(args, mesh=None):
    """Export the trace / metrics-registry snapshot the serve recorded
    (rank 0's on a mesh)."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    if mesh is not None and mesh.rank != 0:
        return
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
