"""Training launcher of the PyTorch port (``repro/launch/train.py``).

Two modes:

* default — real steps of the reduced config of ``--arch`` on one device,
  with the data pipeline, AdamW, checkpoints and watchdogs; on the card
  unless ``--device cpu`` is given;
* ``--production`` — the dry-run of the full config's train step of
  ``--shape`` (default ``train_4k``) on the 16 x 16 production mesh
  (``--multi-pod``: 2 x 16 x 16, memory only), priced on H100 terms
  (``launch/dryrun.py``; on the host, on ``meta`` tensors).

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 50 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --production --shape train_4k
"""
import argparse
import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--grad-compress", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; raises "
                        "when no card is present)")
    p.add_argument("--production", action="store_true",
                   help="dry-run the full config's train step on the "
                        "production mesh (launch/dryrun.py)")
    p.add_argument("--shape", default=None,
                   help="with --production: the input shape (default "
                        "train_4k)")
    p.add_argument("--multi-pod", action="store_true",
                   help="with --production: the 2x16x16 mesh, memory only")
    args = p.parse_args(argv)

    if args.production:
        from repro_torch.launch import dryrun
        d = dryrun.run_cell(args.arch, args.shape or "train_4k",
                            multi_pod=args.multi_pod,
                            compile_only=args.multi_pod)
        return 0 if "error" not in d else 1
    for flag, given in (("--shape", args.shape is not None),
                        ("--multi-pod", args.multi_pod)):
        if given:
            p.error(f"{flag} applies to --production only")

    from repro_torch import device as _device
    from repro_torch.checkpoint.checkpointer import (CheckpointConfig,
                                                     Checkpointer)
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.distributed.fault_tolerance import (CheckpointHook,
                                                         NanWatchdog,
                                                         StepTimeWatchdog)
    from repro_torch.models import api
    from repro_torch.training import optimizer as opt, train_loop

    dev = _device.resolve(args.device)
    cfg = registry.reduced(registry.get(args.arch))
    params = api.build(cfg).init(cfg, 0, dev)
    tc = train_loop.TrainConfig(
        opt=opt.AdamWConfig(schedule=opt.Schedule(
            base_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
            total_steps=args.steps)),
        microbatches=args.microbatches,
        grad_compress=args.grad_compress)
    state = opt.init_state(tc.opt, params)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.batch,
                    src_embed_dim=cfg.d_model if cfg.family == "encdec" else 0)
    src = SyntheticSource(dc)

    hooks = []
    watchdog = StepTimeWatchdog()
    hooks.append(lambda i, p, s, m: watchdog.tick(i) and None)
    if args.checkpoint_dir:
        ck = Checkpointer(CheckpointConfig(root=args.checkpoint_dir))
        hooks.append(CheckpointHook(ck, args.checkpoint_every))
        hooks.append(NanWatchdog(ck, (params, state), device=dev))

    params, state, info = train_loop.train(
        cfg, tc, params, state, iter(src), args.steps, hooks=tuple(hooks))
    h = info["history"]
    print(f"arch={cfg.name} steps={args.steps} "
          f"loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
          f"({info['steps_per_s']:.2f} steps/s)")
    if args.checkpoint_dir:
        ck.save(args.steps, (params, state))
        print(f"final checkpoint -> {args.checkpoint_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
