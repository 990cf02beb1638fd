#!/usr/bin/env python3
"""Time the port's decode kernels, fused decode→dequant→matmul kernels and
dequant→matmul kernel.

Decode: the load path's shape, 8 streams of 65,536 symbols, over the
placements of the tables: tANS on rANS-4 and rANS-8 symbols at
``table_log`` 10, 12 and 14 (a block's shared memory), 15 and 16 (a
global-memory copy), and Huffman-8 through the prefix kernel; each case is
held bitwise against the symbols it encodes.

Fused: qwen3-1.7b's four fused layer matrices as compressed-resident
serving lays them out, 65,536-symbol lanes packed to a power-of-two width:
``wo`` Huffman-8 2048 x 2048 (the prefix kernel), ``wq`` 2048 x 2048,
``wk`` 2048 x 1024 and ``w_down`` 6144 x 2048 rANS-4 (the tANS kernel), at
M = 4 and 128 rows of x; each held within 1e-2 of x @ deq(symbols).

Dequant: ``kernels.dequant_matmul`` at the 18 (case, M) pairs of
``chip_smoke.py``'s ``dequant_matmul`` phase, on synthetic symbols: layer
0's seven matrices (uint4 packed along K, ``wo`` uint8), ``lm_head``
(uint8, 2048 x 152064) and ``w_down`` again with a per-channel affine, at
M = 4 and 128; each held within 1e-2 of the plain version.  A row gives
the plan the launch ran (variant, rows a tile, splits, as the wrapper
recorded it), the mean of ``DQ_LAUNCHES`` cold launches paced by the host
(L2 flushed by a 256 MB write before each, ``cold_paced_ms``: the ``ms``
of ``chip_smoke.py``'s rows), and its time cold (``cold_ms``) and warm
(``queued_ms``) with each launch timed alone and all queued behind a spin
kernel (the host's launch path excluded), each as the median, mean, least
and most of ``DQ_LAUNCHES`` launches, and the same queued cold statistics
of ``torch.matmul`` on the weight dequantized to bf16 beforehand (a
floor, not the same function).

Each decode or fused case prints one JSON line: ms a launch paced by the
host (CUDA events around launches the host issues one after another, as
``chip_smoke.py`` times every kernel), ms a launch queued behind a spin
kernel (device time only), and, where the kernels record them, the sync
passes and the SM cycles of the longest block (over the symbols of a
stream or lane: cycles a step of the tANS chain).  The first line is the
card's name and power limit.  Needs an NVIDIA card:

    PYTHONPATH=src python3 scripts/time_decode_kernels.py
    python3 scripts/time_decode_kernels.py --src OTHER/src --label parent
    python3 scripts/time_decode_kernels.py --only dequant

``--src`` runs another checkout's port (an unpacked older commit, say)
through the same cases, so two versions are compared on one card in one
call; its kernels build under that checkout's ``build/``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = [("rans", 4, log) for log in (10, 12, 14, 15, 16)] + \
        [("rans", 8, log) for log in (12, 16)] + [("huffman", 8, None)]
STREAMS, SYMBOLS, LAUNCHES = 8, 65536, 20
FUSED = [("wo", "huffman", 8, 2048, 2048), ("wq", "rans", 4, 2048, 2048),
         ("wk", "rans", 4, 2048, 1024), ("w_down", "rans", 4, 6144, 2048)]
FUSED_M, FUSED_TOL = (4, 128), 1e-2
# (tensor, K, N, int4, per-channel affine): chip_smoke.py's dequant cases
DQ = [("layers/wq", 2048, 2048, True, False),
      ("layers/wk", 2048, 1024, True, False),
      ("layers/wv", 2048, 1024, True, False),
      ("layers/wo", 2048, 2048, False, False),
      ("layers/w_gate", 2048, 6144, True, False),
      ("layers/w_up", 2048, 6144, True, False),
      ("layers/w_down", 6144, 2048, True, False),
      ("lm_head", 2048, 152064, False, False),
      ("layers/w_down", 6144, 2048, True, True)]
DQ_M, DQ_TOL, DQ_LAUNCHES = (4, 128), 1e-2, 25


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("decode", "fused", "dequant"),
                    help="time only this family")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    from chip_smoke import smi

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    dev = torch.device("cuda")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    print(smi("name,power.limit"), flush=True)
    rng = np.random.default_rng(args.seed)
    if args.only in (None, "decode"):
        time_decode(args, dev, clock_mhz, rng)
    if args.only in (None, "fused"):
        for tensor, codec, bits, K, N in FUSED:
            time_fused(args, dev, clock_mhz, rng, tensor, codec, bits, K, N)
    if args.only in (None, "dequant"):
        time_dequant(args, dev, clock_mhz, rng)


def time_decode(args, dev, clock_mhz, rng):
    """Both decode kernels over the table placements of ``CASES``."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, cuda_ms_queued
    import repro_torch
    from repro_torch.core import bitstream
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels import ans_decode, huffman_decode

    for codec, bits, log in CASES:
        hi = 1 << bits
        sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, (STREAMS, SYMBOLS))),
                      0, hi - 1).astype(np.uint8)
        kw = {} if log is None else {"table_log": log}
        table = get_codec(codec).build(np.bincount(sym.ravel(), minlength=hi),
                                       bits, **kw)
        mat, _ = bitstream.pack_streams([table.encode(s)[0] for s in sym])
        a = table.decode_arrays()
        m = torch.from_numpy(mat).to(dev)
        c = torch.full((STREAMS,), SYMBOLS, dtype=torch.int32, device=dev)
        if table.kernel == "prefix":
            tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                    for k in ("lut_sym", "lut_len")]
            entry, tlog = "prefix_decode", table.peek_bits

            def fn():
                return huffman_decode.decode_streams(
                    m, c, *tabs, max_len=tlog, max_count=SYMBOLS)
        else:
            tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                    for k in ("tab_sym", "tab_bits", "tab_base")]
            entry, tlog = "tans_decode", table.table_log

            def fn():
                return ans_decode.decode_streams_tans(
                    m, c, *tabs, table_log=tlog, max_count=SYMBOLS)
        got = fn()
        torch.cuda.synchronize()
        equal = np.array_equal(got.cpu().numpy(), sym)
        queued_ms, _ = cuda_ms_queued(fn, LAUNCHES, clock_mhz)
        ms, _ = cuda_ms(fn, LAUNCHES)
        row = dict(label=args.label, src=str(Path(repro_torch.__file__)
                                             .resolve().parents[1]),
                   entry_point=entry, codec=f"{codec}{bits}", table_log=tlog,
                   shape=[STREAMS, int(mat.shape[1]), SYMBOLS],
                   bitwise_equal=equal, ms=ms, device_queued_ms=queued_ms,
                   launches=LAUNCHES)
        if hasattr(huffman_decode, "launch_stats"):
            passes, cycles = huffman_decode.launch_stats(entry, dev)
            row.update(block_cycles=cycles, cycles_per_step=cycles / SYMBOLS,
                       sync_passes=passes)
        print(json.dumps(row), flush=True)
        if not equal:
            sys.exit(f"{entry} at {codec}{bits} differs from its symbols")


def time_fused(args, dev, clock_mhz, rng, tensor, codec, bits, K, N):
    """One fused layer matrix at each M of ``FUSED_M``."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, cuda_ms_queued
    import repro_torch
    from repro_torch.core import bitstream
    from repro_torch.core.codecs import get_codec
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq

    hi = 1 << bits
    sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, K * N)), 0,
                  hi - 1).astype(np.uint8)
    table = get_codec(codec).build(np.bincount(sym, minlength=hi), bits)
    streams = [table.encode(sym[i:i + SYMBOLS])[0]
               for i in range(0, sym.size, SYMBOLS)]
    width = bitstream.pow2_bucket(max(s.size for s in streams), 64)
    mat, _ = bitstream.pack_streams(streams, min_width=width)
    scale = np.float32(0.004 + 0.004 * rng.random())
    zero = np.float32(-0.03)
    fq = fdm.build_fused_qt(table, mat, scale, zero, seg_symbols=SYMBOLS,
                            K=K, N=N, bits=bits, device=dev)
    w = deq(QT(torch.from_numpy(sym.reshape(K, N)).to(dev), fq.scale,
               fq.zero))
    entry = f"fused_{fq.family}_matmul"
    for M in FUSED_M:
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(
            np.float32)).to(dev, torch.bfloat16)

        def fn():
            return fdm.fused_decode_matmul(x, fq)
        got = fn()
        torch.cuda.synchronize()
        err = float((got.float() - (x @ w).float()).abs().max())
        close = bool(torch.allclose(got.float(), (x @ w).float(),
                                    atol=FUSED_TOL, rtol=FUSED_TOL))
        queued_ms, _ = cuda_ms_queued(fn, LAUNCHES, clock_mhz)
        ms, _ = cuda_ms(fn, LAUNCHES)
        row = dict(label=args.label, src=str(Path(repro_torch.__file__)
                                             .resolve().parents[1]),
                   entry_point=entry, tensor=tensor, codec=f"{codec}{bits}",
                   table_bits=fq.tbits, shape=[M, K, N],
                   lanes=int(fq.mat.shape[0]), lane_bytes=int(width),
                   max_abs_err=err, allclose=close, ms=ms,
                   device_queued_ms=queued_ms, launches=LAUNCHES)
        if hasattr(fdm, "launch_stats"):
            passes, cycles = fdm.launch_stats(entry, dev)
            row.update(block_cycles=cycles, cycles_per_step=cycles / SYMBOLS,
                       sync_passes=passes)
        print(json.dumps(row), flush=True)
        if not close:
            sys.exit(f"{entry} at {tensor} M={M} differs from x @ deq by "
                     f"{err}")


def stats(ms):
    import statistics
    return dict(median=statistics.median(ms), mean=statistics.fmean(ms),
                min=min(ms), max=max(ms), n=len(ms))


def time_dequant(args, dev, clock_mhz, rng):
    """``dequant_matmul`` at the (case, M) pairs of ``DQ`` x ``DQ_M``."""
    import numpy as np
    import torch
    from chip_smoke import (BF16_FLOPS_PER_S, HBM_BYTES_PER_S,
                            SCALAR_OPS_PER_S, cuda_ms_cold, queued_launch_ms)
    import repro_torch
    from repro_torch.kernels import dequant_matmul as dm

    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    for tensor, K, N, int4, per_channel in DQ:
        q = torch.from_numpy(rng.integers(0, 16 if int4 else 256, (K, N),
                                          dtype=np.uint8)).to(dev)
        wq = (q[0::2] | (q[1::2] << 4)).contiguous() if int4 else q
        if per_channel:
            scale = torch.from_numpy(rng.uniform(0.002, 0.006, N).astype(
                np.float32)).to(dev)
            zero = torch.from_numpy(rng.uniform(-0.04, -0.02, N).astype(
                np.float32)).to(dev)
        else:
            scale = torch.tensor(0.004, dtype=torch.float32, device=dev)
            zero = torch.tensor(-0.03, dtype=torch.float32, device=dev)
        w_bf16 = (q.float() * scale.reshape(1, -1)
                  + zero.reshape(1, -1)).to(torch.bfloat16)
        del q
        for M in DQ_M:
            x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(
                np.float32)).to(dev, torch.bfloat16)

            def fn():
                return dm.dequant_matmul(x, wq, scale, zero, int4=int4)
            got = fn()
            # the plan this launch ran (a parent checkout may record none)
            p = dm.launch_plan(dev) if hasattr(dm, "launch_plan") else None
            ref = dm.dequant_matmul_plain(x, wq, scale, zero, int4=int4)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            close = bool(torch.allclose(got.float(), ref.float(),
                                        atol=DQ_TOL, rtol=DQ_TOL))
            del ref
            # each input read once, the output written once; the MMA's
            # FLOPs and the dequant's multiply and add a weight
            nbytes = (2 * M * K + wq.numel() + 4 * (scale.numel()
                                                    + zero.numel()) + 2 * M * N)
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 2 * M * K * N / BF16_FLOPS_PER_S
                                 + 2 * K * N / SCALAR_OPS_PER_S)
            paced = cuda_ms_cold(fn, DQ_LAUNCHES, flush)
            cold = queued_launch_ms(fn, DQ_LAUNCHES, clock_mhz, flush)
            queued = queued_launch_ms(fn, DQ_LAUNCHES, clock_mhz)
            dense = queued_launch_ms(lambda: torch.matmul(x, w_bf16),
                                     DQ_LAUNCHES, clock_mhz, flush)
            row = dict(label=args.label, src=str(Path(repro_torch.__file__)
                                                 .resolve().parents[1]),
                       entry_point="dequant_matmul", tensor=tensor,
                       weight="uint4 packed along K" if int4 else "uint8",
                       affine="per-channel" if per_channel else "per-tensor",
                       shape=[M, K, N], max_abs_err=err, allclose=close,
                       bound_ms=bound_ms, cold_paced_ms=paced,
                       cold_ms=stats(cold),
                       queued_ms=stats(queued),
                       dense_bf16_matmul_cold_ms=stats(dense))
            if p is not None:
                row.update(variant=p.variant, bm=p.bm, splits=p.splits,
                           k_per_split=p.k_per_split, blocks=p.blocks,
                           workspace_bytes=p.workspace_bytes)
            print(json.dumps(row), flush=True)
            if not close:
                sys.exit(f"dequant_matmul at {tensor} M={M} differs from "
                         f"its plain version by {err}")
        del w_bf16


if __name__ == "__main__":
    main()
