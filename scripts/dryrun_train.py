#!/usr/bin/env python3
"""The ``train_4k`` cells in the CPU dry-run (the dense and MoE configs by
default, any other named with ``--arch``): each config's train step on
the 16 x 16 production mesh (``launch.specs.build_train_cell`` as
``launch.dryrun.run_cell`` builds it), once a ``--q8-gather`` value,
priced on H100 terms.  The cells run in a pool of ``--workers`` host
processes; a dry-run counts on the CPU and times nothing.

Prints one JSON line a cell: the compute mode (``meta["compute"]``), the
peak and argument bytes a rank, FLOPs a chip, each collective kind's wire
bytes, the three terms and the bounding one, ``flops_ratio``, and the
bytes the all-gathers over the data axis moved a rank by element type
(the FSDP gathers; ``null`` where the records name no axis).

    PYTHONPATH=src python3 scripts/dryrun_train.py [--arch A ...] \\
        [--q8-gather 0 8] [--workers 4]
"""
import argparse
import concurrent.futures as cf
import json
import multiprocessing as mp


def one(arch: str, q8: int) -> dict:
    from repro_torch.launch import dryrun, roofline
    stash = []
    real = dryrun.count

    def count(cell):
        got = real(cell)
        stash.append(got["records"])
        return got
    dryrun.count = count
    kw = {"q8_gather": q8} if q8 else {}
    d = dryrun.run_cell(arch, "train_4k", verbose=False, **kw)
    data = None
    if stash and all("axis" in r for r in stash[0]):
        data = {}
        for r in stash[0]:
            if r["kind"] == "all-gather" and r["axis"] in ("pod", "data"):
                data[r["dtype"]] = data.get(r["dtype"], 0) + r["bytes"]
    ma = d["memory_analysis"]
    return {"arch": arch, "shape": d["shape"], "mesh": d["mesh"],
            "compute": d["meta"].get("compute", "exact TP"),
            "q8_gather": q8, "peak_bytes": ma["peak"],
            "argument_bytes": ma["argument_size"], "fits": d["fits"],
            "flops_per_chip": d["flops_per_chip"],
            "wire_bytes_per_chip": d["wire_bytes_per_chip"],
            "wire_by_kind": {k: d["collective_detail"][k]
                             for k in roofline.KINDS},
            "counts": d["collective_detail"]["counts"],
            "compute_s": d["compute_s"], "memory_s": d["memory_s"],
            "collective_s": d["collective_s"], "dominant": d["dominant"],
            "step_s": d["step_s"], "flops_ratio": d["flops_ratio"],
            "data_all_gather_bytes": data, "host_s": d["run_s"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", action="append", default=None,
                   help="a config name (repeatable); every dense and MoE "
                        "config by default")
    p.add_argument("--q8-gather", type=int, nargs="+", default=[0, 8])
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args()
    from repro_torch.configs import registry
    archs = args.arch or [a for a, c in registry.ARCHS.items()
                          if c.family in ("dense", "moe")]
    jobs = [(a, q) for a in archs for q in args.q8_gather]
    with cf.ProcessPoolExecutor(args.workers,
                                mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(one, a, q) for a, q in jobs]
        for f in futs:
            print(json.dumps(f.result()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
