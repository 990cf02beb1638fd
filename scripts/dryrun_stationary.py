#!/usr/bin/env python3
"""The weight-stationary decode in the CPU dry-run: each dense and MoE
config's ``decode_32k`` cell on the 16 x 16 production mesh, built with
``serve_mode="stationary"`` (``launch.specs.build_decode_cell``: rows whole
on every rank, the features over the data axes, no weight gathered) and
priced by ``launch.dryrun.run_cell``.  The default layout of the same cells
is ``python -m repro_torch.launch.dryrun --all``'s.

Prints each cell as the dry-run prints it, then one JSON line a cell: the
peak and argument bytes a rank, FLOPs a chip, each collective kind's wire
bytes, the three terms and the bounding one.  A dry-run counts on the CPU;
it times nothing.

    PYTHONPATH=src python3 scripts/dryrun_stationary.py [--arch A ...]
"""
import argparse
import json

from repro_torch.configs import registry
from repro_torch.launch import dryrun, roofline
from repro_torch.serving.engine import EXACT_TP_FAMILIES


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", action="append", default=None,
                   help="a config name (repeatable); every dense and MoE "
                        "config by default")
    args = p.parse_args()
    archs = args.arch or [a for a, c in registry.ARCHS.items()
                          if c.family in EXACT_TP_FAMILIES]
    for a in archs:
        d = dryrun.run_cell(a, "decode_32k", serve_mode="stationary")
        ma = d["memory_analysis"]
        print(json.dumps({
            "arch": a, "shape": d["shape"], "mesh": d["mesh"],
            "serve_mode": d["meta"].get("serve_mode"),
            "peak_bytes": ma["peak"], "argument_bytes": ma["argument_size"],
            "fits": d["fits"], "flops_per_chip": d["flops_per_chip"],
            "wire_bytes": {k: d["collective_detail"][k]
                           for k in roofline.KINDS},
            "compute_s": d["compute_s"], "memory_s": d["memory_s"],
            "collective_s": d["collective_s"], "dominant": d["dominant"],
            "flops_ratio": d["flops_ratio"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
