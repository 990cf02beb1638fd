"""Production dry-run on H100 terms (PyTorch port of
``repro/launch/dryrun.py``): every (architecture x input shape) cell on the
16 x 16 and 2 x 16 x 16 production meshes, priced by the roofline terms.

The JAX package compiles each cell for 512 placeholder devices and reads
the compiler's memory and cost analyses.  The port has no compiler to ask:
it runs **its own per-rank program** — rank 0 of the production mesh, in
this one process, on ``meta`` tensors (shapes and dtypes, no data) — over a
world of 256 or 512 ranks on the ``fake`` backend (``mesh.fake_world``),
and counts what that program does:

* FLOPs, with ``torch.utils.flop_counter.FlopCounterMode``;
* bytes: the arguments this rank holds, and the peak of everything live —
  a ``TorchDispatchMode`` that follows every storage an op creates until
  it is freed (each storage once, however many views share it);
* the operand and result bytes of every op (views excluded);
* every collective ``distributed/collectives.py`` issues (kind, bytes,
  group, inside a node or across), priced by ``launch/roofline.py``.

Every layer and every microbatch runs, so nothing is extrapolated.  A cell
``fits`` when its peak is at most one H100's memory
(``mesh.HBM_PER_CHIP``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

``--out`` appends machine-readable JSON and skips the cells it holds
already.  ``--multi-pod`` proves memory only (``compile_only``), as in the
JAX package: the roofline table is single-pod.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig, SHAPES
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import Sharded
from repro_torch.launch import mesh as mesh_lib, roofline, specs


class _Bytes(TorchDispatchMode):
    """Live bytes of the storages created under the mode (``meta`` ones by
    default), their peak, and the operand and result bytes of every op
    that is not a view.  Storages that existed before (``known``: the
    arguments) are never counted as new."""

    def __init__(self, known, device_type: str = "meta"):
        super().__init__()
        self.known = set(known)
        self.live: Dict[int, int] = {}
        self.cur = self.peak = 0
        self.touched = 0
        self.device_type = device_type

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat((out,))
        if not func.is_view:
            self.touched += sum(t.numel() * t.element_size()
                                for t in _flat(args) + _flat(kwargs.values())
                                + outs)
        for t in outs:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, key)
        return out


def _flat(xs) -> list:
    """The tensors of an op's arguments or results (one level of lists)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _tensors(tree) -> list:
    """Every tensor of a tree of dicts, tuples, QT / Sharded leaves."""
    if isinstance(tree, Sharded):
        return [tree.local]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storage_bytes(tensors) -> Tuple[int, set]:
    keys, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in keys:
            keys.add(st._cdata)
            total += st.nbytes()
    return total, keys


def count(cell: specs.Cell) -> Dict[str, Any]:
    """Run the cell's step once on its ``meta`` arguments and count: FLOPs,
    argument / output / peak bytes, operand and result bytes, collective
    records."""
    from torch.utils.flop_counter import FlopCounterMode
    arg_bytes, keys = _storage_bytes(_tensors(cell.args))
    with collectives.recording() as records, \
            FlopCounterMode(display=False) as fc, _Bytes(keys) as tr:
        out = cell.run()
        out_bytes = sum(tr.live.get(t.untyped_storage()._cdata, 0)
                        for t in {id(t): t for t in _tensors(out)}.values())
        del out
    return {"flops": float(fc.get_total_flops()), "args": arg_bytes,
            "output": out_bytes, "temp_peak": tr.peak,
            "peak": arg_bytes + tr.peak, "touched": float(tr.touched),
            "records": records}


def _mesh_name(shape: Tuple[int, ...]) -> str:
    return "x".join(str(s) for s in shape)


def _skipped(arch: str, shape_name: str, mesh: str) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape_name, "mesh": mesh,
            "skipped": "requires sub-quadratic attention"}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             weights: str = "int8", verbose: bool = True,
             compile_only: bool = False, cfg: Optional[ArchConfig] = None,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             batch: Optional[int] = None, **kw) -> Dict[str, Any]:
    """Dry-run one cell: build rank 0's step on the production mesh (or on
    ``mesh_shape``, axes ``("data", "model")``), run it on ``meta`` under
    the counters, and price it.  Returns the roofline record
    (``Roofline.to_dict``) with ``fits`` (peak at most ``HBM_PER_CHIP``);
    ``compile_only`` returns the memory part alone.

    ``cfg`` replaces the registry's config of ``arch`` (a reduced one in
    tests) and ``batch`` the shape's global batch (a per-data-rank share of
    it on a smaller mesh); ``kw`` goes to ``specs.build_cell``
    (``serve_mode=`` of a decode cell)."""
    cfg = cfg or registry.get(arch)
    shape = SHAPES[shape_name]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    if mesh_shape is None:
        mshape = mesh_lib.PRODUCTION_SHAPES[multi_pod]
        names = mesh_lib.PRODUCTION_AXES[multi_pod]
    else:
        mshape = tuple(mesh_shape)
        names = mesh_lib.PRODUCTION_AXES[len(mshape) == 3]
    if not shape.applicable(cfg):
        return _skipped(arch, shape_name, _mesh_name(mshape))
    t0 = time.perf_counter()
    with mesh_lib.fake_world(math.prod(mshape)):
        mesh = mesh_lib.make_mesh(mshape, names)
        cell = specs.build_cell(cfg, shape, mesh, weights=weights, **kw)
        got = count(cell)
    run_s = time.perf_counter() - t0
    chips = math.prod(mshape)
    mem = {"argument_size": got["args"], "output_size": got["output"],
           "temp_size": got["temp_peak"], "peak": got["peak"]}
    fits = got["peak"] <= mesh_lib.HBM_PER_CHIP
    meta = {k: v for k, v in cell.meta.items() if k != "mesh"}
    if compile_only:
        d = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mshape),
             "kind": cell.meta["kind"], "compile_only": True,
             "memory_analysis": mem, "fits": fits, "run_s": run_s,
             "meta": meta}
        if verbose:
            print(f"== {arch} x {shape_name} on {d['mesh']} (memory only) "
                  f"== args={got['args'] / 2**30:.2f}GiB "
                  f"peak={got['peak'] / 2**30:.2f}GiB fits={fits} "
                  f"[{run_s:.0f}s]", flush=True)
        return d
    detail = roofline.collective_detail(got["records"])
    wire = sum(detail[k] for k in roofline.KINDS)
    r = roofline.Roofline(
        arch=arch, shape=shape_name, mesh=_mesh_name(mshape),
        kind=cell.meta["kind"], chips=chips, flops_per_chip=got["flops"],
        raw_bytes_per_chip=got["touched"],
        analytic_bytes_per_chip=roofline.analytic_hbm_bytes(
            cfg, shape, cell.meta, chips),
        wire_bytes_per_chip=wire, collective_detail=detail,
        memory_analysis=mem, meta=meta,
        model_flops=roofline.model_flops(cfg, shape, cell.meta["kind"]))
    d = r.to_dict()
    d["fits"] = fits
    d["run_s"] = run_s
    if batch is not None:
        d["global_batch"] = batch
    if verbose:
        print_cell(d)
    return d


def run_on_device(arch: str, shape_name: str, *, device, batch: int,
                  cfg: Optional[ArchConfig] = None, steps: int = 1,
                  weights: str = "int8", seed: int = 0) -> Dict[str, Any]:
    """The dry-run's prediction held against a real run: dry-run the cell of
    ``shape_name`` at ``batch`` rows on a 1 x 1 mesh (one data rank's share
    of a production cell, ``model`` at 1), then run the same step on
    ``device`` (a card) with real random arguments of the same shapes
    (``Cell.materialize``), ``steps`` times.  Returns the dry-run's record
    beside the measured peak (bytes allocated above what was allocated
    before the arguments) and the measured step seconds."""
    cfg = cfg or registry.get(arch)
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=batch)
    dev = torch.device(device)
    with mesh_lib.fake_world(1):
        mesh = mesh_lib.make_mesh((1, 1), mesh_lib.PRODUCTION_AXES[False])
        cell = specs.build_cell(cfg, shape, mesh, weights=weights)
        got = count(cell)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        args = cell.materialize(dev, seed)
        times, finite = [], True
        for _ in range(steps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
            logits = out[0]
            finite = finite and bool(torch.isfinite(logits).all())
            logits_shape = tuple(logits.shape)
            del out, logits
        peak = torch.cuda.max_memory_allocated(dev) - base
        del args
    chips = 1
    r = roofline.Roofline(
        arch=arch, shape=shape_name, mesh="1x1", kind=cell.meta["kind"],
        chips=chips, flops_per_chip=got["flops"],
        raw_bytes_per_chip=got["touched"],
        analytic_bytes_per_chip=roofline.analytic_hbm_bytes(
            cfg, shape, cell.meta, chips),
        wire_bytes_per_chip=0.0,
        collective_detail=roofline.collective_detail(got["records"]),
        memory_analysis={"argument_size": got["args"],
                         "output_size": got["output"],
                         "temp_size": got["temp_peak"], "peak": got["peak"]},
        meta={k: v for k, v in cell.meta.items() if k != "mesh"},
        model_flops=roofline.model_flops(cfg, shape, cell.meta["kind"]))
    return dict(r.to_dict(), global_batch=batch, measured_peak=peak,
                measured_step_s=times, logits_finite=finite,
                logits_shape=logits_shape)


def print_cell(d: Dict[str, Any]) -> None:
    ma = d["memory_analysis"]
    mode = d["meta"].get("serve_mode")
    compute = d["meta"].get("compute") or (
        "sharded" if d["meta"].get("sharded_compute") else None)
    q8g = d["meta"].get("q8_gather")
    print(f"== {d['arch']} x {d['shape']} on {d['mesh']} ({d['kind']}, "
          f"weights={d['meta'].get('weights')}"
          + (f", {mode}" if mode else "")
          + (f", {compute} compute" if compute else "")
          + (f", q8_gather={q8g}" if q8g else "")
          + (", grad_compress" if d["meta"].get("grad_compress") else "")
          + ") ==")
    print(f"  per rank: args={ma['argument_size'] / 2**30:.2f}GiB "
          f"peak={ma['peak'] / 2**30:.2f}GiB fits={d['fits']} "
          f"(H100 {mesh_lib.HBM_PER_CHIP / 2**30:.2f}GiB)")
    print(f"  flops/rank={d['flops_per_chip']:.3e} "
          f"op_bytes/rank={d['raw_bytes_per_chip']:.3e} "
          f"analytic_bytes/rank={d['analytic_bytes_per_chip']:.3e} "
          f"wire_bytes/rank={d['wire_bytes_per_chip']:.3e}")
    cd = d["collective_detail"]
    print("  collectives:", {k: f"{cd[k]:.2e}" for k in roofline.KINDS
                             if cd[k]},
          "counts:", {k: v for k, v in cd["counts"].items() if v},
          f"nvlink={cd['nvlink_bytes']:.2e} ib={cd['ib_bytes']:.2e}")
    print(f"  terms: compute={d['compute_s'] * 1e3:.2f}ms "
          f"memory={d['memory_s'] * 1e3:.2f}ms "
          f"collective={d['collective_s'] * 1e3:.2f}ms "
          f"-> dominant={d['dominant']}")
    print(f"  model_flops_ratio={d['flops_ratio']:.3f} "
          f"run={d['run_s']:.1f}s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--weights", default="int8",
                   choices=["bf16", "int8", "int4"])
    p.add_argument("--out", default=None)
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    if args.list:
        for a, s, ok in specs.all_cells(registry.ARCHS):
            print(f"{a:24s} {s:12s} "
                  f"{'ok' if ok else 'SKIP (full attention @500k)'}")
        return 0

    if args.all:
        cells = [(a, s) for a, s, _ in specs.all_cells(registry.ARCHS)]
    else:
        if not (args.arch and args.shape):
            p.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    existing = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    done = {(d.get("arch"), d.get("shape"), d.get("mesh"))
            for d in existing if "error" not in d}

    results = list(existing)
    failures = n_run = 0
    for mp in meshes:
        mesh_name = _mesh_name(mesh_lib.PRODUCTION_SHAPES[mp])
        for a, s in cells:
            if (a, s, mesh_name) in done:
                continue
            n_run += 1
            try:
                # the multi-pod pass proves memory; the roofline table is
                # single-pod, as in the JAX package
                results.append(run_cell(a, s, multi_pod=mp,
                                        weights=args.weights,
                                        compile_only=mp))
            except Exception as e:
                failures += 1
                traceback.print_exc()
                results.append({"arch": a, "shape": s, "mesh": mesh_name,
                                "error": str(e)})
            if args.out:          # checkpoint the sweep after every cell
                _write(args.out, results)
    if args.out:
        _write(args.out, results)
        print(f"wrote {len(results)} cells ({n_run} new) -> {args.out}")
    print(f"{n_run - failures}/{n_run} newly-run cells OK")
    return 1 if failures else 0


def _write(path: str, results) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
