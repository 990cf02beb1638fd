"""Serving meshes over ``torch.distributed`` process groups (PyTorch port of
``repro/launch/mesh.py``).

The JAX package runs one controller over a global-view device mesh.  The
port runs one process per mesh position (a *rank*), SPMD style: every rank
holds only its own shards, and the collectives of
:mod:`repro_torch.distributed.collectives` move data only where a sharding
implies it.  A :class:`Mesh` carries the axis names, their sizes, one
process group per axis and this rank's coordinate; axis roles are the JAX
package's ("model" = TP + EP, "data" = batch DP + FSDP).

The backend is explicit everywhere: ``nccl`` for one rank per card,
``gloo`` on the CPU or for ranks that share one card.  Nothing probes for
it.  :func:`spawn` starts a world of ``data x model`` ranks on this host
(``torch.multiprocessing`` with the ``spawn`` start method, a ``FileStore``
rendezvous in a temporary directory, so concurrent worlds never race for a
port), joins every rank with a time limit, and raises if any rank fails or
hangs.

The production meshes of the dry-run are :func:`make_production_mesh`'s:
16 x 16 ``("data", "model")`` or 2 x 16 x 16 ``("pod", "data", "model")``,
over a world that :func:`fake_world` sets up in this one process (the
``fake`` backend: collectives return at once and move nothing), rank 0's
view, on the ``meta`` device.  The hardware constants below price the
dry-run's roofline (``launch/roofline.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

BACKENDS = ("nccl", "gloo")

# NVIDIA H100 SXM5 80GB at its 700 W limit, the card the port runs on:
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12                  # HBM3 bytes/s (data sheet)
# torch.cuda.get_device_properties(0).total_memory of the H100 80GB HBM3
# (700 W) as chip_smoke.py reads it
HBM_PER_CHIP = 85_017_493_504
GPUS_PER_NODE = 8                 # H100 SXM5 cards a node, NVLink all to all
NVLINK_BW = 450e9                 # bytes/s per direction a card, in a node
IB_BW = 50e9                      # InfiniBand NDR bytes/s a card, across nodes

PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """``"DxM"`` (also ``D×M``) -> ``(data, model)`` ints, with a clear error
    on malformed input."""
    d, sep, m = spec.lower().replace("×", "x").partition("x")
    try:
        if not sep:
            raise ValueError
        return int(d), int(m)
    except ValueError:
        raise ValueError(
            f"bad mesh spec {spec!r}: expected DATAxMODEL, e.g. 2x4") from None


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ``(data, model)`` mesh: axis names and sizes,
    one process group per axis (the ranks that differ only along it), this
    rank's coordinate, the backend and the device the rank computes on."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coord: Dict[str, int]
    groups: Dict[str, Any]
    backend: str
    device: torch.device
    rank: int
    world: int
    device_mesh: Any = None

    def key(self) -> Tuple[int, ...]:
        """This rank's coordinate as a tuple in axis order."""
        return tuple(self.coord[a] for a in self.axis_names)


def _check(data: int, model: int, backend: str) -> None:
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], *,
                 device, backend: str) -> Mesh:
    """A :class:`Mesh` of ``shape`` over the initialized world (one rank a
    position), built with ``init_device_mesh``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # the DeviceMesh's device type only labels it: "cpu" keeps it from
    # binding ranks to cards, which ranks sharing one card must not do
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=names)
    coord = {a: int(dm.get_local_rank(a)) for a in names}
    return Mesh(axis_names=names, shape=dict(zip(names, shape)),
                coord=coord, groups={a: dm.get_group(a) for a in names},
                backend=backend, device=torch.device(device),
                rank=dist.get_rank(), world=dist.get_world_size(),
                device_mesh=dm)


def make_serve_mesh(data: int, model: int, *, device,
                    backend: str) -> Mesh:
    """The ``(data, model)`` serving mesh over the initialized world
    (``data * model`` ranks, one process each), built with
    ``init_device_mesh``.  Every rank of the world must call it."""
    import torch.distributed as dist
    _check(data, model, backend)
    if not dist.is_initialized():
        raise RuntimeError("make_serve_mesh needs an initialized process "
                           "group (start the ranks with mesh.spawn)")
    need, world = data * model, dist.get_world_size()
    if world != need:
        raise ValueError(f"--mesh {data}x{model} needs {need} ranks but the "
                         f"world has {world}")
    return _device_mesh((data, model), ("data", "model"), device=device,
                        backend=backend)


def make_host_mesh(*, model: int = 1, device=None,
                   backend: str = "gloo") -> Mesh:
    """The mesh of whatever world this process belongs to, ``model`` ranks
    along the model axis and the rest along data; on the card unless the
    caller names the CPU."""
    import torch.distributed as dist
    from repro_torch import device as _device
    n = dist.get_world_size()
    assert n % model == 0, (n, model)
    return make_serve_mesh(n // model, model,
                           device=_device.resolve(device), backend=backend)


@contextlib.contextmanager
def fake_world(world: int):
    """A world of ``world`` ranks in this process, as rank 0, on the
    ``fake`` backend (its collectives return at once and move nothing):
    what a dry-run builds its production mesh over.  The process group is
    destroyed on exit; an initialized one is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is initialized "
                           "already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> Mesh:
    """The production mesh, rank 0's view: 16 x 16 ``("data", "model")``,
    or 2 x 16 x 16 ``("pod", "data", "model")`` with ``multi_pod``, over
    the initialized world of 256 or 512 ranks (:func:`fake_world`).  Its
    device is ``meta`` unless the caller names another."""
    return make_mesh(PRODUCTION_SHAPES[multi_pod],
                     PRODUCTION_AXES[multi_pod], device=device)


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], *,
              device="meta") -> Mesh:
    """A mesh of ``shape`` (axes ``names``) over the initialized world of
    exactly that many ranks, for a dry-run (``fake`` backend)."""
    import math
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(mesh.fake_world)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks but the world has "
                         f"{dist.get_world_size()}")
    return _device_mesh(tuple(shape), tuple(names), device=device,
                        backend="fake")


# ---------------------------------------------------------------- spawning

def _rank_main(rank: int, fn: Callable, data: int, model: int, store: str,
               backend: str, device: str, args: tuple, results,
               threads: int) -> None:
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl" and device == "cuda":
        # nccl: one card a rank
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store, data * model), rank=rank,
            world_size=data * model)
        mesh = make_serve_mesh(data, model, device=device, backend=backend)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:                   # reported, never swallowed
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, data: int, model: int, *, backend: str, device,
          timeout_s: float, args: Sequence = (),
          threads: int = 1) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a fresh ``data x model``
    world and return the ranks' results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function): the ranks
    are new interpreters.  Each rank computes on ``device`` with
    ``threads`` intra-op threads (0 leaves torch's default).  Raises
    ``RuntimeError`` with the failing ranks' tracebacks if any rank fails,
    exits without a result, or is still running ``timeout_s`` seconds
    after the start; every rank is stopped before this returns or raises.
    """
    import torch.multiprocessing as mp
    _check(data, model, backend)
    n = data * model
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, data, model, os.path.join(tmp, "store"),
                               backend, str(device), tuple(args), results,
                               threads),
                         daemon=True)
             for r in range(n)]
    got: Dict[int, Tuple[bool, Any]] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                r, ok, out = results.get(timeout=min(left, 1.0))
                got[r] = (ok, out)
                if not ok:
                    # the other ranks may now wait forever in a collective
                    # with the failed one: give their reports a short grace
                    deadline = min(deadline, time.monotonic() + 5.0)
            except _queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    # a rank died without reporting (killed, or a crash
                    # in the interpreter); give the queue a moment for
                    # the others' reports, then fail
                    time.sleep(0.5)
                    while True:
                        try:
                            r, ok, out = results.get_nowait()
                            got[r] = (ok, out)
                        except _queue.Empty:
                            break
                    break
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    missing = [r for r in range(n) if r not in got]
    if failed or missing:
        msg = [f"mesh {data}x{model} ({backend}) failed:"]
        for r in missing:
            msg.append(f"rank {r}: no result (exit code "
                       f"{procs[r].exitcode}; timeout {timeout_s:.0f}s)")
        for r, tb in sorted(failed.items()):
            msg.append(f"rank {r}:\n{tb}")
        raise RuntimeError("\n".join(msg))
    return [got[r][1] for r in range(n)]
