"""Atomic, async checkpointing, plain or EntroLLM-compressed (PyTorch port
of ``repro/checkpoint/checkpointer.py``, in the same format on disk).

Layout (one directory a step)::

    <root>/step_000000123/
        manifest.json           # step, leaf count, dtypes, shapes, compress
        shard_00000.npz         # the leaves (plain format)
    <root>/step_000000123.COMMIT   # written LAST: restart-safe atomicity

* **atomic**: a step is written under ``.tmp``, renamed, then committed
  with its ``.COMMIT`` marker; a directory without the marker is ignored
  and garbage-collected, so a crash mid-save never reaches ``restore``.
* **async**: ``save_async`` copies the leaves to host memory (the only
  synchronous cost) and writes them on a thread.
* **EntroLLM-compressed**: with ``compress="entro"`` the float leaves are
  stored as quantized symbols and entropy-coded streams in a
  :class:`~repro_torch.core.store.CompressedModel` container
  (``shard_00000_entro.npz``), the others raw (``shard_00000_raw.npz``).
  ``entro_bits`` sets one bit width; ``entro_spec`` (a
  :class:`~repro_torch.core.spec.CompressionSpec` or its rule string)
  chooses bits and codec a leaf.  ``restore`` decodes through the backend
  of the device it restores to: ``cuda`` (the decode kernels) on the card,
  ``numpy`` on the CPU.

The format is the JAX package's, so either package restores the other's
checkpoints.  Leaves are named ``leaf_%05d`` in the order
``jax.tree.flatten`` gives: dict keys sorted, named tuples in field order,
tuples and lists in order, ``None`` no leaf; the entro path names them
``leaf_%05d/<path>`` with the '/'-joined key path (``1/m/layers/wq/q``).
Dtypes are written by their numpy names (``bfloat16``, ``float32``,
``int32``, ``uint8``); a bfloat16 leaf goes into the npz as its uint16
bits, and into the entro encoder as float32.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any


# ------------------------------------------------------------------- pytrees

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: PyTree, path: Tuple[str, ...] = (),
                      is_leaf=None
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(key path, leaf)`` pairs in ``jax.tree.flatten``'s order;
    ``is_leaf`` names further leaves (a tree of partition specs, which are
    tuples, passes one)."""
    if tree is None:
        return
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_path(tree[k], path + (str(k),), is_leaf)
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from flatten_with_path(getattr(tree, f), path + (f,),
                                         is_leaf)
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from flatten_with_path(x, path + (str(i),), is_leaf)
    else:
        yield path, tree


def unflatten_like(like: PyTree, leaves: Iterator[Any]) -> PyTree:
    """``like``'s structure with its leaves taken from ``leaves`` in
    :func:`flatten_with_path`'s order (dicts keep ``like``'s key order)."""
    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(leaves)
    return build(like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array (a copy) and its numpy dtype name; a
    bfloat16 tensor comes back as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


@dataclasses.dataclass
class CheckpointConfig:
    root: str
    keep: int = 3                      # retained committed checkpoints
    compress: Optional[str] = None     # None | "entro"
    entro_bits: int = 8                # quantization bits for "entro"
    # a CompressionSpec (or its rule string) for the "entro" path,
    # overriding entro_bits; leaf names are "leaf_%05d/<path>", so
    # patterns match the tree path ("*/m/*:bits=8; 0/*:bits=auto").  The
    # container describes itself, so restore needs no spec.
    entro_spec: Optional[object] = None


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree, *, blocking: bool = True) -> None:
        """Snapshot to host memory (synchronous), then write (on a thread
        unless ``blocking``)."""
        self.wait()                                    # one save in flight
        pairs = list(flatten_with_path(tree))
        host = [_to_host(l) for _, l in pairs]
        leaf_paths = ["/".join(p) for p, _ in pairs]

        def write():
            try:
                self._write(step, host, leaf_paths)
            except BaseException as e:               # raised on next wait()
                self._last_error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree: PyTree) -> None:
        self.save(step, tree, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise RuntimeError("async checkpoint write failed") from e

    def _write(self, step: int, host: List[Tuple[np.ndarray, str]],
               leaf_paths: List[str]) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.cfg.root, name + ".tmp")
        final = os.path.join(self.cfg.root, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        manifest = {
            "step": step,
            # the JAX package writes its PyTreeDef string here; neither
            # package reads it back, so the port writes the leaf paths
            "treedef": leaf_paths,
            "n_leaves": len(host),
            "compress": self.cfg.compress,
            "dtypes": [dt for _, dt in host],
            "shapes": [list(a.shape) for a, _ in host],
            "time": time.time(),
        }
        if self.cfg.compress == "entro":
            from repro_torch.core.spec import CompressionSpec
            from repro_torch.core.store import CompressedModel
            named = {f"leaf_{i:05d}/{leaf_paths[i]}" if leaf_paths[i]
                     else f"leaf_{i:05d}":
                     _bf16_bits_to_f32(a) if dt == "bfloat16" else a
                     for i, (a, dt) in enumerate(host)}
            # float leaves are compressed; integer ones are stored raw
            floaty = {k: v for k, v in named.items()
                      if v.dtype in (np.float32, np.float64)}
            raw = {k: v for k, v in named.items() if k not in floaty}
            spec = self.cfg.entro_spec
            if isinstance(spec, str):
                spec = CompressionSpec.parse(spec)
            if spec is not None:
                manifest["entro_spec"] = spec.describe()
                cm = CompressedModel.compress(floaty, spec=spec)
            else:
                # without a spec, shape and size alone decide (the leaf
                # names carry paths the name-based default would match)
                cm = CompressedModel.compress(
                    floaty, bits=self.cfg.entro_bits,
                    should_quantize=lambda n, w: w.ndim >= 2
                    and w.size >= 4096)
            cm.save(os.path.join(tmp, "shard_00000_entro"))
            np.savez(os.path.join(tmp, "shard_00000_raw.npz"), **raw)
        else:
            np.savez(os.path.join(tmp, "shard_00000.npz"),
                     **{f"leaf_{i:05d}": a for i, (a, _) in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)                        # atomic rename ...
        with open(final + ".COMMIT", "w") as f:       # ... then the marker
            f.write(str(step))
        self._gc()

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = list(self.latest_steps())
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, like: PyTree,
                device=None, shardings: Optional[PyTree] = None,
                mesh=None) -> Tuple[int, PyTree]:
        """Restore a committed checkpoint into ``like``'s structure (leaves
        matched by position), every leaf a tensor on ``device`` (``cuda``
        unless the caller names the CPU).

        With ``shardings`` (a tree of specs shaped like ``like``) and this
        rank's ``mesh``, the rank keeps its block of each leaf (a
        :class:`~repro_torch.distributed.ctx.Sharded` where the spec shards
        it) on ``mesh.device``: the restore re-shards onto whatever mesh
        is current."""
        from repro_torch import device as _device
        if shardings is not None and mesh is None:
            raise ValueError("restore(shardings=) needs this rank's mesh")
        dev = _device.resolve(device if mesh is None else mesh.device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.cfg.root}")
        final = os.path.join(self.cfg.root, f"step_{step:09d}")
        if not os.path.exists(final + ".COMMIT"):
            raise FileNotFoundError(f"checkpoint {final} lacks COMMIT marker")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)

        if manifest.get("compress") == "entro":
            from repro_torch.core.store import CompressedModel
            cm = CompressedModel.load(
                os.path.join(final, "shard_00000_entro.npz"))
            backend = "cuda" if dev.type == "cuda" else "numpy"
            named = dict(cm.dequantize_all(backend=backend, device=dev))
            raw = np.load(os.path.join(final, "shard_00000_raw.npz"))
            named.update({k: raw[k] for k in raw.files})
        else:
            z = np.load(os.path.join(final, "shard_00000.npz"))
            named = {k: z[k] for k in z.files}

        # leaves are matched by the leaf_%05d prefix ("leaf_00042/<path>"
        # in entro checkpoints, the bare prefix in plain ones)
        by_idx = {k.split("/", 1)[0]: k for k in named}
        leaves = []
        for i in range(manifest["n_leaves"]):
            arr = np.asarray(named[by_idx[f"leaf_{i:05d}"]])
            dt = manifest["dtypes"][i]
            if dt == "bfloat16":
                t = (torch.from_numpy(arr.view(np.int16).copy())
                     .view(torch.bfloat16) if arr.dtype == np.uint16
                     else torch.from_numpy(np.asarray(arr, np.float32))
                     .to(torch.bfloat16))
            else:
                t = torch.from_numpy(np.array(arr, dtype=dt))
            leaves.append(t.reshape(manifest["shapes"][i]))
        if shardings is not None:
            from repro_torch.distributed.ctx import shard
            specs = [s for _, s in flatten_with_path(
                shardings, is_leaf=lambda x: isinstance(x, tuple)
                and not _is_namedtuple(x))]
            if len(specs) != len(leaves):
                raise ValueError(f"restore: {len(specs)} specs for "
                                 f"{len(leaves)} leaves")
            leaves = [shard(t, s, mesh).to(dev)
                      for t, s in zip(leaves, specs)]
        else:
            leaves = [t.to(dev) for t in leaves]
        return step, unflatten_like(like, iter(leaves))

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(self.latest_steps())
        for n in os.listdir(self.cfg.root):           # uncommitted debris
            p = os.path.join(self.cfg.root, n)
            if n.endswith(".tmp"):
                shutil.rmtree(p, ignore_errors=True)
            elif n.startswith("step_") and not n.endswith(".COMMIT") \
                    and not os.path.exists(p + ".COMMIT"):
                shutil.rmtree(p, ignore_errors=True)
        for s in steps[: -self.cfg.keep]:
            name = os.path.join(self.cfg.root, f"step_{s:09d}")
            shutil.rmtree(name, ignore_errors=True)
            try:
                os.remove(name + ".COMMIT")
            except FileNotFoundError:
                pass

    def latest_steps(self) -> Iterator[int]:
        for n in os.listdir(self.cfg.root):
            if n.endswith(".COMMIT"):
                yield int(n[len("step_"):-len(".COMMIT")])
