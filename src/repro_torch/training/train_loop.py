"""Training step and loop (PyTorch port of ``repro/training/train_loop.py``):
gradient accumulation over microbatches, the optional compressed weight
gather and gradient compression, metrics.

The JAX package jits the step and scans over microbatches inside it; the
port runs the same arithmetic eagerly: each microbatch is sliced from the
leading batch axis, its gradients come from ``torch.autograd.grad`` and are
summed in ``grad_accum_dtype``, then scaled by ``1 / microbatches`` in
float32.  Its ``unroll`` (a scan knob) has no eager counterpart.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import quantizable_shape
from repro_torch.models import api
from repro_torch.models.layers import QTG
from . import optimizer as opt

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt.AdamWConfig = opt.AdamWConfig()
    microbatches: int = 1          # grad-accum splits of the global batch
    grad_accum_dtype: str = "f32"  # "bf16" = the memory-tight mode
    remat: bool = True             # recompute each layer in the backward
    q_block: int = 0               # attention query-block chunking (not
    #                                ported: > 0 raises)
    grad_compress: bool = False    # int8 gradient wire format (simulated)
    q8_gather: int = 0             # 0 = off | 8 | 4: EntroLLM-quantized
    #                                weights in the forward, straight-
    #                                through gradients to the master


def loss_for(cfg: ArchConfig) -> Callable:
    return api.build(cfg).loss_fn


@torch.no_grad()
def ste_quantize_params(params: Dict[str, Any], bits: int) -> Dict[str, Any]:
    """Per-channel (axis 0) mixed symmetric / asymmetric quantization of
    every large matrix to uint8 symbols (nibble-packed at 4 bits), as a
    :class:`QTG` the models read through ``deq``: the forward computes from
    the symbols alone, and the straight-through backward sends the whole
    gradient to the master ``w`` (quantization-aware training).  Which
    tensors are quantized is ``core.spec.quantizable_shape``'s rule."""
    qmax = float((1 << bits) - 1)
    out: Dict[str, Any] = {}
    for name, w in params.items():
        if not quantizable_shape(name, tuple(w.shape)):
            out[name] = w
            continue
        wf = w.to(f32)
        red = tuple(range(1, wf.dim()))
        lo = torch.amin(wf, dim=red, keepdim=True)
        hi = torch.amax(wf, dim=red, keepdim=True)
        single = lo * hi >= 0.0
        absmax = torch.where(torch.abs(hi) >= torch.abs(lo), hi, lo)
        scale = torch.where(single,
                            torch.where(absmax == 0.0, 1.0, absmax / qmax),
                            torch.where(hi == lo, 1.0, (hi - lo) / qmax))
        zero = torch.where(single, 0.0, lo)
        q = torch.clamp(torch.round((wf - zero) / scale), 0.0, qmax
                        ).to(torch.uint8)
        if bits == 4:
            q = q[..., 0::2] | (q[..., 1::2] << 4)
        out[name] = QTG(q, scale.to(f32), zero.to(f32), w)
    return out


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_grad_fn(cfg: ArchConfig, tc: TrainConfig,
                 loss_fn: Optional[Callable] = None) -> Callable:
    """Returns ``grads(params, batch) -> (loss, {name: gradient})``: the
    loss and gradients of one step before the update, microbatched as
    ``tc`` says (``loss_fn`` defaults to the family's)."""
    loss_fn = loss_fn or loss_for(cfg)

    def grads_of(params, mb):
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        p = ste_quantize_params(leaves, tc.q8_gather) if tc.q8_gather \
            else leaves
        loss = loss_fn(cfg, p, mb, remat=tc.remat, q_block=tc.q_block)
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[n] for n in names],
                                 allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it
        return loss.detach(), {
            n: g if g is not None else torch.zeros_like(leaves[n])
            for n, g in zip(names, gs)}

    def microbatch_grads(params, batch):
        if tc.microbatches <= 1:
            return grads_of(params, batch)
        acc_dt = torch.bfloat16 if tc.grad_accum_dtype == "bf16" else f32
        dev = next(iter(params.values())).device
        grad_acc = {n: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                    for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=f32, device=dev)
        for i in range(tc.microbatches):
            mb = {k: v[i * (v.shape[0] // tc.microbatches):
                       (i + 1) * (v.shape[0] // tc.microbatches)]
                  for k, v in batch.items()}
            loss, grads = grads_of(params, mb)
            with torch.no_grad():
                for n, g in grads.items():
                    grad_acc[n].add_(g.to(acc_dt))
                loss_acc = loss_acc + loss
            del grads
        inv = 1.0 / tc.microbatches
        with torch.no_grad():
            # in place on the accumulator (or its float32 copy): the same
            # product, without a second float32 gradient tree
            return loss_acc * inv, {n: g.to(f32).mul_(inv)
                                    for n, g in grad_acc.items()}

    return microbatch_grads


def make_train_step(cfg: ArchConfig, tc: TrainConfig) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds tensors on the parameters' device, and
    ``metrics`` 0-d device tensors (``loss``, ``grad_norm``, ``lr``)."""
    microbatch_grads = make_grad_fn(cfg, tc)

    def step(params, opt_state, batch):
        loss, grads = microbatch_grads(params, batch)
        if tc.grad_compress:
            from repro_torch.distributed.grad_compress import \
                compress_decompress
            grads = compress_decompress(grads)
        params, opt_state, metrics = opt.apply_updates(tc.opt, params, grads,
                                                       opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return step


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """0-d metric tensors as host floats, read in one transfer."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).to(f32).reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def train(cfg: ArchConfig, tc: TrainConfig, params, opt_state,
          data_iter: Iterator, num_steps: int, *,
          hooks: Tuple[Callable, ...] = ()) -> Tuple[Any, Any, Dict]:
    """Host-side loop: moves each batch to the parameters' device, runs a
    step, reads its metrics once, then runs the hooks
    (``hook(i, params, opt_state, metrics)``; a return that is not ``None``
    is a new ``(params, opt_state)``).  Returns (params, opt_state, {
    "history": per-step host metrics, "wall_s", "steps_per_s"})."""
    step_fn = make_train_step(cfg, tc)
    dev = next(iter(params.values())).device
    history = []
    t0 = time.perf_counter()
    for i in range(num_steps):
        batch = to_device(next(data_iter), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        del batch
        metrics = host_metrics(metrics)
        for h in hooks:
            out = h(i, params, opt_state, metrics)
            if out is not None:                       # hook replaced the state
                params, opt_state = out
        history.append(metrics)
    wall = time.perf_counter() - t0
    return params, opt_state, {"history": history, "wall_s": wall,
                               "steps_per_s": num_steps / max(wall, 1e-9)}
