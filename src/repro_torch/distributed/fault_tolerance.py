"""Fault tolerance for long training runs (PyTorch port of
``repro/distributed/fault_tolerance.py``).

* **NaN / inf watchdog with rollback**: :class:`NanWatchdog` is a train-loop
  hook; on a non-finite loss or gradient norm it restores the last
  committed checkpoint (the data stream is a pure function of the step
  index, so the replay is deterministic and the bad batch is skipped).
* **Straggler detection**: :class:`StepTimeWatchdog` keeps a moving window
  of step times and flags a step slower than ``threshold`` times the
  median; :func:`suggest_rebalance` re-maps data shards to hosts (the data
  pipeline is keyed by shard index, so re-mapping moves no data).
* **Elastic reshard**: :func:`reshard_restore` restores a checkpoint onto
  the current mesh, whatever mesh saved it: each rank keeps its block of
  every leaf by the specs it is given.
* **Preemption-safe save cadence**: :class:`CheckpointHook` saves every
  ``every`` steps, asynchronously by default; with atomic commits a kill
  loses at most ``every`` steps of work.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.checkpointer import Checkpointer


class NanWatchdog:
    """Train hook: roll back to the last checkpoint on non-finite metrics;
    the restored state goes to ``device`` (``cuda`` unless the caller names
    the CPU)."""

    def __init__(self, ckpt: Checkpointer, template: Tuple[Any, Any],
                 device=None, cooldown: int = 1):
        self.ckpt = ckpt
        self.template = template
        self.device = device
        self.cooldown = cooldown
        self.rollbacks: List[int] = []

    def __call__(self, step: int, params, opt_state, metrics):
        vals = [float(metrics.get("loss", 0.0)),
                float(metrics.get("grad_norm", 0.0))]
        if all(math.isfinite(v) for v in vals):
            return None
        self.rollbacks.append(step)
        _, tree = self.ckpt.restore(like=(self.template[0], self.template[1]),
                                    device=self.device)
        return tree  # the train loop swaps (params, opt_state)


class CheckpointHook:
    def __init__(self, ckpt: Checkpointer, every: int, *,
                 async_save: bool = True):
        self.ckpt = ckpt
        self.every = every
        self.async_save = async_save

    def __call__(self, step: int, params, opt_state, metrics):
        if (step + 1) % self.every == 0:
            self.ckpt.save(step + 1, (params, opt_state),
                           blocking=not self.async_save)
        return None


def reshard_restore(ckpt: Checkpointer, like, new_shardings, mesh,
                    step=None):
    """Restore onto a (possibly different-shaped) current mesh: every rank
    of ``mesh`` keeps its block of each leaf by ``new_shardings`` (a tree
    of specs shaped like ``like``)."""
    return ckpt.restore(step, like=like, shardings=new_shardings,
                        mesh=mesh)


@dataclasses.dataclass
class StepTimeWatchdog:
    """Detect slow steps and propose data-shard re-balancing."""

    threshold: float = 2.0         # x median => straggler
    window: int = 32

    def __post_init__(self):
        self.times: List[float] = []
        self.flagged: List[int] = []
        self._t_last: Optional[float] = None

    def tick(self, step: int) -> Optional[int]:
        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return None
        dt = now - self._t_last
        self._t_last = now
        return self.observe(step, dt)

    def observe(self, step: int, dt: float) -> Optional[int]:
        """Feed a measured duration directly (tests, simulation)."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        if len(self.times) >= 8 and dt > self.threshold * med:
            self.flagged.append(step)
            return step
        return None


def suggest_rebalance(shard_times: Dict[int, float], hosts: int
                      ) -> Dict[int, int]:
    """Greedy longest-processing-time assignment of data shards to hosts:
    a shard -> host map that keeps the slowest host's load low."""
    order = sorted(shard_times, key=lambda s: -shard_times[s])
    loads = [0.0] * hosts
    assign: Dict[int, int] = {}
    for s in order:
        h = int(np.argmin(loads))
        assign[s] = h
        loads[h] += shard_times[s]
    return assign
