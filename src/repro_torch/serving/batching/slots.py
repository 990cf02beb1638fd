"""Slot-based KV cache pool for continuous batching (PyTorch port of
``repro/serving/batching/slots.py``).

The manager owns ONE fixed-capacity batched cache (the model family's
``init_cache(cfg, n_slots, max_len)`` layout, ``(L, n_slots, T, KV, hd)`` a
leaf: axis 1 is the slot axis) plus the per-slot bookkeeping the step
functions do not hold: ``kv_len`` per slot, the free list, and the slot →
request map.  The cache is changed in place, in two ways:

* ``insert`` — copy a freshly prefilled request's cache rows into a slot
  (every row of the slot, so whatever a previous occupant or an idle decode
  step left there is gone);
* ``release`` — free the slot and *compact* it (zero the slot's rows), so a
  dead request's keys don't linger in cache memory until reuse.

Slot alloc/free is O(1); there is no cross-slot copying — "compaction" here
means reclaim-and-zero, not defragmentation, because slots are fixed-size
rows of one preallocated pool and can never fragment.  Compaction is hygiene,
not a correctness requirement: correctness rests on ``insert`` overwriting
every row of the slot and on ``kv_len`` masking, and a freed slot does not
stay pristine — idle lanes riding the engine's fused decode step deposit one
garbage k/v row (at position 0) per step until the slot is reused.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.obs import metrics as obs_metrics
from .request import Request


class SlotBatchManager:
    """Fixed-capacity slotted KV cache + per-slot request bookkeeping, on
    ``device`` (the caller resolves it; the engine passes its own)."""

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 device: torch.device):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache: Dict[str, torch.Tensor] = api.build(cfg).init_cache(
            cfg, n_slots, max_len, device=device)
        self.kv_len = np.zeros((n_slots,), np.int64)
        self.requests: List[Optional[Request]] = [None] * n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))  # pop() -> 0 first

    # ------------------------------------------------------------- occupancy
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def active(self) -> List[int]:
        return [s for s, r in enumerate(self.requests) if r is not None]

    # ------------------------------------------------------------- lifecycle
    def alloc(self, req: Request) -> Optional[int]:
        """Claim a free slot for ``req``; None when the batch is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.requests[slot] = req
        self.kv_len[slot] = 0
        obs_metrics.gauge("slots.occupied").set(self.n_slots - len(self._free))
        return slot

    def insert(self, slot: int, req_cache: Dict[str, torch.Tensor],
               kv_len: int) -> None:
        """Copy a prefilled single-request cache (batch dim 1, the pool's
        ``max_len``) into every row of ``slot``."""
        assert self.requests[slot] is not None, f"insert into free slot {slot}"
        assert kv_len <= self.max_len, (kv_len, self.max_len)
        for key, c in self.cache.items():
            c[:, slot].copy_(req_cache[key][:, 0])
        self.kv_len[slot] = kv_len
        obs_metrics.counter("slots.inserts").inc()

    def release(self, slot: int) -> Request:
        """Detach the slot's request and compact (zero) its rows."""
        req = self.requests[slot]
        assert req is not None, f"release of free slot {slot}"
        self.requests[slot] = None
        self.kv_len[slot] = 0
        self._free.append(slot)
        obs_metrics.counter("slots.releases").inc()
        obs_metrics.gauge("slots.occupied").set(self.n_slots - len(self._free))
        for c in self.cache.values():
            c[:, slot].zero_()
        obs_metrics.counter("slots.compactions").inc()
        return req
