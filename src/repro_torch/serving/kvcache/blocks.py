"""Paged KV block pool + prefix sharing for continuous batching (PyTorch port
of ``repro/serving/kvcache/blocks.py``).

``BlockKVManager`` is the paged successor of
:class:`~repro_torch.serving.batching.slots.SlotBatchManager`: instead of
one contiguous ``max_len`` row per slot it owns a pool of fixed-size blocks
— ``init_kv_pool(cfg, n_blocks, block_size, bits)`` on the engine's device
— and a host-side ``(n_slots, max_blocks)`` int32 block table routing every
slot's logical positions to pool blocks.  The step functions
(``paged_prefill_chunk`` / ``paged_decode_step``) scatter into and gather
from the pool through that table, in place; everything else — free lists,
refcounts, the prefix-chain map, LRU cold eviction — is plain host
bookkeeping here.

Layout invariants the step functions rely on:

* **Block 0 is the trash block.**  It is never allocated; table rows handed
  to the decode step for non-live lanes (free, or still prefilling) are
  all-trash, so their per-step garbage write (position 0) lands in a block
  nobody gathers unmasked.  Stale rows a live lane *does* gather (trash
  entries past its allocation, a reused block's old tail) are killed by
  ``kv_len`` masking — masked scores get exactly ``NEG_INF`` and ``exp``
  underflows to an exact 0.0 contribution.
* **Shared blocks are immutable after publish.**  Only *full* prompt blocks
  (``j < prompt_len // block_size``) are published to the prefix chain at
  ``insert``; decode writes start at ``prompt_len``, which always lands in
  a private block.  A prefix *hit* may still re-scatter the tail of the
  shared region when the skip is chunk-aligned short of the hit boundary —
  benign, because identical tokens after an identical prefix produce
  bit-identical K/V rows.
* **Refcount 0 ≠ free.**  A published block whose requests all released
  stays resident on an LRU list; it is reclaimed only when admission needs
  blocks, and — with a codec configured — entropy-coded to the host cold
  tier (:mod:`repro_torch.serving.kvcache.cold`) instead of dropped, so the
  next hit pays a serial decode rather than a re-prefill.

Blocks cross to the host (eviction, export) as numpy leaves; bf16 leaves
travel as their 16-bit patterns (int16), since numpy has no bfloat16.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models import api
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from .cold import ColdBlockStore

if TYPE_CHECKING:                 # import cycle: batching.engine imports us
    from ..batching.request import Request

Pool = Dict[str, torch.Tensor]


def _zero_block(pool: Pool, blk: int) -> None:
    for c in pool.values():
        c[:, blk].zero_()


def _read_block(pool: Pool, blk: int) -> Dict[str, np.ndarray]:
    """Host copy of block ``blk`` across every leaf, (L, BS, KV, .) each;
    bf16 leaves as int16 bit patterns."""
    out = {}
    for name, c in pool.items():
        t = c[:, blk].to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        out[name] = t.numpy()
    return out


def _write_block(pool: Pool, blk: int, leaves: Dict[str, np.ndarray]) -> None:
    """Write host leaves (as :func:`_read_block` gives them) into block
    ``blk``, in place."""
    for name, c in pool.items():
        src = torch.from_numpy(np.ascontiguousarray(leaves[name]))
        c[:, blk].copy_(src.view(c.dtype))


@dataclasses.dataclass
class _Plan:
    """Admission plan for one request (see ``BlockKVManager._plan``)."""
    nb: int                                    # blocks the request needs
    res_hits: List[Tuple[int, Hashable, int]]  # (j, chain key, block id)
    cold_hits: List[Tuple[int, Hashable]]      # (j, chain key)
    n_skip: int                                # prefill tokens skipped
    pending: List[Tuple[int, Hashable]]        # full blocks to publish later

    @property
    def n_new(self) -> int:                    # fresh blocks to claim
        return self.nb - len(self.res_hits)


class BlockKVManager:
    """Block-table-backed KV cache + per-slot request bookkeeping, with the
    pool on ``device`` (the caller resolves it; the engine passes its own).

    Drop-in for ``SlotBatchManager`` on the paged engine path: same slot
    lifecycle (``alloc`` → ``insert`` → ``release``), but ``alloc`` returns
    ``(slot, n_skip)`` — the prefix-shared token count admission may skip —
    and ``insert`` takes only the kv length (prefill wrote the pool blocks
    in place through the table; there is no scratch cache to copy).
    """

    def __init__(self, cfg: ArchConfig, n_slots: int, max_len: int, *,
                 device: torch.device,
                 spec: Optional[KVCompressionSpec] = None,
                 n_blocks: Optional[int] = None, prefill_chunk: int = 1):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.cfg = cfg
        self.spec = spec = spec or KVCompressionSpec()
        spec.validate()
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if spec.sharing and prefill_chunk % spec.block_size:
            raise ValueError(
                f"prefix sharing needs prefill_chunk % block_size == 0 "
                f"(got chunk={prefill_chunk}, block={spec.block_size}): the "
                f"skip boundary must be a chunk boundary")
        self.n_slots = n_slots
        self.max_len = max_len
        self.block_size = spec.block_size
        self.chunk = prefill_chunk
        self.max_blocks = -(-max_len // spec.block_size)
        # default capacity = trash + the slot pool's worth of blocks, so the
        # dense default matches SlotBatchManager byte for byte modulo trash
        self.n_blocks = (1 + n_slots * self.max_blocks
                         if n_blocks is None else n_blocks)
        if self.n_blocks < 1 + self.max_blocks:
            raise ValueError(
                f"n_blocks={self.n_blocks} cannot hold trash + one "
                f"max-length request ({1 + self.max_blocks})")
        self.pool: Pool = api.build(cfg).init_kv_pool(
            cfg, self.n_blocks, spec.block_size, spec.bits, device=device)
        self.tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self.kv_len = np.zeros((n_slots,), np.int64)
        self.requests: List[Optional[Request]] = [None] * n_slots
        self._live = [False] * n_slots
        self._free_slots: List[int] = list(range(n_slots - 1, -1, -1))
        self._free_blocks: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._slot_shared: List[List[Tuple[int, Hashable]]] = \
            [[] for _ in range(n_slots)]
        self._slot_private: List[List[int]] = [[] for _ in range(n_slots)]
        self._pending: List[List[Tuple[int, Hashable]]] = \
            [[] for _ in range(n_slots)]
        self._chain: Dict[Hashable, int] = {}    # resident prefix key -> block
        self._refs: Dict[int, int] = {}          # shared block -> refcount
        self._block_key: Dict[int, Hashable] = {}
        self._lru: "OrderedDict[int, Hashable]" = OrderedDict()
        self.cold = ColdBlockStore(spec.codec) if spec.codec else None
        # stats counters are read by stats() / monitoring threads while the
        # engine loop mutates them; everything else is engine-thread-only
        self._stats_lock = threading.Lock()
        self.shared_hits = 0
        self.shared_misses = 0
        self.cold_evictions = 0
        self.cold_restores = 0
        self.dropped_evictions = 0
        self._update_gauges()

    # ------------------------------------------------------------- occupancy
    @property
    def n_free(self) -> int:
        return len(self._free_slots)

    @property
    def active(self) -> List[int]:
        return [s for s, r in enumerate(self.requests) if r is not None]

    @property
    def n_free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def pool_bytes(self) -> int:
        return sum(c.numel() * c.element_size() for c in self.pool.values())

    @property
    def cold_bytes(self) -> int:
        return self.cold.nbytes if self.cold is not None else 0

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            hits, misses = self.shared_hits, self.shared_misses
            evic, rest, drop = (self.cold_evictions, self.cold_restores,
                                self.dropped_evictions)
        lookups = hits + misses
        return {
            "pool_bytes": self.pool_bytes,
            "cold_bytes": self.cold_bytes,
            "blocks_free": len(self._free_blocks),
            "blocks_total": self.n_blocks,
            "shared_hits": hits,
            "shared_misses": misses,
            "prefix_hit_rate": hits / lookups if lookups else 0.0,
            "cold_evictions": evic,
            "cold_restores": rest,
            "dropped_evictions": drop,
        }

    def _update_gauges(self) -> None:
        obs_metrics.gauge("kv.resident_bytes").set(self.pool_bytes)
        obs_metrics.gauge("kv.blocks_free").set(len(self._free_blocks))
        obs_metrics.gauge("slots.occupied").set(
            self.n_slots - len(self._free_slots))

    # ------------------------------------------------------------ block table
    def table_rows(self, slots: List[int]) -> np.ndarray:
        """Raw table rows for ``slots`` — the prefill view (writes allowed)."""
        return self.tables[np.asarray(slots, np.int64)]

    def decode_tables(self) -> np.ndarray:
        """The decode-step view: non-live lanes' rows are all-trash so their
        per-step garbage write cannot touch an allocated (or shared) block."""
        out = self.tables.copy()
        for s in range(self.n_slots):
            if not self._live[s]:
                out[s] = 0
        return out

    # ---------------------------------------------------------------- sharing
    def _chain_keys(self, prompt: np.ndarray) -> List[Hashable]:
        """Content-hash chain over the prompt's *full* blocks: each key folds
        in its parent, so equal keys imply equal whole prefixes."""
        BS = self.block_size
        keys: List[Hashable] = []
        parent: Hashable = None
        for j in range(len(prompt) // BS):
            parent = (parent, prompt[j * BS:(j + 1) * BS].tobytes())
            keys.append(parent)
        return keys

    def _plan(self, req: Request, count: bool = True) -> Optional[_Plan]:
        P = req.prompt_len
        padded = -(-P // self.chunk) * self.chunk
        need = max(P + req.max_new_tokens, padded)
        if need > self.max_len:
            return None
        nb = -(-need // self.block_size)
        res_hits: List[Tuple[int, Hashable, int]] = []
        cold_hits: List[Tuple[int, Hashable]] = []
        keys = self._chain_keys(req.prompt) if self.spec.sharing else []
        n_hit = 0
        for j, key in enumerate(keys):
            if key in self._chain:
                res_hits.append((j, key, self._chain[key]))
            elif self.cold is not None and key in self.cold:
                cold_hits.append((j, key))
            else:
                break
            n_hit = j + 1
        # skip whole chunks covered by hits, but always leave the final
        # chunk (the one holding position P-1) to run — its logits seed the
        # first generated token
        n_skip = min(n_hit * self.block_size // self.chunk * self.chunk,
                     (P - 1) // self.chunk * self.chunk)
        pending = [(j, key) for j, key in enumerate(keys) if j >= n_hit]
        if count:
            with self._stats_lock:
                self.shared_hits += n_hit
                self.shared_misses += len(keys) - n_hit
            if n_hit:
                obs_metrics.counter("kv.shared_hits").inc(n_hit)
            if len(keys) - n_hit:
                obs_metrics.counter("kv.shared_misses").inc(len(keys) - n_hit)
        return _Plan(nb=nb, res_hits=res_hits, cold_hits=cold_hits,
                     n_skip=n_skip, pending=pending)

    # ------------------------------------------------------------- lifecycle
    def can_admit(self, req: Request) -> bool:
        """Admission probe — free slot + enough claimable blocks.  Plans
        with ``count=False``: ``alloc`` re-plans and counts, so a counting
        probe would count every admitted request's hits twice."""
        if not self._free_slots:
            return False
        plan = self._plan(req, count=False)
        if plan is None:
            return False
        # planned hits sitting at refcount 0 are on the LRU but must not be
        # counted as evictable — alloc pins them before evicting
        pinned = sum(1 for _, _, blk in plan.res_hits if blk in self._lru)
        return plan.n_new <= (len(self._free_blocks)
                              + len(self._lru) - pinned)

    def alloc(self, req: Request) -> Optional[Tuple[int, int]]:
        """Claim a slot + blocks for ``req``; returns ``(slot, n_skip)`` —
        admission may skip the first ``n_skip`` prompt tokens (prefix hits).
        None when the batch or the pool is full."""
        if not self._free_slots:
            return None
        with obs_trace.span("kv.admit", rid=req.rid, prompt=req.prompt_len):
            plan = self._plan(req)
            if plan is None:
                return None
            # pin resident hits FIRST (refcount up, off the LRU) — a hit at
            # refcount 0 is an eviction candidate, and the eviction loop
            # below must never reclaim a block this plan is about to reuse
            for _, _, blk in plan.res_hits:
                self._refs[blk] += 1
                self._lru.pop(blk, None)
            if plan.n_new > len(self._free_blocks) + len(self._lru):
                for _, _, blk in plan.res_hits:      # unwind the pins
                    self._refs[blk] -= 1
                    if self._refs[blk] == 0:
                        self._lru[blk] = self._block_key[blk]
                return None
            while len(self._free_blocks) < plan.n_new:
                self._evict_one()
            slot = self._free_slots.pop()
            row = self.tables[slot]
            row[:] = 0
            shared = self._slot_shared[slot]
            private = self._slot_private[slot]
            for j, key, blk in plan.res_hits:
                row[j] = blk
                shared.append((j, key))
            for j, key in plan.cold_hits:
                blk = self._free_blocks.pop()
                leaves = self.cold.pop(key)
                with obs_trace.span("kv.cold_decode", block=blk):
                    _write_block(self.pool, blk, leaves)
                self._chain[key] = blk
                self._refs[blk] = 1
                self._block_key[blk] = key
                row[j] = blk
                shared.append((j, key))
                with self._stats_lock:
                    self.cold_restores += 1
                obs_metrics.counter("kv.cold_restores").inc()
            n_hit = len(plan.res_hits) + len(plan.cold_hits)
            for j in range(n_hit, plan.nb):
                blk = self._free_blocks.pop()
                row[j] = blk
                private.append(blk)
            self._pending[slot] = plan.pending
            self.requests[slot] = req
            self.kv_len[slot] = 0
            self._live[slot] = False
            self._update_gauges()
            return slot, plan.n_skip

    def insert(self, slot: int, kv_len: int) -> None:
        """Activate a prefilled slot at length ``kv_len`` and publish its
        full prompt blocks to the prefix chain (sharing only)."""
        assert self.requests[slot] is not None, f"insert into free slot {slot}"
        assert not self._live[slot], f"double insert into slot {slot}"
        assert kv_len <= self.max_len, (kv_len, self.max_len)
        self.kv_len[slot] = kv_len
        self._live[slot] = True
        if self.spec.sharing:
            private = self._slot_private[slot]
            for j, key in self._pending[slot]:
                if key in self._chain:       # racing identical prefix won;
                    continue                 # keep ours private
                blk = int(self.tables[slot, j])
                private.remove(blk)
                self._chain[key] = blk
                self._refs[blk] = 1
                self._block_key[blk] = key
                self._slot_shared[slot].append((j, key))
                if self.cold is not None:    # resident copy supersedes cold
                    self.cold.drop(key)
        self._pending[slot] = []
        obs_metrics.counter("slots.inserts").inc()
        self._update_gauges()

    def release(self, slot: int) -> Request:
        """Detach the slot's request.  Shared blocks drop a refcount (to the
        LRU at zero); private blocks return to the free list, compacted
        (zeroed) like the slot pool's rows."""
        req = self.requests[slot]
        assert req is not None, f"release of free slot {slot}"
        self.requests[slot] = None
        self.kv_len[slot] = 0
        self._live[slot] = False
        for j, key in self._slot_shared[slot]:
            blk = self._chain[key]
            self._refs[blk] -= 1
            if self._refs[blk] == 0:
                self._lru[blk] = key
        self._slot_shared[slot] = []
        for blk in self._slot_private[slot]:
            _zero_block(self.pool, blk)
            self._free_blocks.append(blk)
        if self._slot_private[slot]:
            obs_metrics.counter("slots.compactions").inc()
        self._slot_private[slot] = []
        self._pending[slot] = []
        self.tables[slot] = 0
        self._free_slots.append(slot)
        obs_metrics.counter("slots.releases").inc()
        self._update_gauges()
        return req

    # ---------------------------------------------------------- export/import
    def export_blocks(self, slot: int) -> List[Dict[str, np.ndarray]]:
        """Host leaves of the slot's first ``ceil(kv_len / block_size)``
        blocks, in logical order — the KV export behind a disaggregated
        prefill→decode handoff.  Rows past ``kv_len`` inside the last block
        are pool garbage; the importing side's ``kv_len`` masking makes them
        unreachable, the same invariant as block reuse."""
        req = self.requests[slot]
        assert req is not None, f"export of free slot {slot}"
        n = -(-int(self.kv_len[slot]) // self.block_size)
        return [_read_block(self.pool, int(self.tables[slot, j]))
                for j in range(n)]

    def can_import(self, req: Request, kv_len: int, n_blocks: int) -> bool:
        """Probe for ``import_blocks`` — free slot + claimable blocks for
        the imported prefix AND the request's remaining generation."""
        if not self._free_slots:
            return False
        need = kv_len + req.max_new_tokens
        if need > self.max_len:
            return False
        nb = max(-(-need // self.block_size), n_blocks)
        return nb <= len(self._free_blocks) + len(self._lru)

    def import_blocks(self, req: Request,
                      kv_len: int,
                      blocks: List[Dict[str, np.ndarray]]) -> Optional[int]:
        """Claim a slot + private blocks and install externally produced
        block leaves (the decode half of a disaggregated handoff).

        The imported blocks stay *private*: publishing another replica's
        prefix blocks to this pool's chain would need the chain keys.
        Returns the slot, or None when the batch or the pool cannot take the
        request right now (the caller retries)."""
        if not self.can_import(req, kv_len, len(blocks)):
            return None
        need = kv_len + req.max_new_tokens
        nb = max(-(-need // self.block_size), len(blocks))
        while len(self._free_blocks) < nb:
            self._evict_one()
        slot = self._free_slots.pop()
        row = self.tables[slot]
        row[:] = 0
        private = self._slot_private[slot]
        for j in range(nb):
            blk = self._free_blocks.pop()
            row[j] = blk
            private.append(blk)
            if j < len(blocks):
                _write_block(self.pool, blk, blocks[j])
        self.requests[slot] = req
        self._pending[slot] = []
        self.kv_len[slot] = 0
        self._live[slot] = False
        self.insert(slot, kv_len)
        return slot

    # --------------------------------------------------------------- eviction
    def _evict_one(self) -> None:
        """Reclaim the LRU-oldest refcount-0 shared block: entropy-code it to
        the cold tier when a codec is configured, else drop it."""
        if not self._lru:
            raise RuntimeError("no evictable blocks (all referenced)")
        blk, key = self._lru.popitem(last=False)
        del self._chain[key]
        del self._refs[blk]
        del self._block_key[blk]
        if self.cold is not None:
            leaves = _read_block(self.pool, blk)
            with obs_trace.span("kv.cold_encode", block=blk):
                self.cold.put(key, leaves)
            with self._stats_lock:
                self.cold_evictions += 1
            obs_metrics.counter("kv.cold_evictions").inc()
        else:
            with self._stats_lock:
                self.dropped_evictions += 1
            obs_metrics.counter("kv.dropped_evictions").inc()
        _zero_block(self.pool, blk)
        self._free_blocks.append(blk)
