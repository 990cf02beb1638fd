"""Paged, compressible KV cache for continuous batching (PyTorch port of
``repro/serving/kvcache/``).

The subsystem splits along the device/host line:

* :mod:`repro_torch.models` owns the device side — ``init_kv_pool`` block
  pools and the ``paged_prefill_chunk`` / ``paged_decode_step`` twins that
  scatter/gather K/V through a block table (``api.supports_paged_kv``
  gates families);
* :class:`BlockKVManager` (here) owns the host side — block tables, free
  lists, prefix-chain refcounts, LRU eviction;
* :class:`ColdBlockStore` entropy-codes evicted shared blocks to host
  bytes via the ``core.codecs`` registry.

Policy comes in as :class:`repro_torch.core.spec.KVCompressionSpec` (the
``--kv-spec`` grammar).  ``kv_pool_bytes`` / ``kv_cache_bytes`` size a pool
or a slot cache without allocating it (the leaves are built on the ``meta``
device).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models import api
from .blocks import BlockKVManager
from .cold import ColdBlockStore

_META = torch.device("meta")


def _nbytes(leaves) -> int:
    return sum(t.numel() * t.element_size() for t in leaves.values())


def kv_pool_bytes(cfg: ArchConfig, n_blocks: int, block_size: int,
                  bits: int = 16) -> int:
    """Bytes of a paged KV pool (nothing allocated)."""
    return _nbytes(api.build(cfg).init_kv_pool(cfg, n_blocks, block_size,
                                               bits, device=_META))


def kv_cache_bytes(cfg: ArchConfig, n_slots: int, max_len: int) -> int:
    """Bytes of the bf16 slot cache — the dense reference budget."""
    return _nbytes(api.build(cfg).init_cache(cfg, n_slots, max_len,
                                             device=_META))


__all__ = ["BlockKVManager", "ColdBlockStore", "KVCompressionSpec",
           "kv_pool_bytes", "kv_cache_bytes"]
