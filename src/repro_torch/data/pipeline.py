"""Deterministic token pipeline (port of ``repro/data/pipeline.py``, numpy
only, carried over unchanged in what it yields).

Two sources share one iterator protocol and yield numpy batches; the train
loop moves them to its device:

* :class:`SyntheticSource` — structured pseudo-text: a fixed Markov chain over
  the vocab (Zipf-ish unigram + bigram dependence) so losses actually decrease
  during training, seeded deterministically by (seed, step, shard).
  Restart-safe: batch content is a pure function of the step index, so a
  restarted run re-reads the exact stream.
* :class:`FileSource` — memmap over a flat uint32 token file, sharded by
  host; deterministic per step.

For the enc-dec family the batch also carries ``src_embeds``, the stubbed
modality frontend's output (precomputed frame embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: int = 0                 # this host's data shard index
    num_shards: int = 1
    src_embed_dim: int = 0         # > 0 => also emit src_embeds (encdec stub)
    src_len: Optional[int] = None


class SyntheticSource:
    """Markov-chain pseudo-text with a learnable structure (not iid noise)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_shards == 0
        self.local_batch = cfg.global_batch // cfg.num_shards
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # Zipf unigram + a sparse deterministic "grammar": each token has a
        # small set of likely successors. Stored compactly: 8 successors/token.
        self.succ = base.integers(0, v, size=(v, 8), dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.shard))            # content := f(step, shard)
        B, S = self.local_batch, cfg.seq_len
        toks = np.empty((B, S), dtype=np.int32)
        cur = rng.choice(cfg.vocab, size=B, p=self.unigram)
        toks[:, 0] = cur
        follow = rng.random((B, S)) < 0.8           # 80% grammar, 20% resample
        picks = rng.integers(0, 8, size=(B, S))
        resample = rng.choice(cfg.vocab, size=(B, S), p=self.unigram)
        for t in range(1, S):
            nxt = np.where(follow[:, t], self.succ[cur, picks[:, t]],
                           resample[:, t])
            toks[:, t] = nxt
            cur = nxt
        out = {"tokens": toks}
        if cfg.src_embed_dim:
            L = cfg.src_len or S
            out["src_embeds"] = rng.standard_normal(
                (B, L, cfg.src_embed_dim)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        """Restart-safe iterator: resume mid-stream after checkpoint restore."""
        while True:
            yield self.batch(step)
            step += 1


class FileSource:
    """Memmap-backed token stream, deterministic, host-sharded."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.uint32, mode="r")
        self.local_batch = cfg.global_batch // cfg.num_shards
        self.windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.local_batch, cfg.seq_len
        rng = np.random.default_rng((cfg.seed, step, cfg.shard))
        idx = rng.integers(0, self.windows, size=B)
        toks = np.stack([
            self.tokens[i * S: i * S + S].astype(np.int32) % cfg.vocab
            for i in idx
        ])
        return {"tokens": toks}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(step)
            step += 1

    def __iter__(self):
        return self.iter_from(0)
