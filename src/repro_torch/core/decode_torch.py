"""Host-side shape bucketing for the ``torch`` decoder backend (the
counterpart of the JAX package's ``core/decode_jax.py``).

The torch lock-step loops themselves are the decode kernels' plain
versions (:func:`repro_torch.kernels.huffman_decode.decode_streams_plain`,
:func:`repro_torch.kernels.ans_decode.decode_streams_tans_plain`);
:func:`bucket_streams` pads their input exactly as the JAX package pads
for its jit decoders, so the ``torch`` backend decodes the same padded
problem the ``jax`` backend does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .bitstream import pow2_bucket


def bucket_streams(mat: np.ndarray, counts: np.ndarray, max_count: int,
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Zero-pad (S, B) streams + counts so every dimension lands on a
    power-of-two bucket (padded lanes decode nothing: count 0).  Callers that
    pack with ``pack_streams(..., min_width=pow2_bucket(...))`` arrive with B
    already bucketed and skip the copy here."""
    S, B = mat.shape
    Sp = pow2_bucket(S, 8)
    Bp = pow2_bucket(B, 64)
    mc = pow2_bucket(max_count, 256)
    if (Sp, Bp) != (S, B):
        m = np.zeros((Sp, Bp), dtype=np.uint8)
        m[:S, :B] = mat
        mat = m
        counts = np.concatenate(
            [np.asarray(counts, np.int64), np.zeros(Sp - S, np.int64)])
    return mat, np.asarray(counts, np.int64), mc
