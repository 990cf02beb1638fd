"""Inputs for the dequant-matmul tests, numpy and torch only (the card's
tests import them too, on a machine without JAX)."""
import numpy as np
import torch


def bf16(a) -> np.ndarray:
    """float32 values rounded to bf16 (nearest even), back as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def dequant_two_roundings(q, scale, zero) -> np.ndarray:
    """``bf16(f32(f32(q * scale) + zero))``: the kernels' dequant."""
    s = np.asarray(scale, np.float32).reshape(1, -1)
    z = np.asarray(zero, np.float32).reshape(1, -1)
    return bf16((q.astype(np.float32) * s).astype(np.float32) + z)


def dequant_one_rounding(q, scale, zero) -> np.ndarray:
    """``bf16(f32(q * scale + zero))`` with the product exact: what a fused
    multiply-add gives."""
    s = np.asarray(scale, np.float64).reshape(1, -1)
    z = np.asarray(zero, np.float64).reshape(1, -1)
    return bf16((q.astype(np.float64) * s + z).astype(np.float32))


def fma_sensitive(seed: int, n: int, qmax: int):
    """``n`` float32 (scale, zero) pairs, each with a symbol ``q <= qmax``
    whose bf16 weight differs between one rounding and two (about 2 in
    100,000 random (pair, symbol) draws do): returns scale, zero and that
    symbol, each of length ``n``."""
    rng = np.random.default_rng(seed)
    q = np.arange(qmax + 1)
    found = [[], [], []]
    while len(found[0]) < n:
        s = rng.uniform(1e-3, 3e-2, 65536).astype(np.float32)
        z = rng.uniform(-1, 0.5, 65536).astype(np.float32)
        qq = np.broadcast_to(q, (65536, qmax + 1))
        diff = (dequant_two_roundings(qq.T, s, z)
                != dequant_one_rounding(qq.T, s, z)).T
        for i in np.nonzero(diff.any(axis=1))[0]:
            found[0].append(s[i])
            found[1].append(z[i])
            found[2].append(int(np.argmax(diff[i])))
    return (np.array(found[0][:n], np.float32),
            np.array(found[1][:n], np.float32),
            np.array(found[2][:n], np.uint8))


def fma_pinning_case(seed: int, K: int, N: int, qmax: int):
    """A (K, N) symbol matrix with per-channel affine where every column
    holds, at a random row, a symbol whose bf16 weight tells one rounding
    from two."""
    scale, zero, qs = fma_sensitive(seed, N, qmax)
    rng = np.random.default_rng(seed + 1)
    q = rng.integers(0, qmax + 1, size=(K, N)).astype(np.uint8)
    q[rng.integers(0, K, size=N), np.arange(N)] = qs
    return q, scale, zero
