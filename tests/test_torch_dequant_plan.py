"""The dequant→matmul kernel's launch plan (``kernels.dequant_matmul.plan``)
and its split of K, on the CPU.

The plan decides, from shapes and addresses alone, which variant of the
CUDA kernel runs, how many rows a tile holds and how K is split across
blocks; the kernel runs only on the card, so its choices are held here:

- every k is summed by exactly one split, the splits are whole 64-deep
  stages but the last, and none is empty;
- at the 18 (matrix, M) pairs of ``chip_smoke.py``'s ``dequant_matmul``
  phase (qwen3-1.7b's layer matrices and ``lm_head`` at M = 4 and 128) the
  ring variant runs with at least 264 blocks (two an SM of the H100's 132)
  or at least 8 KiB of weight a block;
- shapes whose rows are no 16-byte multiple, and misaligned operands, go
  to the edge variant, unsplit;
- the workspace holds splits x M x N float32 partials.

A plain torch model of the kernel's split sum (float32 partials a split,
added in split order, cast to bf16 once) is held within 1e-2 of the plain
version and of the JAX package's ``ops.dequant_matmul`` in interpret mode,
and bitwise on one-hot rows of x.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ops as tops

import dequant_cases

TOL = dict(atol=1e-2, rtol=1e-2)

# (tensor, K, N, int4): the dequant_matmul phase's matrices
MAIN = [("wq", 2048, 2048, True), ("wk", 2048, 1024, True),
        ("wv", 2048, 1024, True), ("wo", 2048, 2048, False),
        ("w_gate", 2048, 6144, True), ("w_up", 2048, 6144, True),
        ("w_down", 6144, 2048, True), ("lm_head", 2048, 152064, False),
        ("w_down per-channel", 6144, 2048, True)]


def _covers_k_once(p, K):
    ranges = p.split_ranges(K)
    assert len(ranges) == p.splits
    assert p.k_per_split % dm.BK == 0
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == p.k_per_split
    assert all(k0 % dm.BK == 0 and k1 > k0 for k0, k1 in ranges)


@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 128, 300])
@pytest.mark.parametrize("K,N,int4", [(2048, 2048, True), (6144, 2048, True),
                                      (2048, 1024, False), (1000, 256, False),
                                      (40, 256, True), (8, 16, False),
                                      (2048, 152064, False)])
def test_plan_sums_every_k_once_in_whole_stages(M, K, N, int4):
    p = dm.plan(M, K, N, int4=int4)
    assert p.variant == "ring"
    _covers_k_once(p, K)
    for bm in dm.RING_BM:
        _covers_k_once(dm.plan(M, K, N, int4=int4, bm=bm), K)


@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("tensor,K,N,int4", MAIN, ids=[m[0] for m in MAIN])
def test_plan_fills_the_card_at_the_main_path_shapes(tensor, K, N, int4, M):
    p = dm.plan(M, K, N, int4=int4)
    weight_bytes = K * N // (2 if int4 else 1)
    assert p.variant == "ring"
    assert p.bm == 16 if M <= 16 else p.bm in dm.RING_BM
    assert p.blocks >= dm.MIN_BLOCKS or \
        weight_bytes / p.blocks >= dm.MIN_SPLIT_BYTES, p
    # the tile's last block reads at most MAX_FIXUP_BYTES of partials
    rows = min(M, p.bm)
    assert (p.splits - 1) * rows * p.bn * 4 <= dm.MAX_FIXUP_BYTES
    _covers_k_once(p, K)


def test_plan_tiles_by_regime():
    """16 rows at a decode step; above, 128 rows where those tiles alone
    fill the card (lm_head), else the fewest rows whose repeated dequant
    stays within MAX_DEQUANT weights."""
    assert dm.plan(4, 2048, 152064, int4=False).bm == 16
    assert dm.plan(128, 2048, 152064, int4=False).bm == 128
    assert dm.plan(128, 2048, 2048, int4=True).bm == 16
    assert dm.plan(128, 2048, 6144, int4=True).bm == 64
    assert dm.plan(128, 6144, 2048, int4=True).bm == 64
    assert dm.plan(4, 2048, 152064, int4=False).splits == 1


@pytest.mark.parametrize("M,K,N,int4", [(33, 257, 65, False),
                                        (8, 130, 48, True),
                                        (4, 2048, 1000, False),
                                        (128, 2044, 2048, True)])
def test_plan_sends_ragged_rows_to_the_edge(M, K, N, int4):
    p = dm.plan(M, K, N, int4=int4)
    assert (p.variant, p.splits, p.workspace_bytes) == ("edge", 1, 0)
    assert p.bm == (16 if M <= 16 else dm.KERNEL_BM)


@pytest.mark.parametrize("operand", ["x", "wq"])
def test_plan_sends_misaligned_operands_to_the_edge(operand):
    """A contiguous view one element into a flat buffer."""
    M, K, N = 4, 2048, 1024
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    wq = torch.zeros((K // 2, N), dtype=torch.uint8)
    assert dm.plan_for(x, wq, int4=True).variant == "ring"
    src = x if operand == "x" else wq
    view = torch.zeros(src.numel() + 1, dtype=src.dtype)[1:].view(src.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    args = (view, wq) if operand == "x" else (x, view)
    p = dm.plan_for(*args, int4=True)
    assert (p.variant, p.splits) == ("edge", 1)
    assert dm.plan(M, K, N, int4=True, aligned=False) == p


@pytest.mark.parametrize("M,K,N,int4", [(4, 2048, 2048, True),
                                        (128, 6144, 2048, True),
                                        (4, 512, 256, False),
                                        (17, 1000, 144, True),
                                        (4, 2048, 152064, False)])
def test_plan_workspace_is_a_partial_a_split(M, K, N, int4):
    for bm in dm.RING_BM:
        p = dm.plan(M, K, N, int4=int4, bm=bm)
        want = p.splits * M * N * 4 if p.splits > 1 else 0
        assert p.workspace_bytes == want
        assert p.tiles == -(-M // bm) * -(-N // dm.RING_BN)


def test_plan_is_made_once_a_shape():
    """The plan is a pure function of the shape: the wrapper's host cost
    a call is a cache lookup after the first."""
    p = dm.plan(4, 2048, 6144, int4=True)
    assert dm.plan(4, 2048, 6144, int4=True) is p
    assert dm.plan(4, 2048, 6144, int4=False) is not p


def test_cpu_call_runs_the_plain_version_and_records_no_plan():
    """A CPU tensor never reaches the kernel: the plain version's answer,
    no launch counted and no launch plan recorded."""
    from repro_torch.kernels import build
    x, _, wq, scale, zero = _case(4, 256, 64, True, True, 3)
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq),
            torch.from_numpy(scale), torch.from_numpy(zero))
    before = build.launches["dequant_matmul"]
    got = dm.dequant_matmul(*args, int4=True)
    assert torch.equal(got, dm.dequant_matmul_plain(*args, int4=True))
    assert build.launches["dequant_matmul"] == before
    assert dm.launch_plan("cpu") is None


# ------------------------------------------------- the split sum, modelled

def split_sum(x, wq, scale, zero, *, int4, launch):
    """The kernel's sum as ``launch`` splits it: per split a float32
    partial of exact bf16 products, the partials added in split order, one
    cast to bf16."""
    K = x.shape[1]
    q = dm.unpack_k(wq) if int4 else wq
    w = (q.float() * scale.reshape(1, -1) + zero.reshape(1, -1)).to(
        torch.bfloat16).float()
    xf = x.to(torch.bfloat16).float()
    total = None
    for k0, k1 in launch.split_ranges(K):
        part = xf[:, k0:k1] @ w[k0:k1]
        total = part if total is None else total + part
    return total.to(torch.bfloat16)


def _case(M, K, N, int4, per_channel, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16 if int4 else 256, size=(K, N)).astype(np.uint8)
    wq = tops.pack_nibbles(q) if int4 else q
    if per_channel:
        scale = rng.uniform(1e-3, 1e-2, size=(N,)).astype(np.float32)
        zero = rng.uniform(-1, 0, size=(N,)).astype(np.float32)
    else:
        scale, zero = np.float32(0.005), np.float32(-0.6)
    x = rng.normal(size=(M, K)).astype(np.float32)
    return x, q, wq, scale, zero


@pytest.mark.parametrize("M,K,N,int4", [(4, 512, 256, False),
                                        (4, 1024, 128, True),
                                        (33, 384, 144, True),
                                        (16, 1000, 64, False)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_split_sum_close_to_plain_and_jax(M, K, N, int4, per_channel):
    x, _, wq, scale, zero = _case(M, K, N, int4, per_channel, M + K + N)
    p = dm.plan(M, K, N, int4=int4)
    assert p.variant == "ring" and p.splits > 1
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, zt = (torch.as_tensor(v, dtype=torch.float32) for v in (scale, zero))
    got = split_sum(xt, torch.from_numpy(wq), st, zt, int4=int4, launch=p)
    plain = dm.dequant_matmul_plain(xt, torch.from_numpy(wq), st, zt,
                                    int4=int4)
    want = jops.dequant_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wq),
                               scale, zero, int4=int4)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("int4", [False, True])
def test_split_sum_bitwise_on_one_hot_rows(int4):
    """A one-hot row sums one exact product and zeros in any split: the
    dequantized weight's row, with both roundings."""
    K, N = 1024, 128
    qmax = 15 if int4 else 255
    q, scale, zero = dequant_cases.fma_pinning_case(11 + int4, K, N, qmax)
    wq = tops.pack_nibbles(q) if int4 else q
    rows = np.array([0, 1, 63, 64, 511, K - 1])
    x = np.zeros((len(rows), K), np.float32)
    x[np.arange(len(rows)), rows] = 1
    st, zt = torch.from_numpy(scale), torch.from_numpy(zero)
    for splits in (None, 2, K // dm.BK):
        p = dm.plan(len(rows), K, N, int4=int4)
        if splits is not None:
            p = dm.Plan(p.variant, p.bm, p.bn, p.bk, splits,
                        -(-K // splits // dm.BK) * dm.BK, p.tiles,
                        4 * splits * len(rows) * N)
        got = split_sum(torch.from_numpy(x), torch.from_numpy(wq), st, zt,
                        int4=int4, launch=p)
        np.testing.assert_array_equal(
            got.float().numpy(),
            dequant_cases.dequant_two_roundings(q, scale, zero)[rows])
