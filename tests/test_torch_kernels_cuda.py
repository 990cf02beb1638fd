"""The port's CUDA kernels on the card: the decode kernels against their
plain PyTorch versions and the port's host decoders, bitwise; the fused
decode→dequant→matmul kernels against their plain version within 1e-2
(both sum exact bf16 products in float32, in other orders), and bitwise on
one-hot rows of x, which pick rows of the dequantized weight.

Every test needs an NVIDIA card and ``nvcc`` (marker ``cuda``) and skips
elsewhere.  The file imports neither ``jax`` nor the JAX package, so it runs
on a machine that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases cover both families at the load path's stream shape, a block of more
than 128 lanes, zero-count and short lanes, and every table placement of
the tANS kernel: shared memory (``table_log`` 10, 12, 14) and a global
scratch copy (16).  The prefix kernel's split decode runs every code width
of ``huffman`` and ``raw`` (1 to 8 bits), rows whose width is no multiple
of 4 in a buffer that starts one byte into its allocation (S = 1, 8, 300,
both families), counts that end inside the first subsequence, a table in
global memory (``max_len`` 16), and reports its sync passes (at least one
for Huffman-8 at the load shape, none for raw); both decode kernels report
their longest block's SM cycles, and the library alone decides which tables
go to a global scratch copy; every case also compares two launches
bitwise.  The fused kernels run
both families at M = 1, 4, 128 and N = 64, 1024, 2048, and at the main
path's four shapes with 65,536-symbol lanes (``wo`` Huffman-8 2048 x 2048;
``wq``, ``wk``, ``w_down`` rANS-4 2048 x 2048, 2048 x 1024, 6144 x 2048) at
M = 1, 4, 17, 128, within 1e-2 of x @ deq(the decode kernel's symbols);
with lanes packed four times wider than they need, tANS tables at
``table_log`` 10 and 14 (shared memory) and 15 and 16 (global), a prefix
table at ``max_len`` 15 (global), an affine along K, lanes cut into column
tiles, two launches compared bitwise (the lanes are summed in a fixed
order), the library's placement test, the kernels' stats, and the inputs
the wrapper refuses.  The dequant→matmul kernel runs the JAX package's
test shapes (ragged ones, which its plan sends to the edge variant), the
main path's layer shapes at M = 4 and 128 and ``lm_head``'s 2048 x 152064
at M = 4, forced splits of K (K no multiple of the split or of a stage, K
below a stage, one split, a split a stage), and views one element into
a buffer (the edge variant; the kernel refuses the ring there), uint8 and
K-packed uint4, per-tensor and per-channel affine, within 1e-2 of its
plain version and bitwise over two launches (a split's partials are
summed in split order); one-hot rows give the dequantized weight bitwise
in the edge variant and the ring at every tile height, and x = I does so
with an affine that a contracted multiply-add would round differently.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitstream
from repro_torch.core import decode_backends as db
from repro_torch.core.codecs import get_codec
from repro_torch.kernels import ans_decode, build, huffman_decode

CASES = [("huffman", 8, None), ("raw", 8, None), ("raw", 4, None),
         ("rans", 4, None), ("rans", 8, None), ("rans", 8, 14),
         ("rans", 8, 16)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(codec, bits, counts, seed, *, min_width=0, max_len=12,
          table_log=None, max_count=None):
    """One table, built from ``max_count`` (default the largest count)
    seeded symbols a stream, and its streams at the given counts, packed at
    ``min_width``."""
    counts = np.asarray(counts, np.int64)
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    n = int(counts.max()) if max_count is None else max_count
    sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, (len(counts), n))),
                  0, hi - 1).astype(np.uint8)
    kw = {} if table_log is None else {"table_log": table_log}
    table = get_codec(codec).build(np.bincount(sym.ravel(), minlength=hi),
                                   bits, max_code_len=max_len, **kw)
    streams = [table.encode(sym[i, :c])[0] for i, c in enumerate(counts)]
    mat, _ = bitstream.pack_streams(streams, min_width=min_width)
    return table, mat, counts


def _on_card(mat, dev, offset):
    """``mat`` on the card as a contiguous view that starts ``offset`` bytes
    into a larger buffer."""
    buf = torch.zeros(offset + mat.size, dtype=torch.uint8, device=dev)
    buf[offset:] = torch.from_numpy(mat.ravel()).to(dev)
    return buf[offset:].view(mat.shape)


def _case(codec, bits, table_log, n_streams, count, seed):
    counts = np.full(n_streams, count, np.int64)
    counts[0] = count // 3                      # a short lane
    counts[2 % n_streams] = 0                   # an empty lane
    return _rows(codec, bits, counts, seed, table_log=table_log,
                 max_count=count)


def _run(table, mat, counts, dev, plain=False, offset=0):
    a = table.decode_arrays()
    m = _on_card(mat, dev, offset)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    mc = int(counts.max())
    if table.kernel == "prefix":
        tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
                for k in ("lut_sym", "lut_len")]
        fn = (huffman_decode.decode_streams_plain if plain
              else huffman_decode.decode_streams)
        return fn(m, c, *tabs, max_len=table.peek_bits, max_count=mc)
    tabs = [torch.from_numpy(a[k].astype(np.int32)).to(dev)
            for k in ("tab_sym", "tab_bits", "tab_base")]
    fn = (ans_decode.decode_streams_tans_plain if plain
          else ans_decode.decode_streams_tans)
    return fn(m, c, *tabs, table_log=table.table_log, max_count=mc)


def _host(table, mat, counts):
    return db.get_backend("numpy").decode_table(table, mat, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits,table_log", CASES)
def test_kernel_equals_plain_and_host(card, codec, bits, table_log):
    table, mat, counts = _case(codec, bits, table_log, 130, 700, seed=bits)
    name = "huffman_decode" if table.kernel == "prefix" else "ans_decode"
    before = build.launches[name]
    got = _run(table, mat, counts, card)
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, _run(table, mat, counts, card, plain=True))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _host(table, mat, counts))


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_kernel_at_load_path_shape(card, codec, bits):
    """8 streams of 65,536 symbols, one decode call of the load path,
    against the host decoder (the plain loop is too slow to repeat here)."""
    table, mat, counts = _case(codec, bits, None, 8, 65536, seed=3)
    got = _run(table, mat, counts, card)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _host(table, mat, counts))


@pytest.mark.cuda
def test_cuda_backend_fills_out_buffer(card):
    table, mat, counts = _case("rans", 4, None, 5, 300, seed=1)
    out = np.full((7, 320), -1, np.int32)
    got = db.get_backend("cuda").decode_table(table, mat, counts, out=out)
    assert got.base is out
    np.testing.assert_array_equal(got, _host(table, mat, counts))
    assert (out[5:] == -1).all()


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(card):
    table, mat, counts = _case("huffman", 8, None, 4, 100, seed=2)
    a = table.decode_arrays()
    m = torch.from_numpy(mat).to(card)
    c32 = torch.from_numpy(counts.astype(np.int32)).to(card)
    ls = torch.from_numpy(a["lut_sym"].astype(np.int32)).to(card)
    ll = torch.from_numpy(a["lut_len"].astype(np.int32)).to(card)
    kw = dict(max_len=table.peek_bits, max_count=100)
    with pytest.raises(ValueError, match="counts"):
        huffman_decode.decode_streams(m, c32.long(), ls, ll, **kw)
    with pytest.raises(ValueError, match="device|inputs on"):
        huffman_decode.decode_streams(m, c32.cpu(), ls, ll, **kw)
    with pytest.raises(ValueError, match="cover"):
        huffman_decode.decode_streams(m, c32, ls[:8], ll[:8], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        huffman_decode.decode_streams(m.t().contiguous().t(), c32, ls, ll,
                                      **kw)
    # the kernels count bits in 32-bit integers
    wide = torch.zeros((1, huffman_decode.MAX_ROW_BYTES), dtype=torch.uint8,
                       device=card)
    with pytest.raises(ValueError, match="rows of"):
        huffman_decode.decode_streams(wide, c32[:1], ls, ll, **kw)


# ---------------------------------- split prefix decode, tANS chain per block

def _assert_exact(table, mat, counts, dev, offset=0, plain=True):
    """Two kernel launches bitwise equal to each other, to the host decoder
    and (unless ``plain`` is False: its loop takes seconds at 65,536
    symbols) to the plain version on the same card inputs."""
    got = _run(table, mat, counts, dev, offset=offset)
    again = _run(table, mat, counts, dev, offset=offset)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if plain:
        assert torch.equal(got, _run(table, mat, counts, dev, plain=True,
                                     offset=offset))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _host(table, mat, counts))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("codec", ["huffman", "raw"])
def test_prefix_kernel_every_code_width(card, codec, bits):
    table, mat, counts = _rows(codec, bits, [4096, 1365, 0, 4096, 7],
                               seed=bits)
    _assert_exact(table, mat, counts, card)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8, 300])
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_decode_kernels_take_rows_at_any_width_and_address(card, codec, bits,
                                                           S):
    """Rows of a width that is no multiple of 4, in a buffer that starts one
    byte into its allocation: every row at another alignment."""
    rng = np.random.default_rng(S)
    counts = rng.integers(0, 3000, S)
    counts[0] = 3000
    table, mat, counts = _rows(codec, bits, counts, seed=S,
                               min_width=2 * 3000 + 3)
    assert mat.shape[1] % 4 == 3
    _assert_exact(table, mat, counts, card, offset=1)


@pytest.mark.cuda
def test_prefix_kernel_count_inside_first_subsequence(card):
    """A 65,536-symbol row cut into 516-bit subsequences, beside a stream of
    5 symbols and one of 1: their counts end inside subsequence 0 (against
    the host decoder)."""
    table, mat, counts = _rows("huffman", 8, [5, 65536, 1], seed=4,
                               min_width=65536)
    assert mat.shape[1] == 65536
    _assert_exact(table, mat, counts, card, offset=2, plain=False)


@pytest.mark.cuda
@pytest.mark.parametrize("table_log", [10, 12, 14, 16])
def test_tans_kernel_tables_in_shared_and_global_memory(card, table_log):
    """Up to 2^14 entries the interleaved table is staged in shared memory;
    at 2^16 it is built in a global scratch buffer."""
    table, mat, counts = _rows("rans", 8, [5000, 17, 0, 5000], seed=table_log,
                               table_log=table_log)
    _assert_exact(table, mat, counts, card, offset=3)


@pytest.mark.cuda
def test_prefix_kernel_table_in_global_memory(card):
    """max_len 16: 2^16 8-byte entries do not fit a block, so the kernel
    reads them from the scratch copy."""
    table, mat, counts = _rows("huffman", 8, [3000, 1000, 3000], seed=16,
                               max_len=16)
    assert table.peek_bits == 16
    _assert_exact(table, mat, counts, card, offset=1)


@pytest.mark.cuda
def test_prefix_kernel_reports_sync_passes(card):
    """At the load shape a Huffman-8 launch needs at least one sync pass; a
    raw code's subsequences start on codewords and need none."""
    for codec, passes in (("huffman", range(1, 1025)), ("raw", [0])):
        table, mat, counts = _rows(codec, 8, [65536] * 8, seed=5)
        _assert_exact(table, mat, counts, card, plain=False)
        assert huffman_decode.sync_passes(card) in passes


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits,entry", [("huffman", 8, "prefix_decode"),
                                              ("rans", 4, "tans_decode")])
def test_decode_kernels_report_block_cycles(card, codec, bits, entry):
    """Each launch records the SM cycles of its longest block: at least one
    a symbol of the longest stream (a tANS block decodes its stream one
    symbol a step), and no sync pass for tANS."""
    table, mat, counts = _rows(codec, bits, [20000, 3, 0], seed=6)
    _run(table, mat, counts, card)
    passes, cycles = huffman_decode.launch_stats(entry, card)
    assert cycles >= 20000
    if entry == "tans_decode":
        assert passes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("log,fits", [(12, True), (14, True), (15, False),
                                      (16, False)])
def test_table_placement_asked_of_the_library(card, log, fits):
    """The wrappers allocate a global scratch table exactly when the
    library says 2^log 8-byte entries do not fit a block."""
    lib = build.load()
    assert bool(lib.decode_table_fits_shared(log)) == fits
    scratch = huffman_decode.table_scratch(lib, log, card)
    assert (scratch is None) == fits
    if not fits:
        assert scratch.numel() * 4 == 8 << log


# ------------------------------------------------- fused decode -> matmul

def _fused(codec, bits, K, N, seg, dev, *, table_log=None, per_row=False,
           seed=0, max_len=12, pad=1, k_affine=False):
    """A FusedQT on ``dev`` laid out as compressed-resident serving lays a
    layer slice out (per-segment encode, one pow2 width, ``pad`` times wider
    when the width comes from a larger layer), and its symbols.  The affine
    is one pair, a (1, N) row of pairs (``per_row``), or a (K, 1) scale
    beside a (1, N) zero (``k_affine``: strides along K)."""
    from repro_torch.kernels.fused_decode_matmul import build_fused_qt
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, K * N)), 0,
                  hi - 1).astype(np.uint8)
    kw = {} if table_log is None else {"table_log": table_log}
    table = get_codec(codec).build(np.bincount(sym, minlength=hi), bits,
                                   max_code_len=max_len, **kw)
    streams = [table.encode(sym[i:i + seg])[0]
               for i in range(0, sym.size, seg)]
    width = pad * bitstream.pow2_bucket(
        max(bitstream.GUARD_BYTES, max(s.size for s in streams)), 64)
    mat, _ = bitstream.pack_streams(streams, min_width=width)
    shape = (1, N) if per_row else (1, 1)
    scale = (0.002 + rng.random(shape) * 0.01).astype(np.float32)
    zero = (rng.random(shape) * 0.2 - 0.1).astype(np.float32)
    if k_affine:
        scale = (0.002 + rng.random((K, 1)) * 0.01).astype(np.float32)
        zero = (rng.random((1, N)) * 0.2 - 0.1).astype(np.float32)
    fq = build_fused_qt(table, mat, scale, zero, seg_symbols=seg, K=K, N=N,
                        bits=bits, device=dev)
    return fq, sym.reshape(K, N)


FUSED_ATOL = FUSED_RTOL = 1e-2      # the JAX package's kernel tolerance


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
@pytest.mark.parametrize("K,N", [(512, 64), (128, 1024), (64, 2048)])
def test_fused_kernel_close_to_plain_and_onehot_bitwise(card, codec, bits,
                                                        K, N):
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq
    fq, sym = _fused(codec, bits, K, N, 4096, card, per_row=N == 1024)
    name = "fused_prefix" if codec == "huffman" else "fused_tans"
    w = deq(QT(torch.from_numpy(sym).to(card), fq.scale, fq.zero))
    rng = np.random.default_rng(K)
    for M in (1, 4, 128):
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(
            np.float32)).to(card, torch.bfloat16)
        before = build.launches[name]
        got = fdm.fused_decode_matmul(x, fq)
        torch.cuda.synchronize()
        assert build.launches[name] == before + 1
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
        ref = fdm.fused_decode_matmul_plain(x, fq)
        torch.testing.assert_close(got.float(), ref.float(), atol=FUSED_ATOL,
                                   rtol=FUSED_RTOL)
        # a second launch sums the lanes in the same order: bitwise equal
        assert torch.equal(got, fdm.fused_decode_matmul(x, fq))
    # one-hot rows pick rows of the dequantized weight, exactly
    rows = torch.tensor([0, K // 2, K - 1], device=card)
    onehot = torch.zeros((3, K), dtype=torch.bfloat16, device=card)
    onehot[torch.arange(3, device=card), rows] = 1
    assert torch.equal(fdm.fused_decode_matmul(onehot, fq), w[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_fused_kernel_tiles_the_columns_of_long_lanes(card, codec, bits):
    """Lanes of 96 rows x 1536 columns do not fit one block's 64 KiB, so
    each lane is walked once per column tile (682, 682 and 172 wide)."""
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq
    K, N, seg = 192, 1536, 96 * 1536
    fq, sym = _fused(codec, bits, K, N, seg, card, per_row=True)
    assert fdm.SYM_TILE_BYTES // (seg // N) == 682
    w = deq(QT(torch.from_numpy(sym).to(card), fq.scale, fq.zero))
    rows = torch.tensor([0, 95, 96, K - 1], device=card)
    onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=card)
    onehot[torch.arange(4, device=card), rows] = 1
    assert torch.equal(fdm.fused_decode_matmul(onehot, fq), w[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("table_log", [10, 14, 15, 16])
def test_fused_tans_tables_in_shared_and_global_memory(card, table_log):
    """Up to 2^14 entries the table sits in shared memory beside the symbol
    tile; at 2^15 and 2^16 it is read from a global scratch copy."""
    from repro_torch.kernels import fused_decode_matmul as fdm
    fq, _ = _fused("rans", 8, 64, 256, 2048, card, table_log=table_log)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (4, 64)).astype(np.float32)).to(card, torch.bfloat16)
    torch.testing.assert_close(fdm.fused_decode_matmul(x, fq).float(),
                               fdm.fused_decode_matmul_plain(x, fq).float(),
                               atol=FUSED_ATOL, rtol=FUSED_RTOL)


@pytest.mark.cuda
def test_fused_prefix_table_in_global_memory(card):
    """max_len 15: 2^15 8-byte entries and a symbol tile do not fit a
    block, so the kernel reads the table from the scratch copy."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_decode_matmul as fdm
    fq, _ = _fused("huffman", 8, 64, 256, 4096, card, max_len=15)
    assert fq.tbits == 15
    R = fq.seg // fq.N
    assert fdm.table_scratch(build.load(), fq, R * fq.N, card) is not None
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (17, 64)).astype(np.float32)).to(card, torch.bfloat16)
    torch.testing.assert_close(fdm.fused_decode_matmul(x, fq).float(),
                               fdm.fused_decode_matmul_plain(x, fq).float(),
                               atol=FUSED_ATOL, rtol=FUSED_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("log,sym_bytes,fits", [
    (10, 65536, True), (12, 65536, True), (14, 65536, True),
    (15, 65536, False), (15, 0, False), (16, 4096, False)])
def test_fused_table_placement_asked_of_the_library(card, log, sym_bytes,
                                                     fits):
    """The library counts the symbol tile beside the table; the wrapper
    allocates a scratch table exactly when the library says so."""
    from repro_torch.kernels import build
    lib = build.load()
    assert bool(lib.fused_table_fits_shared(log, sym_bytes)) == fits


def _main_shape_check(fq, sym, dev, rows_m):
    """The fused kernel on ``fq`` at each M of ``rows_m``: within 1e-2 of
    x @ deq(symbols the decode kernel gives), two launches bitwise equal,
    one-hot rows bitwise the dequantized weight's rows, and the kernel's
    stats of its last launch."""
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq
    S, K, N = fq.mat.shape[0], fq.K, fq.N
    counts = torch.full((S,), fq.seg, dtype=torch.int32, device=dev)
    if fq.family == "prefix":
        q = huffman_decode.decode_streams(fq.mat, counts, *fq.tabs,
                                          max_len=fq.tbits, max_count=fq.seg)
    else:
        q = ans_decode.decode_streams_tans(fq.mat, counts, *fq.tabs,
                                           table_log=fq.tbits,
                                           max_count=fq.seg)
    q = q.reshape(K, N).to(torch.uint8)
    assert np.array_equal(q.cpu().numpy(), sym)
    w = deq(QT(q, fq.scale, fq.zero))
    name = f"fused_{fq.family}"
    rng = np.random.default_rng(K + N)
    for M in rows_m:
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(
            np.float32)).to(dev, torch.bfloat16)
        before = build.launches[name]
        got = fdm.fused_decode_matmul(x, fq)
        torch.cuda.synchronize()
        assert build.launches[name] == before + 1
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
        torch.testing.assert_close(got.float(), (x @ w).float(),
                                   atol=FUSED_ATOL, rtol=FUSED_RTOL)
        assert torch.equal(got, fdm.fused_decode_matmul(x, fq))
    passes, cycles = fdm.launch_stats(f"{name}_matmul", dev)
    assert cycles > 0 and passes >= 0
    if fq.family == "tans":
        assert passes == 0 and cycles >= fq.seg
    rows = torch.tensor([0, 1, K // 2, K - 1], device=dev)
    onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=dev)
    onehot[torch.arange(4, device=dev), rows] = 1
    assert torch.equal(fdm.fused_decode_matmul(onehot, fq), w[rows])


MAIN_FUSED = [("huffman", 8, 2048, 2048), ("rans", 4, 2048, 2048),
              ("rans", 4, 2048, 1024), ("rans", 4, 6144, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits,K,N", MAIN_FUSED,
                         ids=["wo", "wq", "wk", "w_down"])
def test_fused_kernels_at_the_main_path_shapes(card, codec, bits, K, N):
    """qwen3-1.7b's layer matrices as the resident path fuses them, 65,536-
    symbol lanes: wo Huffman-8, wq, wk (64 rows a lane) and w_down (192
    lanes) rANS-4, at a decode step, a ragged row count and a prefill."""
    fq, sym = _fused(codec, bits, K, N, 65536, card, per_row=True, seed=K)
    _main_shape_check(fq, sym, card, (1, 4, 17, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_fused_kernels_on_zero_padded_lanes(card, codec, bits):
    """Lanes packed four times wider than their streams need, as one pow2
    width across layers packs a small layer's lanes: the prefix kernel's
    sync passes end once the exact prefix holds the lane's symbols, not
    when the padding agrees."""
    fq, sym = _fused(codec, bits, 256, 2048, 65536, card, pad=4, seed=1)
    assert fq.mat.shape[1] >= 4 * 32768
    _main_shape_check(fq, sym, card, (4, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_fused_kernels_take_an_affine_along_k(card, codec, bits):
    """A (K, 1) scale beside a (1, N) zero: every weight reads its own
    pair, within 1e-2 of the plain version, one-hot rows bitwise."""
    from repro_torch.kernels import fused_decode_matmul as fdm
    from repro_torch.models.layers import QT, deq
    K, N = 256, 512
    fq, sym = _fused(codec, bits, K, N, 8192, card, k_affine=True, seed=3)
    w = deq(QT(torch.from_numpy(sym).to(card), fq.scale, fq.zero))
    for M in (4, 128):
        x = torch.from_numpy(np.random.default_rng(M).normal(
            0, 1, (M, K)).astype(np.float32)).to(card, torch.bfloat16)
        torch.testing.assert_close(
            fdm.fused_decode_matmul(x, fq).float(),
            fdm.fused_decode_matmul_plain(x, fq).float(), atol=FUSED_ATOL,
            rtol=FUSED_RTOL)
    rows = torch.tensor([0, 31, 32, K - 1], device=card)
    onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=card)
    onehot[torch.arange(4, device=card), rows] = 1
    assert torch.equal(fdm.fused_decode_matmul(onehot, fq), w[rows])


@pytest.mark.cuda
def test_fused_wrapper_rejects_bad_inputs(card):
    from repro_torch.kernels import fused_decode_matmul as fdm
    fq, _ = _fused("huffman", 8, 16, 64, 256, card)
    x = torch.ones((2, 16), dtype=torch.bfloat16, device=card)
    bad = fdm.FusedQT(fq.mat, fq.tabs, fq.scale, fq.zero, family=fq.family,
                      tbits=fq.tbits, seg=fq.seg, K=fq.K, N=48, bits=8)
    with pytest.raises(ValueError, match="misaligned"):
        fdm.fused_decode_matmul(torch.ones((2, 16), dtype=torch.bfloat16,
                                           device=card), bad)
    cpu_fq, _ = _fused("huffman", 8, 16, 64, 256, "cpu")
    with pytest.raises(ValueError, match="inputs on"):
        fdm.fused_decode_matmul(x, cpu_fq)
    with pytest.raises(ValueError, match="no fused decode matmul"):
        fdm.fused_decode_matmul(x.cpu(), fq)
    with pytest.raises(ValueError, match="bf16"):
        fdm.fused_decode_matmul(x.float(), fq)


# ------------------------------------------------ dequant -> matmul

DQ_ATOL = DQ_RTOL = 1e-2     # tests/test_kernels.py's tolerance: the kernel
                             # and cuBLAS sum exact bf16 products in float32
                             # in other orders


def _dq_inputs(M, K, N, int4, per_channel, dev, seed=0):
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16 if int4 else 256, size=(K, N)).astype(np.uint8)
    wq = ops.pack_nibbles(q) if int4 else q
    if per_channel:
        scale = rng.uniform(1e-3, 1e-2, size=(N,)).astype(np.float32)
        zero = rng.uniform(-1, 0, size=(N,)).astype(np.float32)
    else:
        scale, zero = np.float32(0.005), np.float32(-0.6)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(
        dev, torch.bfloat16)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,  # noqa: E731
                                    device=dev)
    return x, torch.from_numpy(wq).to(dev), f32(scale), f32(zero)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,int4", [
    (8, 128, 64, False), (64, 384, 200, False), (128, 512, 128, False),
    (1, 1024, 96, False), (33, 257, 65, False), (16, 256, 128, True),
    (8, 130, 48, True), (4, 2048, 1024, True), (128, 640, 2048, True)])
@pytest.mark.parametrize("per_channel", [True, False])
def test_dequant_matmul_close_to_plain(card, M, K, N, int4, per_channel):
    from repro_torch.kernels import dequant_matmul as dm
    args = _dq_inputs(M, K, N, int4, per_channel, card, seed=M + K + N)
    before = build.launches["dequant_matmul"]
    got = dm.dequant_matmul(*args, int4=int4)
    torch.cuda.synchronize()
    assert build.launches["dequant_matmul"] == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    ref = dm.dequant_matmul_plain(*args, int4=int4)
    torch.testing.assert_close(got.float(), ref.float(), atol=DQ_ATOL,
                               rtol=DQ_RTOL)
    # a tile's partials are summed in split order: a second launch is
    # bitwise
    assert torch.equal(got, dm.dequant_matmul(*args, int4=int4))


@pytest.mark.cuda
@pytest.mark.parametrize("variant,K", [("edge", 130), ("ring", 136)])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_dequant_matmul_rounds_product_and_sum_separately(card, int4,
                                                          per_channel,
                                                          variant, K):
    """x = I gives the dequantized weight bitwise, with the affine chosen so
    that a contracted multiply-add would move some weights by a bf16 step,
    in the edge variant (K = 130 is no multiple of 8) and the ring at each
    of its tile heights."""
    import dequant_cases
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    N, qmax = 48, 15 if int4 else 255
    if per_channel:
        q, scale, zero = dequant_cases.fma_pinning_case(5 + int4, K, N, qmax)
    else:
        s, z, qs = dequant_cases.fma_sensitive(7 + int4, 1, qmax)
        scale, zero = s[0], z[0]
        q = np.random.default_rng(5).integers(0, qmax + 1, size=(K, N)) \
            .astype(np.uint8)
        q[::7] = qs[0]
    w = dequant_cases.dequant_two_roundings(q, scale, zero)
    assert (w != dequant_cases.dequant_one_rounding(q, scale, zero)).any()
    wq = torch.from_numpy(ops.pack_nibbles(q) if int4 else q).to(card)
    st, zt = ops._affine(scale, card), ops._affine(zero, card)
    for rows in (np.arange(K), np.array([0, 1, 64, K - 1])):
        x = torch.zeros((len(rows), K), dtype=torch.bfloat16, device=card)
        x[torch.arange(len(rows)), torch.from_numpy(rows)] = 1
        plans = ([dm.plan_for(x, wq, int4=int4)] if variant == "edge" else
                 [dm.plan(len(rows), K, N, int4=int4, bm=bm)
                  for bm in dm.RING_BM])
        for p in plans:
            assert p.variant == variant
            got = dm._launch(x, wq, st, zt, int4, p)
            np.testing.assert_array_equal(got.float().cpu().numpy(), w[rows])


@pytest.mark.cuda
def test_dequant_matmul_wrapper_rejects_bad_inputs(card):
    from repro_torch.kernels import dequant_matmul as dm
    x, wq, s, z = _dq_inputs(4, 64, 32, False, True, card)
    with pytest.raises(ValueError, match="inputs on"):
        dm.dequant_matmul(x, wq.cpu(), s, z)
    with pytest.raises(ValueError, match="inputs on"):
        dm.dequant_matmul(x, wq, s.cpu(), z)
    with pytest.raises(ValueError, match="bf16"):
        dm.dequant_matmul(x.float(), wq, s, z)
    with pytest.raises(ValueError, match="contiguous"):
        dm.dequant_matmul(x, wq.t().contiguous().t(), s, z)
    with pytest.raises(ValueError, match="odd"):
        dm.dequant_matmul(x[:, :63].contiguous(), wq[:31], s, z, int4=True)
    with pytest.raises(ValueError, match="scale"):
        dm.dequant_matmul(x, wq, s[:31], z)
    before = build.launches["dequant_matmul"]
    out = dm.dequant_matmul(x[:0], wq, s, z)
    assert tuple(out.shape) == (0, 32)
    assert build.launches["dequant_matmul"] == before


def _dq_weight(wq, scale, zero, int4):
    """The kernel's dequantized weight, (K, N) bf16 (plain torch ops)."""
    from repro_torch.kernels import dequant_matmul as dm
    q = dm.unpack_k(wq) if int4 else wq
    return (q.float() * scale.reshape(1, -1) + zero.reshape(1, -1)).to(
        torch.bfloat16)


def _dq_check(args, int4, launch=None):
    """The kernel as planned (or as ``launch`` says) against the plain
    version within 1e-2, a second launch bitwise, one launch counted and
    its plan recorded."""
    from repro_torch.kernels import dequant_matmul as dm

    def run():
        if launch is None:
            return dm.dequant_matmul(*args, int4=int4)
        return dm._launch(*args, int4, launch)
    before = build.launches["dequant_matmul"]
    got = run()
    torch.cuda.synchronize()
    assert build.launches["dequant_matmul"] == before + 1
    assert dm.launch_plan(args[0].device) == (
        launch or dm.plan_for(args[0], args[1], int4=int4))
    ref = dm.dequant_matmul_plain(*args, int4=int4)
    torch.testing.assert_close(got.float(), ref.float(), atol=DQ_ATOL,
                               rtol=DQ_RTOL)
    # the split partials are summed in split order, not arrival order
    assert torch.equal(got, run())
    return got


def _split_plan(M, K, N, int4, splits, k_per_split, bm=None):
    """The ring's plan (at ``bm`` rows a tile), cut into ``splits`` of
    ``k_per_split``."""
    import dataclasses
    from repro_torch.kernels import dequant_matmul as dm
    p = dm.plan(M, K, N, int4=int4, bm=bm)
    return dataclasses.replace(
        p, splits=splits, k_per_split=k_per_split,
        workspace_bytes=4 * splits * M * N if splits > 1 else 0)


def _onehot_every_variant(args, int4, splits=None):
    """One-hot rows of x through the edge variant and the ring at each of
    its tile heights (as planned, or cut into ``splits`` = (splits,
    k_per_split)): each gives the dequantized weight's rows, bitwise."""
    from repro_torch.kernels import dequant_matmul as dm
    x, wq, scale, zero = args
    K, N = x.shape[1], wq.shape[1]
    pick = torch.tensor([0, 1, K // 2, K - 1], device=x.device)
    onehot = torch.zeros((4, K), dtype=torch.bfloat16, device=x.device)
    onehot[torch.arange(4, device=x.device), pick] = 1
    want = _dq_weight(wq, scale, zero, int4)[pick]
    plans = [dm.plan(4, K, N, int4=int4, aligned=False)]
    for bm in dm.RING_BM:
        plans.append(dm.plan(4, K, N, int4=int4, bm=bm) if splits is None
                     else _split_plan(4, K, N, int4, *splits, bm=bm))
    for p in plans:
        got = dm._launch(onehot, wq, scale, zero, int4, p)
        assert torch.equal(got, want), p


DQ_MAIN = [(K, N, int4) for K, N in ((2048, 1024), (2048, 2048),
                                     (2048, 6144), (6144, 2048))
           for int4 in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("K,N,int4", DQ_MAIN)
def test_dequant_matmul_at_the_main_path_shapes(card, M, K, N, int4):
    """The layer matrices' shapes at a decode step and a prefill: the ring
    variant, tiled and split as planned, within 1e-2 of the plain version,
    bitwise over two launches and on one-hot rows in every variant."""
    from repro_torch.kernels import dequant_matmul as dm
    args = _dq_inputs(M, K, N, int4, True, card, seed=K + N + M)
    p = dm.plan_for(args[0], args[1], int4=int4)
    assert p.variant == "ring"
    _dq_check(args, int4)
    _onehot_every_variant(args, int4)


@pytest.mark.cuda
def test_dequant_matmul_at_lm_head_width(card):
    """lm_head, 2048 x 152064 uint8 at M = 4: 1,188 tiles, unsplit."""
    from repro_torch.kernels import dequant_matmul as dm
    args = _dq_inputs(4, 2048, 152064, False, False, card, seed=11)
    p = dm.plan_for(args[0], args[1], int4=False)
    assert (p.variant, p.splits, p.tiles) == ("ring", 1, 1188)
    _dq_check(args, False)
    _onehot_every_variant(args, False)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,int4,splits,k_per_split", [
    (4, 1000, 256, False, 3, 384),    # K no multiple of the split or of 64
    (4, 1000, 256, True, 3, 384),
    (128, 1000, 256, True, 2, 512),
    (4, 40, 256, False, 1, 64),       # K < BK
    (128, 40, 144, True, 1, 64),
    (4, 2048, 1024, True, 1, 2048),   # one split where the plan splits
    (128, 2048, 1024, False, 1, 2048),
    (4, 8, 16, True, 1, 64),
    (5, 6144, 2048, True, 96, 64),    # a split a stage
])
def test_dequant_matmul_ring_splits(card, M, K, N, int4, splits,
                                    k_per_split):
    """Forced splits of the ring, each whole 64-deep stages but the last:
    within 1e-2, bitwise over two launches and on one-hot rows."""
    from repro_torch.kernels import dequant_matmul as dm
    args = _dq_inputs(M, K, N, int4, True, card, seed=K + splits)
    for bm in dm.RING_BM if M > 16 else dm.RING_BM[:1]:
        _dq_check(args, int4, launch=_split_plan(M, K, N, int4, splits,
                                                 k_per_split, bm=bm))
    _onehot_every_variant(args, int4, splits=(splits, k_per_split))


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "wq"])
@pytest.mark.parametrize("int4", [False, True])
def test_dequant_matmul_misaligned_pointer_takes_the_edge(card, operand,
                                                          int4):
    """A contiguous view one element into a flat buffer: the plan sends it
    to the edge variant, which agrees with the ring on the aligned copy;
    the kernel refuses the ring there."""
    from repro_torch.kernels import dequant_matmul as dm
    M, K, N = 4, 2048, 1024
    x, wq, s, z = _dq_inputs(M, K, N, int4, True, card, seed=2)
    src = x if operand == "x" else wq
    buf = torch.empty(src.numel() + 1, dtype=src.dtype, device=card)
    view = buf[1:1 + src.numel()].view(src.shape)
    view.copy_(src)
    args = (view, wq, s, z) if operand == "x" else (x, view, s, z)
    p = dm.plan_for(args[0], args[1], int4=int4)
    assert p.variant == "edge" and p.splits == 1
    got = _dq_check(args, int4)
    aligned = dm.dequant_matmul(x, wq, s, z, int4=int4)
    torch.testing.assert_close(got.float(), aligned.float(), atol=DQ_ATOL,
                               rtol=DQ_RTOL)
    for bm in dm.RING_BM:
        p = dm.plan(M, K, N, int4=int4, bm=bm)
        with pytest.raises(RuntimeError, match="dequant_matmul launch failed"):
            dm._launch(*args, int4, p)
