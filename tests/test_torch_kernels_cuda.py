"""The port's CUDA decode kernels on the card, against their plain PyTorch
versions and the port's host decoders, bitwise.

Every test needs an NVIDIA card and ``nvcc`` (marker ``cuda``) and skips
elsewhere.  The file imports neither ``jax`` nor the JAX package, so it runs
on a machine that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Cases cover both families at the load path's stream shape, a block of more
than 128 lanes, zero-count and short lanes, and every table placement of
the tANS kernel: static shared memory (``table_log`` 10, 12), the opt-in
dynamic shared memory (14) and global memory (16).
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


def _case(codec, bits, table_log, n_streams, count, seed):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, (n_streams, count))),
                  0, hi - 1).astype(np.uint8)
    freqs = np.bincount(sym.ravel(), minlength=hi).astype(np.int64)
    kw = {} if table_log is None else {"table_log": table_log}
    table = get_codec(codec).build(freqs, bits, max_code_len=12, **kw)
    counts = np.full(n_streams, count, np.int64)
    counts[0] = count // 3                      # a short lane
    counts[2 % n_streams] = 0                   # an empty lane
    streams = [table.encode(sym[i, :counts[i]])[0] for i in range(n_streams)]
    mat, _ = bitstream.pack_streams(streams)
    return table, mat, counts


def _run(table, mat, counts, dev, plain=False):
    a = table.decode_arrays()
    m = torch.from_numpy(mat).to(dev)
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
