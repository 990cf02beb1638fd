"""Decode parity: the port's kernel plain versions and decoder backends
against the JAX package, bitwise.

* Tiny case: the port's plain versions and its ``numpy`` / ``torch``
  backends equal the JAX package's Pallas kernels run with
  ``interpret=True`` (as ``tests/test_kernels.py`` runs them), for the
  prefix family (``huffman``, ``raw``) and the tANS family (``rans``).
* Main-path segment shape (8 streams of 65,536 symbols): the plain versions
  equal the JAX package's host decoders ``bitstream.decode_streams`` /
  ``decode_streams_tans``.
* Every backend × family × bits 1..8 × return / ``out=`` against the JAX
  package's serial oracles, with a zero-count lane mid-pack.
* No fallback: on this card-less host the ``cuda`` backend raises, and so
  does a wrapper handed a tensor it has no kernel for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as jbits
from repro.core.codecs import get_codec as jget_codec
from repro.kernels.ans_decode import decode_streams_tans_pallas
from repro.kernels.huffman_decode import decode_streams_pallas
from repro_torch.core import decode_backends as tdb
from repro_torch.core.codecs import get_codec as tget_codec
from repro_torch.kernels import ans_decode, build, huffman_decode

N_STREAMS, COUNT = 4, 96


def _streams(codec, bits, n_streams, count, *, seed, zero_lane=True,
             get_codec=jget_codec):
    """``n_streams`` encoded rows (plus a zero-count lane at index 2) under
    one table built with ``get_codec`` (the JAX package's by default)."""
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    # a peaked histogram, like quantized weights
    sym = np.clip(np.rint(rng.normal(hi / 2, hi / 6, n_streams * count)),
                  0, hi - 1).astype(np.uint8)
    freqs = np.bincount(sym, minlength=hi).astype(np.int64)
    if np.count_nonzero(freqs) < 2:
        freqs[(int(sym[0]) + 1) % hi] += 1
    table = get_codec(codec).build(freqs, bits, max_code_len=12)
    streams = [table.encode(sym[i * count:(i + 1) * count])[0]
               for i in range(n_streams)]
    counts = [count] * n_streams
    if zero_lane:
        streams.insert(2, np.zeros(0, np.uint8))
        counts.insert(2, 0)
    mat, _ = jbits.pack_streams(streams)
    return table, mat, np.asarray(counts, np.int64), sym.reshape(n_streams,
                                                                 count)


def _plain(table, mat, counts, max_count):
    """The port's kernel wrapper on CPU tensors (= its plain version)."""
    a = table.decode_arrays()
    m = torch.from_numpy(mat)
    c = torch.from_numpy(counts.astype(np.int32))
    if table.kernel == "prefix":
        return huffman_decode.decode_streams(
            m, c, torch.from_numpy(a["lut_sym"].astype(np.int32)),
            torch.from_numpy(a["lut_len"].astype(np.int32)),
            max_len=table.peek_bits, max_count=max_count).numpy()
    return ans_decode.decode_streams_tans(
        m, c, *(torch.from_numpy(a[k].astype(np.int32))
                for k in ("tab_sym", "tab_bits", "tab_base")),
        table_log=table.table_log, max_count=max_count).numpy()


def _jax_host(table, mat, counts):
    a = table.decode_arrays()
    if table.kernel == "prefix":
        return jbits.decode_streams(mat, counts, a["lut_sym"], a["lut_len"],
                                    table.peek_bits)
    return jbits.decode_streams_tans(mat, counts, a["tab_sym"], a["tab_bits"],
                                     a["tab_base"], table.table_log)


def _jax_interpret(table, mat, counts, max_count):
    a = table.decode_arrays()
    m, c = jnp.asarray(mat), jnp.asarray(counts, jnp.int32)
    if table.kernel == "prefix":
        out = decode_streams_pallas(
            m, c, jnp.asarray(a["lut_sym"]), jnp.asarray(a["lut_len"]),
            max_len=table.peek_bits, max_count=max_count, interpret=True)
    else:
        out = decode_streams_tans_pallas(
            m, c, *(jnp.asarray(a[k]) for k in ("tab_sym", "tab_bits",
                                                "tab_base")),
            table_log=table.table_log, max_count=max_count, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("raw", 4),
                                        ("rans", 4), ("rans", 8)])
def test_plain_and_backends_equal_pallas_interpret(codec, bits):
    table, mat, counts, sym = _streams(codec, bits, 3, 24, seed=bits)
    mc = int(counts.max())
    want = _jax_interpret(table, mat, counts, mc)
    assert want.shape == (4, mc)
    np.testing.assert_array_equal(_plain(table, mat, counts, mc), want)
    for name in ("numpy", "torch"):
        b = tdb.get_backend(name)
        got = b.decode_table(table, mat, counts)
        np.testing.assert_array_equal(np.asarray(got)[:4, :mc], want)
        if table.kernel == "prefix":        # the table-less prefix entry
            a = table.decode_arrays()
            got = b.decode(mat, counts, a["lut_sym"], a["lut_len"],
                           max_len=table.peek_bits)
            np.testing.assert_array_equal(np.asarray(got)[:4, :mc], want)
    np.testing.assert_array_equal(want[[0, 1, 3]], sym)


@pytest.mark.parametrize("codec,bits", [("huffman", 8), ("rans", 4)])
def test_plain_equals_host_decoder_at_main_path_shape(codec, bits):
    """8 streams of 65,536 symbols: one decode call of the load path."""
    table, mat, counts, sym = _streams(codec, bits, 8, 65536, seed=bits,
                                       zero_lane=False)
    counts[3] = 40000                       # a lane that ends early
    want = _jax_host(table, mat, counts)
    got = _plain(table, mat, counts, 65536)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3, 40000:], 0)
    np.testing.assert_array_equal(got[[0, 1, 2, 4, 5, 6, 7]],
                                  sym[[0, 1, 2, 4, 5, 6, 7]])


def _serial_rows(table, mat, counts):
    a = table.decode_arrays()
    rows = []
    for i, c in enumerate(counts):
        if table.kernel == "prefix":
            rows.append(jbits.decode_serial(mat[i], int(c), a["lut_sym"],
                                            a["lut_len"], table.peek_bits))
        else:
            rows.append(jbits.decode_serial_tans(
                mat[i], int(c), a["tab_sym"], a["tab_bits"], a["tab_base"],
                table.table_log))
    return rows


@pytest.mark.parametrize("use_out", [False, True], ids=["ret", "out"])
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("codec", ["huffman", "rans"])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_backend_matches_reference_serial_oracle(backend, codec, bits,
                                                 use_out):
    """The port's tables (built by the port's codecs) and backends against
    the JAX package's serial decoders, zero-count lane included."""
    table, mat, counts, sym = _streams(codec, bits, N_STREAMS, COUNT,
                                       seed=bits, get_codec=tget_codec)
    out = (np.full((mat.shape[0] + 2, COUNT + 32), -1, np.int32)
           if use_out else None)
    dec = np.asarray(tdb.get_backend(backend).decode_table(table, mat, counts,
                                                           out=out))
    serial = _serial_rows(table, mat, counts)
    k = 0
    for i, c in enumerate(counts):
        np.testing.assert_array_equal(dec[i, :c], serial[i])
        if c:
            np.testing.assert_array_equal(dec[i, :c].astype(np.uint8), sym[k])
            k += 1
    if use_out:
        assert dec.base is out or dec is out
        assert (out[mat.shape[0]:] == -1).all()     # rows past S untouched


def test_out_buffer_too_small_raises():
    table, mat, counts, _ = _streams("rans", 4, N_STREAMS, COUNT, seed=0,
                                     get_codec=tget_codec)
    small = np.zeros((mat.shape[0], COUNT - 1), np.int32)
    for backend in ("numpy", "torch"):
        with pytest.raises(ValueError):
            tdb.get_backend(backend).decode_table(table, mat, counts,
                                                  out=small)


def test_codec_tables_equal_reference():
    """The port's code tables are the JAX package's, array for array."""
    rng = np.random.default_rng(3)
    for codec, bits in (("huffman", 8), ("rans", 4), ("raw", 4)):
        freqs = rng.integers(1, 500, 1 << bits).astype(np.int64)
        jt = jget_codec(codec).build(freqs, bits, max_code_len=12)
        tt = tget_codec(codec).build(freqs, bits, max_code_len=12)
        ja, ta = jt.decode_arrays(), tt.decode_arrays()
        assert sorted(ja) == sorted(ta)
        for k in ja:
            np.testing.assert_array_equal(ja[k], ta[k])
        sym = rng.integers(0, 1 << bits, 777).astype(np.uint8)
        np.testing.assert_array_equal(jt.encode(sym)[0], tt.encode(sym)[0])


def test_cuda_backend_raises_without_a_card():
    assert not torch.cuda.is_available()
    assert "cuda" in tdb.backend_names()
    assert "cuda" not in tdb.available_backends()
    with pytest.raises(RuntimeError, match="not available"):
        tdb.get_backend("cuda")
    # auto follows the device: cuda unless the caller names the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdb.get_backend("auto")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdb.get_backend(None, device="cuda")
    assert tdb.get_backend("auto", device="cpu").name == "torch"


def test_wrappers_raise_on_a_device_without_a_kernel():
    """Only a CPU tensor takes the plain version; any other device launches
    the kernel or raises (``meta`` has no kernel)."""
    table, mat, counts, _ = _streams("huffman", 8, 2, 16, seed=1,
                                     zero_lane=False)
    a = table.decode_arrays()
    dev = torch.device("meta")
    m = torch.from_numpy(mat).to(dev)
    c = torch.from_numpy(counts.astype(np.int32)).to(dev)
    ls = torch.from_numpy(a["lut_sym"].astype(np.int32)).to(dev)
    ll = torch.from_numpy(a["lut_len"].astype(np.int32)).to(dev)
    with pytest.raises(ValueError, match="no prefix decode"):
        huffman_decode.decode_streams(m, c, ls, ll, max_len=table.peek_bits,
                                      max_count=16)
    with pytest.raises(ValueError, match="no tANS decode"):
        ans_decode.decode_streams_tans(m, c, ls, ll, ls, table_log=8,
                                       max_count=16)
    before = dict(build.launches)
    _plain(table, mat, counts, 16)
    assert build.launches == before
