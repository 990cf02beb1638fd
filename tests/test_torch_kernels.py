"""The port's ``kernels.ops`` and ``kernels.ref`` against the JAX package's,
on the CPU (counterpart of ``tests/test_kernels.py``).

The same numpy-seeded inputs go to the JAX package's ``ops`` functions (the
Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs them)
and to the port's ``ops``, whose wrappers run their plain versions for CPU
tensors.  Random inputs are held to atol = rtol = 1e-2, the tolerance of
``tests/test_kernels.py``: both sum exact bf16 products in float32, in
other orders.  Where the order cannot matter the results are held bitwise:

- one-hot rows of x pick rows of the dequantized weight, which the port,
  the JAX package's oracle ``ref.dequant_matmul_ref`` and a numpy reference
  compute as ``bf16(f32(q) * scale + zero)`` with the product and the sum
  rounded separately.  The JAX package's Pallas kernel in interpret mode
  rounds once on the CPU (XLA contracts the multiply and add into a fused
  multiply-add): where that moves a weight by one bf16 step, it differs
  from its own oracle and from the port, within the 1e-2 tolerance.  The
  tests pin both roundings;
- inputs whose every partial sum is exact in float32 (small integers,
  power-of-two scale and zero) at a K of several 512-wide tiles;
- a reduced qwen3-1.7b container written by the JAX package (Huffman-8 and
  rANS-4), decoded by the port, every layer matrix through both
  ``ops.dequant_matmul``.

``pack_nibbles`` / ``unpack_nibbles`` are byte-equal and
``ops.huffman_decode`` is bitwise equal to the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitstream import decode_streams, encode_symbols, pack_streams
from repro.core.entropy import HuffmanTable
from repro.core.quant import Granularity as JGranularity
from repro.core.spec import CompressionSpec as JSpec
from repro.core.store import CompressedModel as JModel
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.kernels import build
from repro_torch.kernels import dequant_matmul as tdm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.serving import engine as tengine

import dequant_cases
from differential import qt_cases

TOL = dict(atol=1e-2, rtol=1e-2)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _both(x, wq, scale, zero, *, int4=False):
    """(port, JAX) ``ops.dequant_matmul`` on the same numpy inputs, as
    float32 numpy; the port's call launches no kernel on the CPU."""
    before = dict(build.launches)
    got = tops.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(wq), scale, zero, int4=int4)
    assert build.launches == before
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (x.shape[0], wq.shape[1])
    want = jops.dequant_matmul(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(wq), scale, zero, int4=int4)
    return _f32(got), _f32(want)


# ------------------------------------------------------------ random inputs

@pytest.mark.parametrize("M,K,N", [
    (8, 128, 64), (64, 384, 200), (128, 512, 128), (1, 1024, 96), (33, 257, 65),
])
@pytest.mark.parametrize("per_channel", [True, False])
def test_dequant_matmul_int8_close_to_jax(M, K, N, per_channel):
    rng = np.random.default_rng(M * 1000 + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    wq = rng.integers(0, 256, size=(K, N)).astype(np.uint8)
    if per_channel:
        scale = rng.uniform(1e-3, 1e-2, size=(N,)).astype(np.float32)
        zero = rng.uniform(-1, 0, size=(N,)).astype(np.float32)
    else:
        scale, zero = np.float32(0.005), np.float32(-0.6)
    got, want = _both(x, wq, scale, zero)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("M,K,N", [(16, 256, 128), (8, 130, 48)])
def test_dequant_matmul_int4_close_to_jax(M, K, N):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, K)).astype(np.float32)
    q4 = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    packed = tops.pack_nibbles(q4)
    scale = rng.uniform(0.01, 0.1, size=(N,)).astype(np.float32)
    zero = np.zeros(N, np.float32)
    got, want = _both(x, packed, scale, zero, int4=True)
    np.testing.assert_allclose(got, want, **TOL)


def test_pack_unpack_nibbles_byte_equal_to_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, size=(64, 33)).astype(np.uint8)
    p = tops.pack_nibbles(q)
    assert p.dtype == np.uint8 and p.shape == (32, 33)
    np.testing.assert_array_equal(p, jops.pack_nibbles(q))
    np.testing.assert_array_equal(tops.unpack_nibbles(p),
                                  jops.unpack_nibbles(p))
    np.testing.assert_array_equal(tops.unpack_nibbles(p), q)
    # the plain version's unpacking is the numpy one
    np.testing.assert_array_equal(tdm.unpack_k(torch.from_numpy(p)).numpy(),
                                  q)


def test_dequant_matmul_equals_float_matmul():
    """Quantize a real matrix, then kernel(x, q) ~= x @ w_dequant."""
    from repro_torch.core import quant
    rng = np.random.default_rng(2)
    w = rng.normal(0, 0.05, size=(256, 128)).astype(np.float32)
    qt = quant.quantize(w, 8)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    got, want = _both(x, qt.q, qt.scale.reshape(-1), qt.zero.reshape(-1))
    np.testing.assert_allclose(got, want, **TOL)
    exact = dequant_cases.bf16(x) @ quant.dequantize(qt)
    np.testing.assert_allclose(got, exact, atol=0.15, rtol=0.05)


# ------------------------------------------------------------------ bitwise

@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_one_hot_rows_are_the_dequantized_weight_bitwise(int4, per_channel):
    """Pins the dequant's rounding.  The affine and symbols are chosen so
    that one rounding of ``q * scale + zero`` (a fused multiply-add) and
    two (f32 product, then f32 sum) give different bf16 weights; x = I
    picks every row.  The port (ops and ref) and the JAX package's oracle
    ``ref.dequant_matmul_ref`` round twice, bit for bit; the JAX package's
    Pallas kernel in interpret mode rounds once on the CPU (XLA contracts
    its multiply and add), so it agrees with them only within 1e-2."""
    K, N = 130, 48
    qmax = 15 if int4 else 255
    if per_channel:
        q, scale, zero = dequant_cases.fma_pinning_case(5 + int4, K, N, qmax)
    else:
        s, z, qs = dequant_cases.fma_sensitive(7 + int4, 1, qmax)
        scale, zero = s[0], z[0]
        q = np.random.default_rng(5).integers(0, qmax + 1, size=(K, N)) \
            .astype(np.uint8)
        q[::7] = qs[0]
    w = dequant_cases.dequant_two_roundings(q, scale, zero)
    w_fma = dequant_cases.dequant_one_rounding(q, scale, zero)
    assert (w != w_fma).any()
    wq = tops.pack_nibbles(q) if int4 else q
    eye = np.eye(K, dtype=np.float32)
    got, want = _both(eye, wq, scale, zero, int4=int4)
    np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(
        _f32(tref.dequant_matmul_ref(torch.from_numpy(eye), torch.from_numpy(wq),
                                     scale, zero, int4=int4)), w)
    np.testing.assert_array_equal(
        _f32(jref.dequant_matmul_ref(jnp.asarray(eye, jnp.bfloat16),
                                     jnp.asarray(wq), scale, zero,
                                     int4=int4)), w)
    np.testing.assert_array_equal(want, w_fma)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("int4,K", [(False, 1536), (True, 2048)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_exact_sums_bitwise(int4, K, per_channel):
    """Small integers and power-of-two scale and zero: every product and
    partial sum is exact in float32, so the summation order cannot matter
    and the two packages agree bit for bit across K-tiles."""
    M, N = 8, 64
    rng = np.random.default_rng(K)
    x = rng.integers(-3, 4, size=(M, K)).astype(np.float32)
    q = rng.integers(0, 16 if int4 else 256, size=(K, N)).astype(np.uint8)
    wq = tops.pack_nibbles(q) if int4 else q
    if per_channel:
        scale = (2.0 ** -rng.integers(2, 5, size=N)).astype(np.float32)
        zero = -rng.integers(0, 3, size=N).astype(np.float32)
    else:
        scale, zero = np.float32(0.25 if int4 else 0.0625), np.float32(-2.0)
    w = (q.astype(np.float64) * np.asarray(scale, np.float64)
         + np.asarray(zero, np.float64))
    assert (dequant_cases.bf16(w) == w).all()
    exact = x.astype(np.float64) @ w
    assert (exact.astype(np.float32) == exact).all()
    got, want = _both(x, wq, scale, zero, int4=int4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dequant_cases.bf16(exact))


SLICE_SPEC = ("*norm*:fp32; layers/wo:bits=8,codec=huffman; "
              "layers/*:bits=4,codec=rans; *:bits=8,codec=huffman; "
              "defaults:segment_symbols=4096")


@pytest.fixture(scope="module")
def reduced_container(tmp_path_factory):
    """Reduced qwen3-1.7b compressed and saved by the JAX package."""
    import jax
    from repro.configs import registry as jreg
    from repro.models import api as japi
    cfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    params = japi.build(cfg).init(cfg, jax.random.PRNGKey(3))
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    cm = JModel.compress(host, spec=JSpec.parse(
        SLICE_SPEC, default_granularity=JGranularity.PER_CHANNEL))
    path = str(tmp_path_factory.mktemp("slice") / "model.npz")
    cm.save(path)
    return cm, path


def _matrices(params, n_layers):
    """(name, layer, (K, N) uint8 symbols, bits, scalar scale, zero) for
    every layer matrix of a dense-resident load."""
    for name, w in sorted(params.items()):
        if not name.startswith("layers/") or not isinstance(
                w, (tlayers.QT, tlayers.QT4)):
            continue
        for l in range(n_layers):
            lw = tlayers.layer_slice(w, l)
            if isinstance(lw, tlayers.QT4):
                sym, bits = tlayers._unpack4(lw.q), 4
            else:
                sym, bits = lw.q, 8
            assert lw.scale.numel() == 1 and lw.zero.numel() == 1, name
            yield (name, l, sym.numpy(), bits, np.float32(lw.scale.item()),
                   np.float32(lw.zero.item()))


def test_slice_reduced_container_through_both_ops(reduced_container):
    """JAX container -> port decode -> both ``ops.dequant_matmul``: the
    rANS-4 matrices re-packed along K, ``wo`` (Huffman-8) as uint8."""
    cm, path = reduced_container
    from repro.serving import engine as jengine
    jparams = jengine.load_params_from_compressed(cm, backend="numpy")
    tparams = tengine.load_params_from_compressed(TModel.load(path),
                                                  device="cpu")
    n_layers = tparams["layers/wq"].q.shape[0]
    rng = np.random.default_rng(11)
    seen = {}
    for name, l, sym, bits, scale, zero in _matrices(tparams, n_layers):
        # the port decoded the JAX package's symbols
        jw = jparams[name]
        jq = np.asarray(jw.q)[l]
        if bits == 4:
            jq = np.stack([jq & 0x0F, jq >> 4], axis=-1).reshape(sym.shape)
        np.testing.assert_array_equal(sym, jq)
        K, N = sym.shape
        wq = tops.pack_nibbles(sym) if bits == 4 else sym
        x = rng.normal(size=(4, K)).astype(np.float32)
        got, want = _both(x, wq, scale, zero, int4=bits == 4)
        np.testing.assert_allclose(got, want, **TOL)
        # one-hot rows: the dequantized weight, bitwise in the port and the
        # JAX package's oracle (two roundings); its interpret-mode kernel
        # rounds once
        rows = np.array([0, K // 2, K - 1])
        oh = np.zeros((3, K), np.float32)
        oh[np.arange(3), rows] = 1
        got, want = _both(oh, wq, scale, zero, int4=bits == 4)
        np.testing.assert_array_equal(
            got, dequant_cases.dequant_two_roundings(sym, scale, zero)[rows])
        np.testing.assert_array_equal(got, _f32(jref.dequant_matmul_ref(
            jnp.asarray(oh, jnp.bfloat16), jnp.asarray(wq), scale, zero,
            int4=bits == 4)))
        np.testing.assert_array_equal(
            want, dequant_cases.dequant_one_rounding(sym, scale, zero)[rows])
        seen[name] = bits
    assert seen == {"layers/wq": 4, "layers/wk": 4, "layers/wv": 4,
                    "layers/wo": 8, "layers/w_gate": 4, "layers/w_up": 4,
                    "layers/w_down": 4}


# ---------------------------------------------------------------- the wrapper

def test_wrapper_rejects_bad_inputs():
    x = torch.ones((2, 5), dtype=torch.bfloat16)
    wq = torch.zeros((3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd"):
        tops.dequant_matmul(x, wq, 0.1, 0.0, int4=True)
    x = torch.ones((2, 6), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale"):
        tops.dequant_matmul(x, torch.zeros((6, 8), dtype=torch.uint8),
                            np.ones(9, np.float32), 0.0)
    with pytest.raises(ValueError, match="zero"):
        tops.dequant_matmul(x, torch.zeros((6, 8), dtype=torch.uint8), 0.1,
                            np.ones(7, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        tops.dequant_matmul(x, torch.zeros((4, 8), dtype=torch.uint8), 0.1,
                            0.0)
    with pytest.raises(ValueError, match="uint8"):
        tops.dequant_matmul(x, torch.zeros((6, 8), dtype=torch.int32), 0.1,
                            0.0)
    one = torch.ones((), dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        tdm.dequant_matmul(x.float(), torch.zeros((6, 8), dtype=torch.uint8),
                           one, one)
    with pytest.raises(ValueError, match="float32"):
        tdm.dequant_matmul(x, torch.zeros((6, 8), dtype=torch.uint8),
                           one.double(), one)
    with pytest.raises(ValueError, match="contiguous"):
        tdm.dequant_matmul(x, torch.zeros((8, 6), dtype=torch.uint8).t(),
                           one, one)
    # a device with no kernel and no plain version raises, after the checks
    with pytest.raises(ValueError, match="no dequant matmul for device"):
        tdm.dequant_matmul(x.to("meta"),
                           torch.zeros((6, 8), dtype=torch.uint8,
                                       device="meta"),
                           one.to("meta"), one.to("meta"))


def test_ragged_and_empty_shapes():
    rng = np.random.default_rng(7)
    for M, K, N in ((0, 16, 8), (3, 0, 8), (3, 16, 1)):
        x = rng.normal(size=(M, K)).astype(np.float32)
        wq = rng.integers(0, 256, size=(K, N)).astype(np.uint8)
        got = tops.dequant_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                                  0.01, -0.5)
        assert tuple(got.shape) == (M, N)
        np.testing.assert_array_equal(
            _f32(got), _f32(tref.dequant_matmul_ref(
                torch.from_numpy(x), torch.from_numpy(wq), 0.01, -0.5)))


# --------------------------------------------------------- the oracles (ref)

def test_dequant_matmul_ref_equals_jax_ref_on_exact_sums():
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, size=(5, 96)).astype(np.float32)
    q = rng.integers(0, 16, size=(96, 40)).astype(np.uint8)
    p = tops.pack_nibbles(q)
    for wq, int4 in ((q, False), (p, True)):
        got = tref.dequant_matmul_ref(torch.from_numpy(x),
                                      torch.from_numpy(wq), 0.5, -4.0,
                                      int4=int4)
        want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(wq), 0.5,
                                       -4.0, int4=int4)
        np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("kw", [
    dict(bits=8, codec="huffman", K=8, N=16, seg=32),
    dict(bits=4, codec="rans", K=8, N=16, seg=32, granularity="per_row"),
], ids=qt_cases.case_id)
def test_fused_decode_matmul_ref_equals_jax_ref_bitwise(kw):
    c = qt_cases.fused_case(**kw)
    got = tref.fused_decode_matmul_ref(
        torch.from_numpy(np.asarray(c.x, np.float32)).to(torch.bfloat16),
        c.mat, c.table, c.scale, c.zero, seg_symbols=c.seg, K=c.K, N=c.N)
    want = jref.fused_decode_matmul_ref(c.x, c.mat, c.table, c.scale,
                                        c.zero, seg_symbols=c.seg, K=c.K,
                                        N=c.N)
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ------------------------------------------------------------ huffman_decode

def _huffman_case(n_streams, max_len):
    rng = np.random.default_rng(n_streams)
    freqs = rng.integers(1, 2000, size=256)
    table = HuffmanTable(freqs, max_len=max_len)
    streams, counts = [], []
    for _ in range(n_streams):
        n = int(rng.integers(10, 500))
        syms = rng.integers(0, 256, size=n).astype(np.uint8)
        s, _ = encode_symbols(syms, table.codes, table.lengths)
        streams.append(s)
        counts.append(n)
    mat, _ = pack_streams(streams)
    return table, mat, np.array(counts, np.int64)


def _port_decode(table, mat, counts, max_len):
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return tops.huffman_decode(torch.from_numpy(mat), i32(counts),
                               i32(table.lut_sym), i32(table.lut_len),
                               max_len=max_len,
                               max_count=int(counts.max())).numpy()


@pytest.mark.parametrize("n_streams,max_len", [(1, 12), (7, 12), (130, 12),
                                               (16, 10)])
def test_huffman_decode_bitwise_equal_to_jax(n_streams, max_len):
    table, mat, counts = _huffman_case(n_streams, max_len)
    got = _port_decode(table, mat, counts, max_len)
    want = jops.huffman_decode(
        jnp.asarray(mat), jnp.asarray(counts, jnp.int32),
        jnp.asarray(table.lut_sym), jnp.asarray(table.lut_len),
        max_len=max_len, max_count=int(counts.max()))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    host = decode_streams(mat, counts, table.lut_sym, table.lut_len, max_len)
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(
        tref.decode_streams_ref(mat, counts, table.lut_sym, table.lut_len,
                                max_len), host)


def test_huffman_decode_roundtrip_identity():
    """encode -> the port's decode == original symbols, skewed histogram."""
    rng = np.random.default_rng(9)
    syms = np.clip(rng.normal(128, 12, size=5000), 0, 255).astype(np.uint8)
    table = HuffmanTable(np.bincount(syms, minlength=256), max_len=12)
    chunks = np.array_split(syms, 5)
    streams = [encode_symbols(c, table.codes, table.lengths)[0]
               for c in chunks]
    mat, _ = pack_streams(streams)
    counts = np.array([len(c) for c in chunks], np.int64)
    out = _port_decode(table, mat, counts, 12)
    got = np.concatenate([out[i, :c] for i, c in enumerate(counts)])
    np.testing.assert_array_equal(got, syms)


def test_every_c_entry_point_has_its_ctypes_signature():
    """Each ``extern "C"`` function of ``csrc/*.cu`` that returns a
    ``cudaError_t`` has an entry in ``build.SIGNATURES`` with one ctypes
    type per parameter, pointer-sized for pointers and ``long long``:
    without it ctypes passes every Python int as a 32-bit int and cuts the
    pointers."""
    import ctypes
    import re
    found = {}
    for src in build.sources():
        text = src.read_text()
        body = text[text.index('extern "C" {'):]
        for name, params in re.findall(r"^int (\w+)\(([^)]*)\)", body,
                                       re.M):
            found[name] = [p.strip() for p in params.split(",")]
    assert set(found) == set(build.SIGNATURES)
    for name, params in found.items():
        sig = build.SIGNATURES[name]
        assert len(sig) == len(params), name
        for ctype, param in zip(sig, params):
            if "*" in param:
                assert ctype is ctypes.c_void_p, (name, param)
            elif param.startswith("long long"):
                assert ctype is ctypes.c_longlong, (name, param)
            else:
                assert param.startswith("int ") and ctype is ctypes.c_int, \
                    (name, param)
