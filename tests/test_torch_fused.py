"""The port's fused decode→dequant→matmul against the JAX package's, on the
CPU (counterpart of ``tests/differential/test_fused_kernel.py``).

The cases come from ``tests/differential/qt_cases.py``: the same symbols,
code table, lane matrix, scale / zero and bf16 activations go to both
packages.  On CPU tensors the port's wrapper runs its plain version
(decode every lane with the plain decoders, then exactly ``layers.deq`` and
``@``), which must equal the JAX package's in-graph ``jax`` impl and its
numpy-decode oracle ``kernels.ref.fused_decode_matmul_ref`` **bitwise**: the
decoded symbols are exact integers and the dequant and the bf16 product are
the ops the dense-model tests hold bitwise.  Against the Pallas kernel run
in interpret mode the port is held to atol = rtol = 1e-2, the tolerance the
JAX package holds its own kernel to (its f32 accumulation order differs).

Also: ``lanes_per_tile``, the ``build_fused_qt`` geometry errors, the
scheduler's ``fused_tile_reason`` / ``plan_fused_spans`` on one container,
and the backends' ``fused_matmul`` (``cuda`` raises on this card-less host).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.decode_backends import get_backend as jget_backend
from repro.core.quant import Granularity as JGranularity
from repro.core.scheduler import fused_tile_reason as jtile_reason
from repro.core.scheduler import plan_fused_spans as jplan_spans
from repro.core.spec import spec_from_legacy as jspec_from_legacy
from repro.core.store import CompressedModel as JModel
from repro.kernels import fused_decode_matmul as jfused
from repro.kernels.ref import fused_decode_matmul_ref
from repro_torch.core import decode_backends as tdb
from repro_torch.core.quant import Granularity as TGranularity
from repro_torch.core.scheduler import fused_tile_reason, plan_fused_spans
from repro_torch.core.spec import spec_from_legacy
from repro_torch.core.store import CompressedModel as TModel
from repro_torch.kernels import build
from repro_torch.kernels import fused_decode_matmul as tfused
from repro_torch.models import layers as tlayers

from differential import qt_cases

# bits 2/3/4/8 x both families x scale (1, 1), (K, 1) and (1, N), skewed and
# constant histograms (the JAX package's fixed sweep)
CASES = [
    dict(bits=8, codec="huffman", K=8, N=16, seg=32),
    dict(bits=4, codec="huffman", K=8, N=16, seg=16,
         granularity="per_channel"),
    dict(bits=8, codec="rans", K=8, N=16, seg=32, granularity="per_row"),
    dict(bits=4, codec="rans", K=6, N=8, seg=24, skew=True),
    dict(bits=8, codec="huffman", K=4, N=8, seg=16, constant=3),
    dict(bits=2, codec="rans", K=8, N=16, seg=64),
    dict(bits=2, codec="huffman", K=8, N=16, seg=32, granularity="per_row"),
    dict(bits=3, codec="huffman", K=9, N=8, seg=24, skew=True),
]
INTERPRET_CASES = [
    dict(bits=8, codec="huffman", K=8, N=16, seg=32),
    dict(bits=4, codec="rans", K=8, N=16, seg=32, granularity="per_row"),
]


def _x(c) -> torch.Tensor:
    return torch.from_numpy(np.asarray(c.x, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _port(c):
    fq = tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero,
                               seg_symbols=c.seg, K=c.K, N=c.N, bits=c.bits,
                               device="cpu")
    before = dict(build.launches)
    # through layers.matmul, so the dispatch is part of the test
    out = tlayers.matmul(_x(c), fq)
    assert build.launches == before          # CPU: the plain version
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (3, c.N)
    return out


def _jax(c, impl):
    fq = jfused.build_fused_qt(c.table, c.mat, c.scale, c.zero,
                               seg_symbols=c.seg, K=c.K, N=c.N, bits=c.bits,
                               impl=impl)
    return jfused.fused_decode_matmul(c.x, fq)


def _oracle(c):
    return fused_decode_matmul_ref(c.x, c.mat, c.table, c.scale, c.zero,
                                   seg_symbols=c.seg, K=c.K, N=c.N)


@pytest.mark.parametrize("kw", CASES, ids=qt_cases.case_id)
def test_plain_equals_jax_impl_and_oracle_bitwise(kw):
    c = qt_cases.fused_case(**kw)
    got = _np(_port(c))
    np.testing.assert_array_equal(got, _np(_jax(c, "jax")))
    np.testing.assert_array_equal(got, _np(_oracle(c)))
    # and the unfused QT slot of the port, which the serving identity needs
    qt = tlayers.pack_qt(c.sym, c.scale, c.zero, bits=c.bits)
    np.testing.assert_array_equal(got, _np(tlayers.matmul(_x(c), qt)))


@pytest.mark.parametrize("kw", [
    dict(bits=8, codec="huffman", K=8, N=48, seg=48,
         granularity=JGranularity.PER_GROUP, group=32),
    dict(bits=4, codec="rans", K=8, N=48, seg=96,
         granularity=JGranularity.PER_TENSOR),
], ids=qt_cases.case_id)
def test_quantized_cases_bitwise(kw):
    c = qt_cases.quantized_case(**kw)
    np.testing.assert_array_equal(_np(_port(c)), _np(_oracle(c)))


@pytest.mark.parametrize("kw", INTERPRET_CASES, ids=qt_cases.case_id)
def test_plain_close_to_pallas_interpret(kw):
    c = qt_cases.fused_case(**kw)
    np.testing.assert_allclose(_np(_port(c)), _np(_jax(c, "pallas-interpret")),
                               rtol=1e-2, atol=1e-2)


def test_decoded_lanes_are_the_symbols():
    c = qt_cases.fused_case(bits=4, codec="rans", K=8, N=16, seg=32,
                            skew=True)
    fq = tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero,
                               seg_symbols=c.seg, K=c.K, N=c.N, bits=c.bits,
                               device="cpu")
    np.testing.assert_array_equal(tfused.decode_lanes_plain(fq).numpy(),
                                  c.sym)
    assert fq.shape == (8, 16) and fq.family == "tans"
    assert "FusedQT(tans4, K=8, N=16, seg=32, lanes=4" in repr(fq)


def test_lanes_per_tile_equals_reference():
    for n in list(range(1, 300)) + [384, 1024, 4096]:
        for cap in (4, 128):
            assert tfused.lanes_per_tile(n, cap) == jfused.lanes_per_tile(
                n, cap), (n, cap)


def test_build_fused_qt_rejects_misaligned_geometry():
    c = qt_cases.fused_case(bits=8, codec="huffman", K=8, N=16, seg=32)
    kw = dict(seg_symbols=c.seg, bits=c.bits, device="cpu")
    with pytest.raises(ValueError, match="dense geometry"):
        tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero, K=c.K + 1,
                              N=c.N, **kw)
    # same symbol total, but segments no longer tile rows of width N
    with pytest.raises(ValueError, match="tile rows"):
        tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero, K=2, N=64,
                              **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero, K=c.K, N=c.N,
                              seg_symbols=c.seg, bits=c.bits)


def test_tile_reason_and_spans_equal_reference():
    """The scheduler's eligibility classifier and span planner, one tensor
    per failure mode, on containers the two packages write from one dict."""
    rng = np.random.default_rng(0)
    host = {
        "layers/w_a": rng.normal(0, 0.05, (2, 64, 32)).astype(np.float32),
        "layers/w_b": rng.normal(0, 0.05, (2, 80, 32)).astype(np.float32),
        "layers/w_c": rng.normal(0, 0.05, (4, 64, 32)).astype(np.float32),
        "layers/w_d": rng.normal(0, 0.05, (2, 2, 32, 32)).astype(np.float32),
        "layers/w_e": rng.normal(0, 0.05, (2, 72, 32)).astype(np.float32),
    }
    jcm = JModel.compress(host, spec=jspec_from_legacy(
        8, JGranularity.PER_TENSOR, segment_symbols=1024))
    tcm = TModel.compress(host, spec=spec_from_legacy(
        8, TGranularity.PER_TENSOR, segment_symbols=1024))
    reasons = {n: fused_tile_reason(tcm, 2, n) for n in host}
    assert reasons == {n: jtile_reason(jcm, 2, n) for n in host}
    assert reasons["layers/w_a"] is None
    assert "ragged tail" in reasons["layers/w_e"]
    got = plan_fused_spans(tcm, 2, ["layers/w_a"])["layers/w_a"]
    want = jplan_spans(jcm, 2, ["layers/w_a"])["layers/w_a"]
    assert [(sp.layer, sp.seg_symbols, [(s.index, s.offset, s.nbytes)
                                        for s in sp.segs]) for sp in got] \
        == [(sp.layer, sp.seg_symbols, [(s.index, s.offset, s.nbytes)
                                        for s in sp.segs]) for sp in want]
    with pytest.raises(ValueError, match="whole number"):
        plan_fused_spans(tcm, 2, ["layers/w_b"])


def test_backend_fused_matmul_parity():
    """numpy (host decode + serving ops) and torch (the fused plain
    version) answer identically, and equal the JAX package's numpy fused
    path; cuda is registered with both families but raises here."""
    c = qt_cases.fused_case(bits=8, codec="rans", K=8, N=16, seg=32)
    kw = dict(seg_symbols=c.seg, K=c.K, N=c.N, bits=c.bits)
    outs = {}
    for name in ("numpy", "torch"):
        b = tdb.get_backend(name)
        assert b.fused_available()
        assert b.fused_families() == ["prefix", "tans"]
        outs[name] = _np(b.fused_matmul(c.table, _x(c), c.mat, c.scale,
                                        c.zero, **kw))
    np.testing.assert_array_equal(outs["numpy"], outs["torch"])
    np.testing.assert_array_equal(outs["numpy"], _np(jget_backend(
        "numpy").fused_matmul(c.table, c.x, c.mat, c.scale, c.zero, **kw)))
    cuda = tdb._REGISTRY["cuda"]
    assert cuda.fused_families() == ["prefix", "tans"]
    assert not cuda.fused_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda.fused_matmul(c.table, _x(c), c.mat, c.scale, c.zero, **kw)


def test_backend_without_family_raises():
    class Bogus:
        kernel = "bogus"

    c = qt_cases.fused_case(bits=8, codec="huffman", K=4, N=8, seg=16)
    with pytest.raises(RuntimeError, match="no fused 'bogus'"):
        tdb.get_backend("numpy").fused_matmul(
            Bogus(), _x(c), c.mat, c.scale, c.zero, seg_symbols=c.seg,
            K=c.K, N=c.N)


def test_wrapper_follows_the_device():
    """CPU tensors take the plain version; a device the kernel does not
    serve raises instead of falling back."""
    c = qt_cases.fused_case(bits=8, codec="huffman", K=8, N=16, seg=32)
    fq = tfused.build_fused_qt(c.table, c.mat, c.scale, c.zero,
                               seg_symbols=c.seg, K=c.K, N=c.N, bits=c.bits,
                               device="cpu")
    x = _x(c)
    np.testing.assert_array_equal(
        _np(tfused.fused_decode_matmul(x[None], fq))[0],
        _np(tfused.fused_decode_matmul_plain(x, fq)))
    with pytest.raises(ValueError, match="no fused decode matmul"):
        tfused.fused_decode_matmul(x.to("meta"), fq)
