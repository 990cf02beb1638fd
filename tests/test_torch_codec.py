"""Container codec parity: the port's ``CompressedModel`` against the JAX
package's, on the same numpy weights.

* The same params and spec give containers equal member by member: same
  keys, dtypes, shapes and bytes.  (Whole-file bytes differ: ``np.savez``
  writes zip headers with timestamps.)
* A container written by the JAX package loads in the port and decodes to
  the same symbols and dequantized values, bitwise.
* The committed v1 fixture loads and matches its expected symbols.
* ``stats()`` agrees per (codec, bits) group, exactly.
* The host quantizer and its torch twins give the reference's symbols,
  scales and zeros.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.core.spec import CompressionSpec as JSpec
from repro.core.spec import spec_from_legacy as jspec_from_legacy
from repro.core.store import CompressedModel as JModel
from repro_torch.core import quant as tquant
from repro_torch.core.spec import CompressionSpec as TSpec
from repro_torch.core.spec import spec_from_legacy as tspec_from_legacy
from repro_torch.core.store import CompressedModel as TModel

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CODECS = ("huffman", "rans", "raw")
BITS = (2, 4, 8)
MIXED = ("*norm*:fp32; layers/*:bits=4,codec=rans; *:bits=8,codec=huffman;"
         " defaults:segment_symbols=4096")


def _params(seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: (rng.standard_t(3, size=s) * 0.02).astype(np.float32)  # noqa: E731
    return {
        "embed": t(300, 128),
        "layers/wq": t(3, 96, 128),
        "layers/w_up": t(3, 128, 160),
        "layers/attn_norm": (1 + 0.1 * rng.normal(size=(3, 128))
                             ).astype(np.float32),
        "lm_head": t(128, 300),
        "final_norm": rng.normal(size=(128,)).astype(np.float32),
    }


def _legacy_specs(codec, bits):
    kw = dict(codec=codec, segment_symbols=4096)
    return (jspec_from_legacy(bits, jquant.Granularity.PER_CHANNEL, **kw),
            tspec_from_legacy(bits, tquant.Granularity.PER_CHANNEL, **kw))


def _members(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_members(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _assert_same_stats(js, ts):
    assert len(js.groups) == len(ts.groups)
    for jg, tg in zip(js.groups, ts.groups):
        assert (jg.table_id, jg.codec, jg.bits) == (tg.table_id, tg.codec,
                                                    tg.bits)
        assert jg.param_count == tg.param_count
        assert jg.encoded_bytes == tg.encoded_bytes
        assert jg.effective_bits == tg.effective_bits
        assert jg.entropy_bits == tg.entropy_bits
    for f in ("param_count", "encoded_bytes", "quant_bytes", "metadata_bytes",
              "unquantized_params"):
        assert getattr(js, f) == getattr(ts, f), f
    assert js.effective_bits == ts.effective_bits


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("codec", CODECS)
def test_same_params_same_container_members(codec, bits, tmp_path):
    host = _params(bits)
    jspec, tspec = _legacy_specs(codec, bits)
    jm = JModel.compress(host, spec=jspec)
    tm = TModel.compress(host, spec=tspec)
    jm.save(str(tmp_path / "jax.npz"))
    tm.save(str(tmp_path / "torch.npz"))
    _assert_same_members(_members(tmp_path / "jax.npz"),
                         _members(tmp_path / "torch.npz"))
    _assert_same_stats(jm.stats(), tm.stats())


def test_mixed_spec_same_container_members(tmp_path):
    host = _params(7)
    jm = JModel.compress(host, spec=JSpec.parse(
        MIXED, default_granularity=jquant.Granularity.PER_CHANNEL))
    tm = TModel.compress(host, spec=TSpec.parse(
        MIXED, default_granularity=tquant.Granularity.PER_CHANNEL))
    assert sorted(jm.tables) == sorted(tm.tables) == ["huffman8", "rans4"]
    jm.save(str(tmp_path / "jax.npz"))
    tm.save(str(tmp_path / "torch.npz"))
    _assert_same_members(_members(tmp_path / "jax.npz"),
                         _members(tmp_path / "torch.npz"))
    _assert_same_stats(jm.stats(), tm.stats())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("codec", CODECS)
def test_jax_written_container_loads_in_port(codec, bits, tmp_path):
    host = _params(10 + bits)
    jspec, _ = _legacy_specs(codec, bits)
    jm = JModel.compress(host, spec=jspec)
    path = str(tmp_path / "model.npz")
    jm.save(path)
    tm = TModel.load(path)
    assert sorted(tm.tables) == sorted(jm.tables)
    assert sorted(tm.unquantized) == sorted(jm.unquantized)
    want = jm.decode_all(backend="numpy")
    for backend in ("numpy", "torch"):
        got = tm.decode_all(backend=backend, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.uint8, k
            assert np.array_equal(got[k], want[k]), (backend, k)
    jd = jm.dequantize_all(backend="numpy")
    td = tm.dequantize_all(backend="numpy")
    for k in jd:
        assert np.array_equal(jd[k], td[k]), k
    _assert_same_stats(jm.stats(), tm.stats())


def test_v1_fixture_loads_and_matches_expected():
    cm = TModel.load(os.path.join(FIXTURES, "container_v1_8bit.npz"))
    expected = np.load(os.path.join(FIXTURES,
                                    "container_v1_8bit_expected.npz"))
    names = {k.split("::", 1)[1] for k in expected.files
             if k.startswith("sym::")}
    for backend in ("numpy", "torch"):
        dec = cm.decode_all(backend=backend, device="cpu")
        assert set(dec) == names
        for k in dec:
            assert dec[k].dtype == np.uint8
            assert np.array_equal(dec[k], expected[f"sym::{k}"]), (backend, k)
    deq = cm.dequantize_all(backend="numpy")
    for k in deq:
        assert np.array_equal(deq[k], expected[f"deq::{k}"]), k
    assert list(cm.tables) == ["huffman8"]
    # the JAX package reads the same fixture to the same stats
    jm = JModel.load(os.path.join(FIXTURES, "container_v1_8bit.npz"))
    _assert_same_stats(jm.stats(), cm.stats())


def test_v1_fixture_resaves_as_the_jax_package_resaves_it(tmp_path):
    """Load v1 in both packages, save v2 from both: equal members."""
    src = os.path.join(FIXTURES, "container_v1_8bit.npz")
    JModel.load(src).save(str(tmp_path / "jax.npz"))
    TModel.load(src).save(str(tmp_path / "torch.npz"))
    _assert_same_members(_members(tmp_path / "jax.npz"),
                         _members(tmp_path / "torch.npz"))


@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_matches_reference(bits):
    """The host quantizer both containers are built on, per granularity."""
    w = _params(bits)["layers/w_up"]
    for g in (jquant.Granularity.PER_TENSOR, jquant.Granularity.PER_CHANNEL):
        jq = jquant.quantize(w, bits, g)
        tq = tquant.quantize(w, bits, tquant.Granularity(g.value))
        assert np.array_equal(jq.q, tq.q)
        assert np.array_equal(jq.scale, tq.scale)
        assert np.array_equal(jq.zero, tq.zero)


@pytest.mark.parametrize("sign", ["mixed", "nonnegative"])
@pytest.mark.parametrize("bits", BITS)
def test_torch_quant_twins_match_reference(bits, sign):
    """``quantize_torch`` / ``dequantize_torch`` against the JAX package's
    ``quantize_jnp`` / ``dequantize_jnp`` (per-tensor, mixed scheme)."""
    w = _params(bits)["layers/w_up"]
    if sign == "nonnegative":               # the unsigned (symmetric) branch
        w = np.abs(w)
    jq, js, jz = jquant.quantize_jnp(jnp.asarray(w), bits)
    tq, ts, tz = tquant.quantize_torch(torch.from_numpy(w), bits)
    assert tq.dtype == torch.uint8 and ts.dtype == tz.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js) and tz.item() == float(jz)
    jd = np.asarray(jquant.dequantize_jnp(jq, js, jz), np.float32)
    td = tquant.dequantize_torch(tq, ts, tz)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(td.float().numpy(), jd)
