"""The port's host encoders against the JAX package's, bitwise.

* ``pack_bit_chunks`` (the word-at-a-time packer) gives the reference's
  stream and bit count for chunks of 0 to 64 bits, chunks that cross a
  64-bit word, and empty input.
* The tANS table's ``encode_rows`` (segments advanced in lock-step) gives
  the streams of the reference's serial encode, segment by segment, with
  and without a short last segment, at fewer lanes than the lock-step
  takes (the serial fallback) and at more than one batch of lanes.
"""
import numpy as np
import pytest

from repro.core.bitstream import pack_bit_chunks as ref_pack
from repro.core.codecs import rans as ref_rans
from repro.core.segmentation import segment_and_encode as ref_segment
from repro_torch.core.bitstream import pack_bit_chunks
from repro_torch.core.codecs import rans
from repro_torch.core.segmentation import segment_and_encode


@pytest.mark.parametrize("max_bits", [1, 8, 12, 16, 25, 57, 64])
def test_pack_bit_chunks_matches_reference(max_bits):
    rng = np.random.default_rng(max_bits)
    for n in (0, 1, 7, 64, 999, 4097):
        nbits = rng.integers(0, max_bits + 1, n)
        # bits above a chunk's width must be ignored
        vals = rng.integers(0, 2 ** 63, n, dtype=np.uint64) * np.uint64(2) \
            + rng.integers(0, 2, n, dtype=np.uint64)
        got, got_bits = pack_bit_chunks(vals, nbits)
        want, want_bits = ref_pack(vals, nbits)
        assert got_bits == want_bits
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_pack_bit_chunks_all_zero_widths():
    vals = np.arange(5, dtype=np.uint64)
    got = pack_bit_chunks(vals, np.zeros(5, np.int64))
    want = ref_pack(vals, np.zeros(5, np.int64))
    assert got[1] == want[1] == 0
    np.testing.assert_array_equal(got[0], want[0])


def _symbols(bits, shape, seed):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(1 << bits, 0.3))
    return rng.choice(1 << bits, size=shape, p=p).astype(np.uint8)


# (segments, symbols a segment, short last segment): below the lock-step's
# lane floor, one batch, and more than one batch of LOCKSTEP_LANES
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n_seg,seg,tail", [
    (rans.LOCKSTEP_MIN_LANES - 1, 96, 0),
    (rans.LOCKSTEP_MIN_LANES, 300, 17),
    (rans.LOCKSTEP_LANES + 3, 64, 5),
])
def test_tans_lockstep_segments_match_reference(bits, n_seg, seg, tail):
    q = _symbols(bits, n_seg * seg + tail, seed=bits + n_seg)
    freqs = np.bincount(q, minlength=1 << bits)
    got_meta, got = segment_and_encode("w", q, rans.build(freqs, bits), seg)
    want_meta, want = ref_segment("w", q, ref_rans.build(freqs, bits), seg)
    assert len(got) == len(want) == n_seg + (1 if tail else 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_meta.seg_bits, want_meta.seg_bits)
    np.testing.assert_array_equal(got_meta.seg_counts, want_meta.seg_counts)
    np.testing.assert_array_equal(got_meta.seg_nbytes, want_meta.seg_nbytes)


def test_tans_encode_rows_equals_serial_encode():
    q = _symbols(4, (rans.LOCKSTEP_MIN_LANES + 2, 2 * rans.LOCKSTEP_BLOCK
                     + 3), seed=3)
    table = rans.build(np.bincount(q.reshape(-1), minlength=16), 4)
    for (a, na), row in zip(table.encode_rows(q), q):
        b, nb = table.encode(row)
        assert na == nb
        np.testing.assert_array_equal(a, b)
