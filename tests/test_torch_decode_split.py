"""The split-and-sync decode of ``prefix_decode``
(``src/repro_torch/csrc/entropy_decode.cu``) as a numpy model, held bitwise
to the JAX package's host decoder ``repro.core.bitstream.decode_streams``
and to the port's own.

The model follows the kernel, one numpy lane per thread of the block that
decodes a row: the cut of the row's bits into subsequences of L bits (L a
multiple of ``max_len``), phase 1, the sync passes that end once the exact
prefix holds the row's count, the block scan, phase 3, and the bit reader's
64-bit window of two aligned 32-bit words, refilled a word at a time, for
a row at any address.  It lives
here and not in the package: the kernel runs only on a card, and this is
how its algorithm is tested without one.

The fused kernel ``fused_prefix_matmul`` (``csrc/fused_decode_matmul.cu``)
runs the same decode on each lane of a layer slice, its count the lane's
symbols, and writes the lane's row-major uint8 column tile; the model does
that too, over lane matrices packed as compressed-resident serving packs
them, held bitwise to the JAX package's and the port's lane decoders.

The same model runs speculatively on rANS-4 (tANS) streams as a probe:
every subsequence but the first starts at a guessed (bit position, state).
It is exact by construction; its pass count says whether ``tans_decode``
could be split the same way.  Run as a script, the file prints the pass
counts of both families at the load path's shape (one stream of 65,536
symbols, 1024 threads):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_decode_split.py
"""
import numpy as np
import pytest
import torch

from repro.core import bitstream as jbits
from repro_torch.core import bitstream as tbits
from repro_torch.core.codecs import get_codec
from repro_torch.core.scheduler import pack_segments

THREADS = 1024          # the kernel's kSplitThreads
SPEC = "*:bits=8,codec=huffman"     # the main path's rule for embed


def split(R, threads, unit):
    """The kernel's cut of R bits: the subsequence length L, the least
    multiple of ``unit`` that cuts R into at most ``threads`` pieces, and
    the number of pieces."""
    per = -(-R // threads)
    L = unit * (-(-per // unit) + (per == 0))
    return L, -(-R // L) + (R == 0)


class Reader:
    """``BitReader`` of ``entropy_decode.cu``, one lane per thread.  The
    row is bytes [off, off + B) of ``flat``, read as 4-byte-aligned
    big-endian words from the one holding the row's first byte, zero past
    the row.  A lane holds words wi and wi + 1 (64 bits) with the offset
    o < 32 of its next bit, and words wi + 2 and wi + 3; a step that leaves
    fewer than 32 bits in the pair moves the words down a place."""

    def __init__(self, flat, off, B, lanes):
        a = off & 3
        self.lead = 8 * a
        wlim = (B + a + 3) >> 2
        raw = np.zeros(4 * wlim + 4, np.uint8)       # and one zero word
        got = flat[off - a:off + B]
        raw[:got.size] = got
        self.words = raw.view(">u4").astype(np.uint64)
        self.hi, self.lo, self.n1, self.pend = (np.zeros(lanes, np.uint64)
                                                for _ in range(4))
        self.wi = np.zeros(lanes, np.int64)
        self.o = np.zeros(lanes, np.int64)

    def word(self, w):
        return self.words[np.minimum(w, self.words.size - 1)]

    def seek(self, idx, pos):
        q = pos + self.lead
        w = q >> 5
        self.wi[idx], self.o[idx] = w, q & 31
        self.hi[idx], self.lo[idx] = self.word(w), self.word(w + 1)
        self.n1[idx], self.pend[idx] = self.word(w + 2), self.word(w + 3)

    def peek(self, idx, n):
        pair = (self.hi[idx] << np.uint64(32)) | self.lo[idx]
        return ((pair << self.o[idx].astype(np.uint64))
                >> np.uint64(64 - n)).astype(np.int64)

    def skip(self, idx, n):
        o = self.o[idx] + n
        adv = o >= 32
        self.o[idx] = o - 32 * adv
        hi, lo, n1 = self.hi[idx], self.lo[idx], self.n1[idx]
        self.hi[idx] = np.where(adv, lo, hi)
        self.lo[idx] = np.where(adv, n1, lo)
        self.n1[idx] = np.where(adv, self.pend[idx], n1)
        self.wi[idx] += adv
        self.pend[idx] = self.word(self.wi[idx] + 3)


class Prefix:
    """A canonical prefix code as the kernel stages it: 2**max_len entries,
    lengths clamped to [1, max_len]; subsequences are cut at multiples of
    max_len.  The state is unused."""

    def __init__(self, table):
        a, self.max_len = table.decode_arrays(), table.peek_bits
        n = 1 << self.max_len
        self.sym = a["lut_sym"][:n].astype(np.int64)
        self.len = np.clip(a["lut_len"][:n], 1, self.max_len).astype(np.int64)
        self.unit = self.max_len

    def first(self, rd, pos, st):
        return pos, st

    def step(self, rd, idx, st):
        peek = rd.peek(idx, self.max_len)
        return self.sym[peek], self.len[peek], st


class Tans:
    """tANS, speculatively split: subsequence 0 reads the 16-bit header,
    every other one starts at its first bit with a guessed state of 0."""

    def __init__(self, table):
        a, self.tl = table.decode_arrays(), table.table_log
        self.sym, self.bits, self.base = (a[k].astype(np.int64) for k in (
            "tab_sym", "tab_bits", "tab_base"))
        self.unit = 1

    def first(self, rd, pos, st):
        rd.seek(np.arange(1), pos[:1])
        st[0] = rd.peek(np.arange(1), tbits.TANS_STATE_HEADER_BITS)[0] & (
            (1 << self.tl) - 1)
        pos[0] = tbits.TANS_STATE_HEADER_BITS
        return pos, st

    def step(self, rd, idx, st):
        window = rd.peek(idx, self.tl)
        nb = self.bits[st]
        nxt = (self.base[st] + (window >> (self.tl - nb))) & ((1 << self.tl)
                                                              - 1)
        return self.sym[st], nb, nxt


def decode_spans(codec, rd, idx, pos, st, end):
    """Lanes ``idx`` decode from (pos, st) until their position reaches
    ``end``, one step of every lane at a time; returns the exits and the
    symbols decoded."""
    rd.seek(idx, pos)
    pos, st = pos.copy(), st.copy()
    n = np.zeros(idx.size, np.int64)
    act = pos < end
    while act.any():
        _, nb, st[act] = codec.step(rd, idx[act], st[act])
        rd.skip(idx[act], nb)
        pos[act] += nb
        n[act] += 1
        act = pos < end
    return pos, st, n


def split_decode(codec, flat, off, B, count, threads, *, until="count",
                 L=None, tile=None):
    """One row as one block of the kernel decodes it.  Returns the (count,)
    symbols and the number of sync passes.  ``until="count"`` ends the
    passes as the kernel does, once the exact prefix holds ``count``
    symbols; ``until="all"`` waits until every subsequence agrees.  ``L``
    overrides the kernel's subsequence length.  ``tile=(N, n0, width)``
    makes phase 3 write as the fused kernel does: symbol i of the lane to
    row i // N, column i % N - n0 of an (count // N, width) uint8 tile,
    which is returned in place of the symbols."""
    if tile is None:
        out = np.zeros(count, np.int32)

        def put(i, sym):
            out[i] = sym
    else:
        N, n0, width = tile
        out = np.zeros((count // N, width), np.uint8)

        def put(i, sym):
            r, c = i // N, i % N - n0
            keep = (c >= 0) & (c < width)
            out[r[keep], c[keep]] = sym[keep]
    if count == 0:
        return out, 0
    if L is None:
        L, n_sub = split(8 * B, threads, codec.unit)
    else:
        n_sub = -(-8 * B // L)
    lanes = np.arange(n_sub)
    rd = Reader(flat, off, B, n_sub)
    start, end = lanes * L, lanes * L + L
    sst = np.zeros(n_sub, np.int64)
    start, sst = codec.first(rd, start, sst)
    ext, est, n = decode_spans(codec, rd, lanes, start, sst, end)   # phase 1
    passes = 0
    while True:                                                     # phase 2
        frm = np.concatenate([[0], ext[:-1]])
        frm_st = np.concatenate([[0], est[:-1]])
        behind = (lanes > 0) & ((start != frm) | (sst != frm_st))
        excl = np.cumsum(n) - n
        first = int(np.argmax(behind)) if behind.any() else n_sub
        covered = int(n.sum()) if first == n_sub else int(excl[first])
        if first == n_sub or (until == "count" and covered >= count):
            break
        b = lanes[behind]
        start[b], sst[b] = frm[b], frm_st[b]
        ext[b], est[b], n[b] = decode_spans(codec, rd, b, start[b], sst[b],
                                            end[b])
        passes += 1
    m = np.clip(np.minimum(n, count - excl), 0, None)              # phase 3
    rd.seek(lanes, start)
    st = sst.copy()
    for k in range(int(m.max())):
        act = k < m
        sym, nb, st[act] = codec.step(rd, lanes[act], st[act])
        rd.skip(lanes[act], nb)
        put(excl[act] + k, sym)
    return out, passes


def model_decode(codec, flat, offs, B, counts, threads, **kw):
    """(S, max(counts)) int32 of the rows at ``offs`` in ``flat``, zero past
    each row's count, and each row's sync passes."""
    out = np.zeros((len(offs), int(counts.max(initial=0))), np.int32)
    passes = []
    for i, (off, c) in enumerate(zip(offs, counts)):
        out[i, :c], p = split_decode(codec, flat, int(off), B, int(c),
                                     threads, **kw)
        passes.append(p)
    return out, passes


def _symbols(bits, shape, seed):
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    return np.clip(np.rint(rng.normal(hi / 2, hi / 6, shape)), 0,
                   hi - 1).astype(np.uint8)


def _rows(codec, bits, max_len, counts, seed, *, min_width=0, shift=0):
    """Rows of one table's streams, packed at ``min_width`` and laid
    contiguously from byte ``shift`` of a flat buffer (so a width that is
    no multiple of 4 puts rows at every alignment)."""
    counts = np.asarray(counts, np.int64)
    sym = _symbols(bits, (len(counts), int(counts.max())), seed)
    freqs = np.bincount(sym.ravel(), minlength=1 << bits)
    table = get_codec(codec).build(freqs, bits, max_code_len=max_len)
    streams = [table.encode(sym[i, :c])[0] for i, c in enumerate(counts)]
    mat, _ = jbits.pack_streams(streams, min_width=min_width)
    return table, mat, counts, _flat(mat, shift)


def _flat(mat, shift):
    S, B = mat.shape
    flat = np.full(shift + S * B + 8, 0xA5, np.uint8)   # bytes around rows
    flat[shift:shift + S * B] = mat.ravel()
    return flat, shift + B * np.arange(S)


def _main_path_row():
    """One 65,536-symbol Huffman-8 segment as the main path packs it: the
    embed of the narrow qwen3-1.7b config (512 x 128) under the main path's
    spec, its one segment through ``pack_segments`` (width padded to a
    power of two)."""
    from repro_torch.configs import registry
    from repro_torch.core.quant import Granularity
    from repro_torch.core.spec import CompressionSpec
    from repro_torch.core.store import CompressedModel
    from repro_torch.models import dense
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    embed = dense.init(cfg, 0, torch.device("cpu"))["embed"].float().numpy()
    spec = CompressionSpec.parse(SPEC,
                                 default_granularity=Granularity.PER_CHANNEL)
    cm = CompressedModel.compress({"embed": embed}, spec=spec)
    chunk = cm.scheduler(backend="numpy").plan()[0]
    mat, counts = pack_segments(cm.payload, chunk.segs[:1])
    return cm.table_for("embed"), mat, counts


CASES = (
    [pytest.param("huffman", b, ml, THREADS, "lanes", id=f"huffman{b}-max{ml}")
     for ml in (8, 12) for b in range(1, 9)]
    + [pytest.param("raw", b, b, THREADS, "lanes", id=f"raw{b}")
       for b in range(1, 9)]
    + [pytest.param("huffman", 8, 12, t, "threads", id=f"threads{t}")
       for t in (1, 2, 32, THREADS)]
    + [pytest.param("huffman", 6, 12, THREADS, "odd_width", id="odd-width"),
       pytest.param("huffman", 8, 12, THREADS, "short_count",
                    id="count-in-first-subsequence"),
       pytest.param("huffman", 4, 8, 64, "pow2_padding", id="pow2-padding"),
       pytest.param("huffman", 8, 12, THREADS, "main_path", id="main-path")])


@pytest.mark.parametrize("codec,bits,max_len,threads,kind", CASES)
def test_split_model_equals_host_decoders(codec, bits, max_len, threads,
                                          kind):
    seed = 10 * bits + max_len
    if kind == "main_path":
        table, mat, counts = _main_path_row()
        assert counts.tolist() == [65536] and mat.shape[1] == 65536
        flat, offs = _flat(mat, 1)
    elif kind == "pow2_padding":
        # one stream padded with zeros to a power-of-two width, as
        # pack_segments pads; its all-zero codeword is 3 bits, and L = 256
        # is no multiple of 3, so in the padding every subsequence's exit
        # is out of step with the next one's start
        table, mat, counts, (flat, offs) = _rows(codec, bits, max_len,
                                                 [3000], seed)
        width = jbits.pow2_bucket(mat.shape[1], 64)
        mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
        flat, offs = _flat(mat, 2)
        assert table.decode_arrays()["lut_len"][0] == 3
        assert split(8 * width, threads, max_len)[0] == 256
    elif kind == "odd_width":
        table, mat, counts, (flat, offs) = _rows(
            codec, bits, max_len, [900, 300, 0, 900, 900], seed,
            min_width=1023, shift=3)
    elif kind == "short_count":
        table, mat, counts, (flat, offs) = _rows(
            codec, bits, max_len, [3, 4096, 1], seed, shift=1)
    else:
        n = 700 if kind == "lanes" else 2000
        table, mat, counts, (flat, offs) = _rows(
            codec, bits, max_len, [n, n // 3, 0, n], seed, shift=bits % 4)
    B = mat.shape[1]
    a = table.decode_arrays()
    args = (mat, counts, a["lut_sym"], a["lut_len"], table.peek_bits)
    expect = jbits.decode_streams(*args)
    np.testing.assert_array_equal(tbits.decode_streams(*args), expect)
    got, passes = model_decode(Prefix(table), flat, offs, B, counts, threads)
    np.testing.assert_array_equal(got, expect)
    if codec == "raw":
        # L is a multiple of the raw code's width: every subsequence starts
        # on a codeword, so phase 1 is already exact
        assert passes == [0] * len(counts)
    if kind == "short_count":
        assert passes[0] == 0 and passes[2] == 0
    if kind == "pow2_padding":
        # the count rule stops once the data is exact; waiting for every
        # subsequence to agree walks the padding one subsequence a pass
        _, stall = model_decode(Prefix(table), flat, offs, B, counts, threads,
                                until="all")
        data = jbits.pack_streams([mat[0, :int(np.flatnonzero(mat[0])[-1])
                                       + 1 + jbits.GUARD_BYTES]])[0]
        dflat, doffs = _flat(data, 2)
        L = split(8 * B, threads, max_len)[0]
        # the same L over the data region alone, waiting for all of it
        _, need = split_decode(Prefix(table), dflat, int(doffs[0]),
                               data.shape[1], int(counts[0]), threads,
                               until="all", L=L)
        assert passes[0] <= need < stall[0]


@pytest.mark.parametrize("threads", [1, 32, 256])
def test_speculative_tans_split_is_exact(threads):
    """rANS-4 streams through the model with guessed starts: bitwise the
    host tANS decoders; the passes are what a split tans_decode would
    pay."""
    table, mat, counts, (flat, offs) = _rows("rans", 4, 12,
                                             [4096, 1000, 0, 4096], 4,
                                             shift=3)
    a = table.decode_arrays()
    args = (mat, counts, a["tab_sym"], a["tab_bits"], a["tab_base"],
            table.table_log)
    expect = jbits.decode_streams_tans(*args)
    np.testing.assert_array_equal(tbits.decode_streams_tans(*args), expect)
    got, passes = model_decode(Tans(table), flat, offs, mat.shape[1], counts,
                               threads)
    np.testing.assert_array_equal(got, expect)
    if threads == 1:
        assert passes == [0] * len(counts)


# ------------------------------------------- fused_prefix_matmul's decode

def _fused_lanes(codec, bits, max_len, K, N, seg, seed):
    """Layer 0's lane matrix as compressed-resident serving packs a fused
    tensor: each ``seg``-symbol segment of two layers' (K, N) symbols
    encoded alone, every lane of both layers packed to one power-of-two
    width, the larger layer's; layer 0's symbols spread less, so its lanes
    end in zero padding.  Returns the port's table, the JAX package's table
    built from the same histogram, layer 0's matrix and its symbols."""
    from repro.core.codecs import get_codec as jget_codec
    rng = np.random.default_rng(seed)
    hi = 1 << bits
    layers = [np.clip(np.rint(rng.normal(hi / 2, hi / spread, K * N)), 0,
                      hi - 1).astype(np.uint8) for spread in (12, 4)]
    freqs = np.bincount(np.concatenate(layers), minlength=hi)
    table = get_codec(codec).build(freqs, bits, max_code_len=max_len)
    jtable = jget_codec(codec).build(freqs, bits, max_code_len=max_len)
    streams = [[table.encode(sym[i:i + seg])[0]
                for i in range(0, sym.size, seg)] for sym in layers]
    width = tbits.pow2_bucket(max(tbits.GUARD_BYTES, max(
        st.size for lay in streams for st in lay)), 64)
    mat, _ = tbits.pack_streams(streams[0], min_width=width)
    return table, jtable, mat, layers[0].reshape(K, N)


FUSED_CASES = [
    pytest.param("huffman", 8, 12, 128, 64, 4096, None, id="huffman8-N64"),
    pytest.param("huffman", 8, 12, 4, 2048, 4096, None, id="huffman8-N2048"),
    pytest.param("raw", 4, 4, 128, 64, 4096, None, id="raw4-N64"),
    pytest.param("raw", 4, 4, 4, 2048, 4096, None, id="raw4-N2048"),
    pytest.param("huffman", 8, 12, 16, 512, 4096, (170, 171),
                 id="huffman8-column-tile"),
    pytest.param("huffman", 8, 12, 32, 2048, 65536, None,
                 id="huffman8-65536-symbol-lane"),
]


@pytest.mark.parametrize("codec,bits,max_len,K,N,seg,cols", FUSED_CASES)
def test_fused_prefix_tile_equals_lane_decoders(codec, bits, max_len, K, N,
                                                seg, cols):
    """The fused prefix kernel's decode of each lane, count seg, phase 3
    writing the row-major uint8 column tile: bitwise the JAX package's
    in-graph lane decode (``_decode_lanes_jax``) and the port's plain one
    (``decode_lanes_plain``), sliced to the lane's rows and the tile's
    columns."""
    from repro.kernels import fused_decode_matmul as jfused
    from repro_torch.kernels import fused_decode_matmul as tfused
    table, jtable, mat, sym = _fused_lanes(codec, bits, max_len, K, N, seg,
                                           seed=K + N + seg)
    S, B = mat.shape
    assert B > max(np.flatnonzero(row)[-1] for row in mat) + 1  # padded
    one = (np.float32(0.01), np.float32(0.0))
    jq = np.asarray(jfused._decode_lanes_jax(jfused.build_fused_qt(
        jtable, mat, *one, seg_symbols=seg, K=K, N=N, bits=bits,
        impl="jax")))
    tq = tfused.decode_lanes_plain(tfused.build_fused_qt(
        table, mat, *one, seg_symbols=seg, K=K, N=N, bits=bits,
        device="cpu")).numpy()
    np.testing.assert_array_equal(jq, sym)
    np.testing.assert_array_equal(tq, sym)
    n0, width = cols if cols else (0, N)
    R = seg // N
    flat, offs = _flat(mat, 1)
    for lane in range(S):
        tile, _ = split_decode(Prefix(table), flat, int(offs[lane]), B, seg,
                               THREADS, tile=(N, n0, width))
        np.testing.assert_array_equal(
            tile, jq[lane * R:(lane + 1) * R, n0:n0 + width])


def main():
    """Pass counts at the load path's shape: 65,536 symbols a stream in a
    row padded to a power of two, 1024 threads."""
    table, mat, counts = _main_path_row()
    flat, offs = _flat(mat, 0)
    out, passes = model_decode(Prefix(table), flat, offs, mat.shape[1],
                               counts, THREADS)
    a = table.decode_arrays()
    assert np.array_equal(out, tbits.decode_streams(
        mat, counts, a["lut_sym"], a["lut_len"], table.peek_bits))
    L, n_sub = split(8 * mat.shape[1], THREADS, table.peek_bits)
    print(f"huffman8 main path: B={mat.shape[1]} L={L} n_sub={n_sub} "
          f"passes={passes[0]}")
    for seed in range(3):
        sym = _symbols(4, 65536, seed)
        rt = get_codec("rans").build(np.bincount(sym, minlength=16), 4)
        stream = rt.encode(sym)[0]
        width = jbits.pow2_bucket(stream.size, 64)
        rmat, _ = jbits.pack_streams([stream], min_width=width)
        rflat, roffs = _flat(rmat, 0)
        rcounts = np.array([65536])
        out, passes = model_decode(Tans(rt), rflat, roffs, width, rcounts,
                                   THREADS)
        ra = rt.decode_arrays()
        assert np.array_equal(out, tbits.decode_streams_tans(
            rmat, rcounts, ra["tab_sym"], ra["tab_bits"], ra["tab_base"],
            rt.table_log))
        L, n_sub = split(8 * width, THREADS, 1)
        print(f"rans4 seed {seed}: B={width} L={L} n_sub={n_sub} "
              f"passes={passes[0]}")


if __name__ == "__main__":
    main()
