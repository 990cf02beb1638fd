"""The port's paged, compressible KV cache and int8 slot cache against the
JAX package's, on the CPU (counterpart of ``tests/test_kvcache.py``).

Reduced qwen3-1.7b (4 layers, d_model 128, 2 KV heads of 32), weights from
``jax.random.PRNGKey(0)`` crossed to the port as numpy arrays;
``MAX_LEN`` 48, blocks of 8, prefill chunks of 8 (so ``max_len`` and the
chunk are multiples of the block, the reference's bit-identity geometry).

* ``KVCompressionSpec`` parses, describes and refuses as the reference's.
* ``gather_blocks`` / ``scatter_blocks`` are **bitwise** the reference's,
  and the scatter writes the pool itself (a view, never a copy).
* ``kv_quantize`` (q, scale, zero) and ``kv_dequantize`` are **bitwise** the
  reference's op-by-op functions at 8 and 4 bits, and ``quantize_kv`` too.
  Jitted, the reference's ``kv_quantize`` rounds a few codes differently
  (ROADMAP queue 3, item 3); ``test_reference_kv_quantize_jit_split`` pins
  the size of that split.
* The int8 slot cache's chunked prefill and decode logits are within
  ``ATOL`` of the reference's.
* ``BlockKVManager``: tables, free lists, refcounts, LRU, ``kv_len`` and
  stats equal the reference's after the same ``alloc`` / ``insert`` /
  ``release`` sequence (the reference's lifecycle, trash-block, sharing,
  eviction-pin, cold-tier, release-all, ragged and double-release cases);
  cold-tier payloads are byte-equal to the reference's for the same leaves.
* The port's paged engine with bf16 blocks is **bitwise** its slot pool,
  and the reference's paged engine's tokens up to a reference near-tie
  (``tests/test_torch_serve.py``'s rule); quantized pools are deterministic
  and drift from bf16 blocks on at most ``DRIFT`` of the tokens (the
  reference's bound).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core.spec import KVCompressionSpec as JSpec
from repro.models import api as japi
from repro.models import dense as jdense
from repro.models import layers as jlayers
from repro.serving import engine as jengine
from repro.serving.batching import ContinuousEngine as JEngine
from repro.serving.batching import Request as JRequest
from repro.serving.batching import traffic as jtraffic
from repro.serving.kvcache import BlockKVManager as JManager
from repro.serving.kvcache import ColdBlockStore as JStore
from repro.serving.kvcache import cold as jcold
from repro.serving.kvcache import kv_cache_bytes as j_cache_bytes
from repro.serving.kvcache import kv_pool_bytes as j_pool_bytes
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.core.spec import KVCompressionSpec as TSpec
from repro_torch.models import api as tapi
from repro_torch.models import dense as tdense
from repro_torch.models import layers as tlayers
from repro_torch.serving import engine as tengine
from repro_torch.serving.batching import (ContinuousEngine, Request,
                                          RequestQueue, poisson_trace,
                                          replay)
from repro_torch.serving.kvcache import (BlockKVManager, ColdBlockStore,
                                         kv_cache_bytes, kv_pool_bytes)
from repro_torch.serving.kvcache import blocks as tblocks
from repro_torch.serving.kvcache import cold as tcold
from test_torch_serve import assert_tokens_equal_up_to_near_tie

MAX_LEN = 48
BS = 8          # block size; divides MAX_LEN and CHUNK
CHUNK = 8
ATOL = 2e-2     # logits, as tests/test_torch_batching.py
DRIFT = 0.6     # the reference's bound on quantized-pool token drift
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def harness():
    jcfg = jreg.reduced(jreg.get("qwen3-1.7b"))
    tcfg = treg.reduced(treg.get("qwen3-1.7b"))
    jp = japi.build(jcfg).init(jcfg, jax.random.PRNGKey(0))
    host = {k: np.asarray(v, np.float32) for k, v in jp.items()}
    tp = convert.params_from_numpy(tcfg, host, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                sc=tengine.ServeConfig(max_len=MAX_LEN),
                jsc=jengine.ServeConfig(max_len=MAX_LEN))


def _tcfg():
    return treg.reduced(treg.get("qwen3-1.7b"))


def _jcfg():
    return jreg.reduced(jreg.get("qwen3-1.7b"))


def _tok(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, (n,)).astype(
        np.int32)


def _bits(a):
    """Host array of a tensor / jax array, bf16 as its 16-bit pattern."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _tb(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _jb(a):
    return jnp.asarray(a, jnp.bfloat16)


# -------------------------------------------------------------------- policy

@pytest.mark.parametrize("text,over", [
    ("bits=4,block=16,codec=rans,sharing", {}),
    ("8", {}), ("", {}), ("bits=8, block=32, codec=huffman", {}),
    ("sharing=yes,bits=16", {"block_size": 4}),
    ("bits=4,codec=none", {"sharing": True}),
])
def test_kv_spec_parse_describe_equal_reference(text, over):
    got, want = TSpec.parse(text, **over), JSpec.parse(text, **over)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    assert TSpec.parse(got.describe()).describe() == got.describe()


@pytest.mark.parametrize("kw,match", [
    (dict(bits=5), "bits"), (dict(bits=16, codec="rans"), "codec"),
    (dict(block_size=0), "block_size"), (dict(bits=8, codec="lzw"), "lzw"),
])
def test_kv_spec_refusals_equal_reference(kw, match):
    for cls in (TSpec, JSpec):
        with pytest.raises((ValueError, KeyError), match=match):
            cls(**kw).validate()
    with pytest.raises(ValueError, match="unknown kv-spec key"):
        TSpec.parse("bitz=4")


def test_supports_paged_kv_and_sizing_helpers():
    cfg, jcfg = _tcfg(), _jcfg()
    assert tapi.supports_paged_kv(cfg)
    assert not tapi.supports_paged_kv(treg.reduced(treg.get("mamba2-370m")))
    for bits in (16, 8, 4):
        assert kv_pool_bytes(cfg, 8, BS, bits) == \
            j_pool_bytes(jcfg, 8, BS, bits)
    assert kv_cache_bytes(cfg, 3, MAX_LEN) == j_cache_bytes(jcfg, 3, MAX_LEN)
    assert kv_pool_bytes(cfg, 8, BS, 4) < kv_pool_bytes(cfg, 8, BS, 16) / 2
    m = BlockKVManager(cfg, n_slots=2, max_len=MAX_LEN, device=CPU,
                       spec=TSpec(block_size=BS))
    assert m.pool_bytes == (kv_cache_bytes(cfg, 2, MAX_LEN)
                            + kv_pool_bytes(cfg, 1, BS, 16))


# ------------------------------------------------------- layer primitives

def _pool_case(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    NB, B, KV, hd = 7, 3, 2, 4
    pool = rng.normal(size=(NB, BS, KV, hd)).astype(dtype)
    bt = np.array([[3, 5, 0], [1, 2, 6], [0, 0, 0]], np.int32)
    pos = np.array([[6, 7, 8], [0, 9, 17], [0, 1, 2]], np.int32)
    val = rng.normal(size=(B, 3, KV, hd)).astype(dtype)
    return pool, bt, pos, val


def test_gather_and_scatter_blocks_equal_reference():
    pool, bt, pos, val = _pool_case(0)
    got = tlayers.scatter_blocks(_tb(pool), torch.from_numpy(bt),
                                 torch.from_numpy(pos), _tb(val))
    want = jlayers.scatter_blocks(_jb(pool), jnp.asarray(bt),
                                  jnp.asarray(pos), _jb(val))
    # lane 2 aims three rows at the trash block: compare live blocks only
    np.testing.assert_array_equal(_bits(got)[1:], _bits(want)[1:])
    for b in range(2):
        np.testing.assert_array_equal(
            _bits(tlayers.gather_blocks(got, torch.from_numpy(bt))[b]),
            _bits(jlayers.gather_blocks(want, jnp.asarray(bt))[b]))
    g = tlayers.gather_blocks(got, torch.from_numpy(bt))
    assert tuple(g.shape) == (3, 3 * BS, 2, 4)


def test_scatter_writes_the_pool_in_place():
    """On a layer slice of a stacked pool (the step functions' call), the
    rows land in the stacked pool itself; live blocks no lane aims at keep
    their bytes, and duplicate targets only ever hit the trash block."""
    pool, bt, pos, val = _pool_case(1)
    # a fourth lane idle like the third: both aim at the trash block
    bt, pos = np.vstack([bt, bt[2:]]), np.vstack([pos, pos[2:]])
    val = np.concatenate([val, val[:1] + 1])
    stacked = torch.stack([_tb(pool), _tb(pool)])          # (L, NB, BS, ..)
    before = stacked.clone()
    leaf = stacked[1]
    out = tlayers.scatter_blocks(leaf, torch.from_numpy(bt),
                                 torch.from_numpy(pos), _tb(val))
    assert out.data_ptr() == stacked[1].data_ptr()
    assert torch.equal(stacked[0], before[0])
    assert torch.equal(stacked[1, 3, 6], _tb(val)[0, 0])   # (b=0, pos 6)
    assert torch.equal(stacked[1, 2, 1], _tb(val)[1, 1])   # (b=1, pos 9)
    touched = {int(bt[b, p // BS]) for b in range(4) for p in pos[b]}
    for blk in set(range(7)) - touched:
        assert torch.equal(stacked[1, blk], before[1, blk]), blk
    targets = [(int(bt[b, p // BS]), int(p % BS)) for b in range(4)
               for p in pos[b]]
    dups = {t for t in targets if targets.count(t) > 1}
    assert dups and all(blk == 0 for blk, _ in dups)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scale", [0.1, 3.0])
def test_kv_quantize_and_dequantize_equal_reference(bits, scale):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(16, 8, 4, 32)) * scale).astype(np.float32)
    x[0, 0, 0] = 1.5                                   # a constant vector
    tq = tlayers.kv_quantize(_tb(x), bits)
    jq = jlayers.kv_quantize(_jb(x), bits)
    assert tq[0].dtype == torch.uint8
    assert tq[0].shape[-1] == (32 if bits == 8 else 16)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    td = tlayers.kv_dequantize(*tq, bits)
    np.testing.assert_array_equal(_bits(td),
                                  _bits(jlayers.kv_dequantize(*jq, bits)))
    jit = jax.jit(lambda q, s, z: jlayers.kv_dequantize(q, s, z, bits))
    np.testing.assert_array_equal(_bits(td), _bits(jit(*jq)))


@pytest.mark.parametrize("bits", [8, 4])
def test_reference_kv_quantize_jit_split(bits):
    """ROADMAP queue 3, item 3: jitted, the JAX package's ``kv_quantize``
    (as its paged engine runs it) gives other codes than op by op on a few
    elements, never by more than one step; the port follows op by op."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 16, 8, 128)) * 3).astype(np.float32)
    eager = _bits(jlayers.kv_quantize(_jb(x), bits)[0])
    jitted = _bits(jax.jit(lambda a: jlayers.kv_quantize(a, bits))(_jb(x))[0])
    port = _bits(tlayers.kv_quantize(_tb(x), bits)[0])
    np.testing.assert_array_equal(port, eager)
    if bits == 4:                                  # unpack the nibbles
        eager, jitted = (np.stack([a & 15, a >> 4], -1) for a in (eager,
                                                                  jitted))
    diff = eager.astype(np.int16) - jitted.astype(np.int16)
    assert 0 < np.count_nonzero(diff) <= 2e-3 * diff.size
    assert np.abs(diff).max() == 1


def test_quantize_kv_equals_reference():
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 5, 2, 32)).astype(np.float32)
    k[1, 2, 0] = 0.0                                   # the 1e-8 floor
    tq, ts = tdense.quantize_kv(_tb(k))
    jq, js = jdense.quantize_kv(_jb(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(_bits(tdense.dequantize_kv(tq, ts)),
                                  _bits(jdense.dequantize_kv(jq, js)))


def test_int8_slot_cache_logits_equal_reference(harness):
    """Chunked prefill, then decode steps, on the four-leaf int8 cache:
    logits within ATOL of the reference's, greedy tokens equal, and the
    layer 0's codes within one int8 step of the reference's."""
    h = harness
    cfg, jcfg = h["tcfg"], h["jcfg"]
    prompt = _tok(cfg.vocab, 16, 5)[None]
    cache = tdense.init_cache(cfg, 1, MAX_LEN, kv_bits=8, device=CPU)
    jcache = jdense.init_cache(jcfg, 1, MAX_LEN, kv_bits=8)
    assert sorted(cache) == sorted(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
    pos = torch.zeros((1,), dtype=torch.int64)
    tok, jtok = torch.as_tensor(prompt, dtype=torch.int64), jnp.asarray(prompt)
    for i in range(4):
        with torch.inference_mode():
            lg, cache = tdense.prefill_chunk(cfg, h["tp"], tok, cache, pos)
        jlg, jcache = jdense.prefill_chunk(jcfg, h["jp"], jtok, jcache,
                                           jnp.asarray(pos.numpy(), jnp.int32))
        np.testing.assert_allclose(lg.float().numpy(),
                                   np.asarray(jlg, np.float32), atol=ATOL,
                                   rtol=0)
        nxt = int(np.argmax(np.asarray(jlg, np.float32)[0, -1]))
        assert int(lg[0, -1].float().argmax()) == nxt, i
        pos = pos + tok.shape[1]
        tok, jtok = torch.tensor([[nxt]]), jnp.asarray([[nxt]], jnp.int32)
    # layer 0's K/V are bitwise in both packages before quantization, so
    # its codes differ only where the jitted reference divides differently
    n = int(pos[0])
    for k in ("k", "v"):
        d = _bits(cache[k])[0, :, :n].astype(int) - \
            _bits(jcache[k])[0, :, :n].astype(int)
        assert np.abs(d).max() <= 1 and np.count_nonzero(d) < 0.01 * d.size
        assert not _bits(cache[k])[:, :, n:].any()


# ------------------------------------------------------------- block manager

def _pair(n_slots, n_blocks=None, **spec):
    """The port's and the reference's manager on one geometry."""
    tm = BlockKVManager(_tcfg(), n_slots, MAX_LEN, device=CPU,
                        spec=TSpec(block_size=BS, **spec), n_blocks=n_blocks,
                        prefill_chunk=CHUNK)
    jm = JManager(_jcfg(), n_slots, MAX_LEN, spec=JSpec(block_size=BS, **spec),
                  n_blocks=n_blocks, prefill_chunk=CHUNK)
    return tm, jm


def _state(m):
    return dict(tables=m.tables.tolist(), kv_len=m.kv_len.tolist(),
                live=list(m._live), free_slots=list(m._free_slots),
                free_blocks=list(m._free_blocks), refs=dict(m._refs),
                chain=sorted(m._chain.values()), lru=list(m._lru),
                private=[list(p) for p in m._slot_private],
                shared=[[j for j, _ in s] for s in m._slot_shared],
                stats={k: v for k, v in m.stats().items()
                       if k not in ("pool_bytes", "cold_bytes")})


class _Both:
    """Drive the two managers through the same calls and hold their host
    state equal after every one."""

    def __init__(self, tm, jm):
        self.tm, self.jm = tm, jm
        self.reqs = {}

    def _check(self):
        assert _state(self.tm) == _state(self.jm)

    def alloc(self, prompt, gen=4):
        t = Request(prompt=np.asarray(prompt, np.int32), max_new_tokens=gen)
        j = JRequest(prompt=np.asarray(prompt, np.int32), max_new_tokens=gen)
        assert self.tm.can_admit(t) == self.jm.can_admit(j)
        got, want = self.tm.alloc(t), self.jm.alloc(j)
        assert got == want
        self._check()
        if got is not None:
            self.reqs[got[0]] = (t, j)
        return got

    def insert(self, slot, kv_len):
        self.tm.insert(slot, kv_len)
        self.jm.insert(slot, kv_len)
        self._check()

    def release(self, slot):
        t, j = self.reqs.pop(slot)
        assert self.tm.release(slot) is t and self.jm.release(slot) is j
        self._check()


def _lifecycle(both, vocab):
    got = both.alloc(_tok(vocab, 12, 0), gen=4)
    assert got == (0, 0)
    row = both.tm.table_rows([0])[0]
    assert (row[:2] != 0).all() and not row[2:].any()
    both.insert(0, 12)
    both.release(0)
    assert both.tm.n_free_blocks == both.tm.n_blocks - 1
    assert not both.tm.tables.any()


def _decode_tables(both, vocab):
    s0, _ = both.alloc(_tok(vocab, 9, 1))
    both.insert(s0, 9)
    s1, _ = both.alloc(_tok(vocab, 9, 2))          # allocated, not live yet
    for m in (both.tm, both.jm):
        dt = m.decode_tables()
        assert dt[s0].any() and not dt[s1].any()
        assert m.table_rows([s1]).any()
    assert (both.tm.decode_tables() == both.jm.decode_tables()).all()
    both.insert(s1, 9)
    assert both.tm.decode_tables()[s1].any()


def _prefix_sharing(both, vocab):
    prefix = _tok(vocab, 2 * BS, 3)
    s0, skip0 = both.alloc(np.concatenate([prefix, _tok(vocab, 4, 4)]))
    assert skip0 == 0
    both.insert(s0, 2 * BS + 4)
    s1, skip1 = both.alloc(np.concatenate([prefix, _tok(vocab, 6, 5)]))
    assert skip1 == 2 * BS and both.tm.shared_hits == 2
    both.insert(s1, 2 * BS + 6)
    both.release(s0)
    s2, skip2 = both.alloc(np.concatenate([prefix, _tok(vocab, 4, 6)]))
    assert skip2 == 2 * BS
    both.release(s1)
    both.release(s2)


def _eviction_pin(both, vocab):
    pa = _tok(vocab, BS, 7)
    for prompt in [pa, _tok(vocab, BS, 8)]:
        s, _ = both.alloc(prompt, gen=BS)
        both.insert(s, BS)
        both.release(s)
    a_blk = int(both.tm._chain[both.tm._chain_keys(pa)[0]])
    before = tblocks._read_block(both.tm.pool, a_blk)
    s, skip = both.alloc(np.concatenate([pa, _tok(vocab, 32, 9)]), gen=8)
    assert skip == BS and both.tm.dropped_evictions == 1
    assert int(both.tm.table_rows([s])[0][0]) == a_blk
    after = tblocks._read_block(both.tm.pool, a_blk)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    both.insert(s, 5 * BS)
    both.release(s)


def _release_all(both, vocab):
    prompts = [_tok(vocab, 12, s) for s in (20, 21)]
    slots = [both.alloc(p)[0] for p in prompts]
    for s, p in zip(slots, prompts):
        both.insert(s, len(p))
    for s in slots:
        both.release(s)
    assert both.tm.n_free == 2 and len(both.tm._lru) == 2
    s, skip = both.alloc(prompts[0])
    assert skip == BS
    both.insert(s, 12)


def _ragged(both, vocab):
    lens = [4, 9, 13]
    slots = [both.alloc(_tok(vocab, n, 30 + n))[0] for n in lens]
    for s, n in zip(slots, lens):
        both.insert(s, n)
    both.release(slots[1])
    assert both.tm.kv_len.tolist() == [4, 0, 13]
    s, _ = both.alloc(_tok(vocab, 5, 40))
    assert s == slots[1] and both.tm.kv_len[s] == 0


def _double_release(both, vocab):
    s, _ = both.alloc(_tok(vocab, 4, 50))
    both.insert(s, 4)
    with pytest.raises(AssertionError, match="double insert"):
        both.tm.insert(s, 4)
    both.release(s)
    with pytest.raises(AssertionError, match="free slot"):
        both.tm.release(s)


@pytest.mark.parametrize("case,n_slots,n_blocks,spec", [
    (_lifecycle, 2, None, {}),
    (_decode_tables, 2, None, {}),
    (_prefix_sharing, 3, None, dict(sharing=True)),
    (_eviction_pin, 2, 7, dict(sharing=True)),
    (_release_all, 2, None, dict(sharing=True)),
    (_ragged, 3, None, {}),
    (_double_release, 1, None, {}),
], ids=["lifecycle", "trash-block", "prefix-sharing", "eviction-pin",
        "release-all", "ragged-kv-len", "double-release"])
def test_block_manager_state_equals_reference(case, n_slots, n_blocks, spec):
    both = _Both(*_pair(n_slots, n_blocks, **spec))
    case(both, _tcfg().vocab)


def test_manager_rejects_bad_geometry():
    with pytest.raises(ValueError, match="chunk"):
        BlockKVManager(_tcfg(), 1, MAX_LEN, prefill_chunk=6, device=CPU,
                       spec=TSpec(block_size=BS, sharing=True))
    with pytest.raises(ValueError, match="n_blocks"):
        BlockKVManager(_tcfg(), 1, MAX_LEN, n_blocks=3, device=CPU,
                       spec=TSpec(block_size=BS))


# ----------------------------------------------------------------- cold tier

def _stamp(both, blocks, seed):
    """The same random bytes into blocks of both pools (a faked prefill)."""
    rng = np.random.default_rng(seed)
    jpool = {k: np.array(v) for k, v in both.jm.pool.items()}
    for blk in blocks:
        for k, c in both.tm.pool.items():
            shape = tuple(c[:, blk].shape)
            if c.dtype == torch.uint8:
                v = rng.integers(0, 255, shape).astype(np.uint8)
                c[:, blk] = torch.from_numpy(v)
                jpool[k][:, blk] = v
            else:
                v = rng.normal(size=shape).astype(np.float32)
                c[:, blk] = torch.from_numpy(v).bfloat16()
                jpool[k][:, blk] = v.astype(jnp.bfloat16)
    both.jm.pool = {k: jnp.asarray(v) for k, v in jpool.items()}


@pytest.mark.parametrize("bits,codec", [(8, "rans"), (4, "huffman")])
def test_cold_tier_evict_restore_payloads_equal_reference(bits, codec):
    """Evicted shared blocks: the cold entries are byte-equal to the
    reference's (streams, counts, shapes, raw scale / zero bit patterns,
    entry bytes), and the next prefix hit restores the blocks exactly."""
    both = _Both(*_pair(2, 7, bits=bits, codec=codec, sharing=True))
    vocab = _tcfg().vocab
    pa = _tok(vocab, 2 * BS, 10)
    sa, _ = both.alloc(pa, gen=8)
    row = both.tm.table_rows([sa])[0]
    _stamp(both, [int(row[0]), int(row[1])], seed=bits)
    originals = [tblocks._read_block(both.tm.pool, int(row[j]))
                 for j in range(2)]
    both.insert(sa, len(pa))
    both.release(sa)
    sb, _ = both.alloc(_tok(vocab, 5 * BS, 11), gen=8)   # evicts A0 + A1
    assert both.tm.cold_evictions == 2 and len(both.tm.cold) == 2
    assert both.tm.cold_bytes == both.jm.cold_bytes > 0
    assert both.tm.cold.effective_bits == both.jm.cold.effective_bits
    for key, entry in both.tm.cold._entries.items():
        want = both.jm.cold._entries[key]
        assert tcold.entry_nbytes(entry) == jcold.entry_nbytes(want)
        assert sorted(entry) == sorted(want)
        for name, leaf in entry.items():
            ref = want[name]
            if isinstance(leaf, tcold._ColdLeaf):
                np.testing.assert_array_equal(leaf.stream, ref.stream)
                assert (leaf.count, leaf.shape) == (ref.count, ref.shape)
                assert leaf.table.kernel == ref.table.kernel
            else:
                assert leaf.dtype == np.int16
                np.testing.assert_array_equal(leaf, _bits(ref))
    both.insert(sb, 5 * BS)
    both.release(sb)
    sa2, skip = both.alloc(pa, gen=8)
    assert both.tm.cold_restores == 2 and skip == BS
    row2 = both.tm.table_rows([sa2])[0]
    for j in range(2):
        restored = tblocks._read_block(both.tm.pool, int(row2[j]))
        jrestored = {k: _bits(v[:, int(row2[j])])
                     for k, v in both.jm.pool.items()}
        for k in restored:
            np.testing.assert_array_equal(restored[k], originals[j][k])
            np.testing.assert_array_equal(restored[k], jrestored[k])


def test_cold_store_entropy_codes_uint8_leaves_like_reference():
    rng = np.random.default_rng(0)
    leaves = {
        "k": rng.choice(8, size=(2, 16, 2, 4)).astype(np.uint8),
        "k_scale": rng.normal(size=(2, 16, 2, 1)).astype(np.float32),
    }
    store, jstore = ColdBlockStore("rans"), JStore("rans")
    store.put("key", leaves)
    jstore.put("key", leaves)
    assert "key" in store and store.effective_bits < 8.0
    assert store.effective_bits == jstore.effective_bits
    assert store.nbytes == jstore.nbytes
    got = store.pop("key")
    assert "key" not in store and len(store) == 0
    for k in leaves:
        np.testing.assert_array_equal(got[k], leaves[k])
    with pytest.raises(KeyError):
        ColdBlockStore("lzw")


def test_export_import_blocks_round_trip():
    """A request's blocks exported from one pool and imported into another
    arrive bit for bit, private, at the same ``kv_len``."""
    src = BlockKVManager(_tcfg(), 2, MAX_LEN, device=CPU, prefill_chunk=CHUNK,
                         spec=TSpec(bits=4, block_size=BS, sharing=True))
    dst = BlockKVManager(_tcfg(), 2, MAX_LEN, device=CPU, prefill_chunk=CHUNK,
                         spec=TSpec(bits=4, block_size=BS))
    req = Request(prompt=_tok(_tcfg().vocab, 19, 12), max_new_tokens=6)
    s, _ = src.alloc(req)
    rng = np.random.default_rng(2)
    for c in src.pool.values():
        shape = tuple(c.shape)
        c.copy_(torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
                if c.dtype == torch.uint8 else
                torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
    src.insert(s, 19)
    blocks = src.export_blocks(s)
    assert len(blocks) == 3 and blocks[0]["k_scale"].dtype == np.int16
    other = Request(prompt=req.prompt, max_new_tokens=6)
    assert dst.can_import(other, 19, len(blocks))
    d = dst.import_blocks(other, 19, blocks)
    assert d is not None and dst.kv_len[d] == 19 and dst._live[d]
    assert not dst._chain and len(dst._slot_private[d]) == 4   # 25 rows
    for j in range(3):
        got = tblocks._read_block(dst.pool, int(dst.tables[d, j]))
        for k in got:
            np.testing.assert_array_equal(got[k], blocks[j][k])
    big = Request(prompt=req.prompt, max_new_tokens=MAX_LEN)
    assert not dst.can_import(big, 19, 3)


# ------------------------------------------------------------------- traffic

def test_queue_peek_agrees_with_pop():
    q = RequestQueue(max_queue=4)
    dead = Request(prompt=np.ones(3, np.int32), max_new_tokens=2,
                   deadline_s=0.5)
    live = Request(prompt=np.ones(3, np.int32), max_new_tokens=2)
    q.submit(dead, now=0.0)
    q.submit(live, now=0.0)
    assert q.peek(now=1.0) is live and len(q) == 1 and q.expired == [dead]
    assert q.peek(now=1.0) is live and q.pop(now=1.0) is live
    assert q.peek() is None


def test_paged_admission_reads_the_clock_once(harness, monkeypatch):
    """The head's deadline passes between the block plan and the pop: the
    engine plans and pops at one reading of the clock, so the request it
    planned is the one it admits."""
    ce = ContinuousEngine(harness["tcfg"], harness["tp"], harness["sc"],
                          n_slots=1, prefill_chunk=CHUNK,
                          kv_spec=TSpec(bits=16, block_size=BS), device="cpu")
    ticks = iter([0.0, 10.0])          # submit, then the admission's reading
    monkeypatch.setattr(time, "monotonic", lambda: next(ticks, 20.0))
    req = ce.submit(_tok(harness["tcfg"].vocab, 5, 3), 2, deadline_s=15.0)
    ce.run()
    assert req.finish_reason == "length" and len(req.output) == 2
    assert not ce.queue.expired


def test_shared_prompt_trace_equals_reference():
    """The chip phase's trace: 24 requests over two 32-token prompts."""
    kw = dict(rate_per_s=100.0, prompt_max=64, gen_max=16, vocab=151936,
              seed=0, prefix_pool=2, prefix_len=32)
    got, want = poisson_trace(24, **kw), jtraffic.poisson_trace(24, **kw)
    for (ta, tp, tg), (wa, wp, wg) in zip(got, want):
        assert ta == wa and tg == wg
        np.testing.assert_array_equal(tp, wp)
    assert len({p[:32].tobytes() for _, p, _ in got}) == 2


# ------------------------------------------------------------ engine parity

def _jobs(vocab):
    """Six requests over two shared 2-block system prompts + ragged tails
    (the reference's)."""
    rng = np.random.default_rng(0)
    prefixes = [_tok(vocab, 2 * BS, 100 + i) for i in range(2)]
    jobs = []
    for i, tail in enumerate([5, 9, 2, 7, 11, 3]):
        p = np.concatenate([prefixes[i % 2], _tok(vocab, tail, 200 + i)])
        jobs.append((p, int(rng.integers(3, 7))))
    return jobs


def _run(h, jobs, spec=None, n_blocks=None, n_slots=3):
    ce = ContinuousEngine(h["tcfg"], h["tp"], h["sc"], n_slots=n_slots,
                          prefill_chunk=CHUNK, kv_spec=spec,
                          kv_blocks=n_blocks, device="cpu")
    reqs = [ce.submit(p, g) for p, g in jobs]
    ce.run()
    assert all(r.finish_reason == "length" for r in reqs)
    return [r.output for r in reqs], ce


def _jax_solo_logits(h, prompt, gen):
    steps = jengine.ServeSteps(h["jcfg"], h["jsc"])
    logits, cache = steps.prefill_fn(h["jp"], jnp.asarray(prompt[None]))
    out, toks = [], []
    for i in range(gen):
        lg = np.asarray(logits, np.float32)[0, -1]
        out.append(lg)
        toks.append(int(np.argmax(lg)))
        if i + 1 < gen:
            logits, cache = steps.decode_fn(
                h["jp"], jnp.asarray([[toks[-1]]], jnp.int32), cache,
                jnp.int32(len(prompt) + i))
    return np.asarray(toks), np.stack(out)


def test_paged_dense_engine_bitwise_slot_pool_and_reference(harness):
    """bf16 blocks + prefix sharing through the whole scheduler: every
    request's tokens bitwise the port's slot pool, and the JAX package's
    paged engine's up to a reference near-tie (the reference's solo logits
    are the oracle: its paged tokens equal its solo tokens)."""
    h = harness
    jobs = _jobs(h["tcfg"].vocab)
    want, _ = _run(h, jobs)
    spec = dict(bits=16, block_size=BS, sharing=True)
    got, ce = _run(h, jobs, TSpec(**spec))
    assert got == want
    st = ce.slots.stats()
    assert st["shared_hits"] > 0 and st["pool_bytes"] > 0
    jce = JEngine(h["jcfg"], h["jp"], h["jsc"], n_slots=3,
                  prefill_chunk=CHUNK, kv_spec=JSpec(**spec))
    jreqs = [jce.submit(p, g) for p, g in jobs]
    jce.run()
    assert jce.slots.stats()["shared_hits"] == st["shared_hits"]
    compared = 0
    for (prompt, gen), out, jr in zip(jobs, got, jreqs):
        toks, logits = _jax_solo_logits(h, prompt, gen)
        assert jr.output == toks.tolist()
        compared += assert_tokens_equal_up_to_near_tie(
            np.asarray([out]), toks[None], logits[:, None])
    assert compared >= len(jobs)


def test_paged_poisson_trace_bitwise_slot_pool(harness):
    """A shared-prompt Poisson trace replayed with more requests than slots
    and a pool too small to keep every published block: bf16 blocks equal
    the slot pool token for token, and the tight pool evicted."""
    h = harness
    trace = poisson_trace(8, rate_per_s=100.0, prompt_max=24, gen_max=8,
                          vocab=h["tcfg"].vocab, seed=0, prefix_pool=2,
                          prefix_len=2 * BS)

    def run(spec=None, n_blocks=None):
        ce = ContinuousEngine(h["tcfg"], h["tp"], h["sc"], n_slots=3,
                              prefill_chunk=CHUNK, kv_spec=spec,
                              kv_blocks=n_blocks, device="cpu")
        reqs, shed, _ = replay(ce, trace)
        assert shed == 0 and all(r.finish_reason == "length" for r in reqs)
        return [r.output for r in reqs], ce

    want, _ = run()
    got, ce = run(TSpec(bits=16, block_size=BS, sharing=True), n_blocks=8)
    assert got == want
    st = ce.slots.stats()
    assert st["shared_hits"] > 0 and st["dropped_evictions"] > 0


def test_paged_quantized_engine_bounded_deterministic_drift(harness):
    """Quantized blocks: outputs keep their lengths, two runs are bitwise
    equal, drift against bf16 blocks stays within the reference's bound,
    and a tight 4-bit pool spills to the cold tier and restores."""
    h = harness
    jobs = _jobs(h["tcfg"].vocab)
    ref, _ = _run(h, jobs, TSpec(bits=16, block_size=BS, sharing=True))
    toks = sum(len(o) for o in ref)
    for bits, n_blocks in ((8, None), (4, 8)):
        spec = TSpec(bits=bits, block_size=BS, codec="rans", sharing=True)
        q1, ce = _run(h, jobs + jobs[:2], spec, n_blocks=n_blocks)
        q2, _ = _run(h, jobs + jobs[:2], spec, n_blocks=n_blocks)
        assert q1 == q2
        q1 = q1[:len(jobs)]
        assert [len(o) for o in q1] == [len(o) for o in ref]
        diverged = sum(t != r for o, ro in zip(q1, ref)
                       for t, r in zip(o, ro))
        assert diverged / toks <= DRIFT, (bits, diverged, toks)
        if n_blocks is not None:
            st = ce.slots.stats()
            assert st["cold_evictions"] > 0 and st["cold_restores"] > 0


def test_paged_engine_refusals(harness):
    h = harness
    spec = TSpec(block_size=BS)
    ssm = treg.reduced(treg.get("mamba2-370m"))
    with pytest.raises(NotImplementedError):
        ContinuousEngine(ssm, {}, h["sc"], kv_spec=spec, device="cpu")
    steps = tengine.ServeSteps(h["tcfg"], h["sc"], resident="compressed")
    assert steps.paged_decode_fn is None and \
        steps.paged_prefill_chunk_fn is None

    class _Resident:                  # a compressed-resident store's face
        device = "cpu"
    with pytest.raises(NotImplementedError, match="resident='dense'"):
        ContinuousEngine(h["tcfg"], _Resident(), h["sc"], kv_spec=spec,
                         resident="compressed", device="cpu")


def test_launcher_serves_and_refuses_paged_flags(capsys):
    from repro_torch.launch import serve as tserve
    rc = tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu",
                      "--batch-slots", "3", "--traffic", "4",
                      "--prefix-sharing", "--kv-spec", "bits=4,codec=rans",
                      "--decode-backend", "numpy", "--compress-spec",
                      "*:bits=8,codec=huffman; defaults:segment_symbols=4096"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("  paged KV [bits=4,block=16,codec=rans,"
                             "sharing]: pool ") for ln in out)
    assert out[-1].startswith("  paged KV: prefix hit rate ")
    assert "4/4 requests" in out[-4]
    for flags, err in (
            (["--kv-spec", "bits=8"], "--batch-slots"),
            (["--batch-slots", "2", "--kv-block", "8", "--resident",
              "compressed"], "--resident dense"),
            (["--batch-slots", "2", "--prefix-sharing", "--kv-block", "8",
              "--prefill-chunk", "12"], "divisible"),
            (["--batch-slots", "2", "--kv-spec", "bits=5"], "bad --kv-spec"),
            (["--batch-slots", "2", "--kv-spec", "bits=8", "--mesh", "2x1"],
             "paged KV (--kv-spec) is single-device today; drop --mesh")):
        with pytest.raises(SystemExit):
            tserve.main(["--arch", "qwen3-1.7b", "--device", "cpu", *flags])
        assert err in capsys.readouterr().err, flags
