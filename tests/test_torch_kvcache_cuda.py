"""The paged KV cache on the card.

Every test needs an NVIDIA card (marker ``cuda``) and skips elsewhere.  The
file imports neither ``jax`` nor the JAX package, so it runs on a machine
that has only the port:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_kvcache_cuda.py

* ``scatter_blocks`` writes a CUDA pool in place (a layer slice of the
  stacked pool, as the step functions pass it), bitwise as on the CPU.
* Idle lanes' duplicate writes all land in the trash block: on CUDA
  ``index_put_`` picks a winner among duplicates element by element, and
  no live block may change.
* A reduced qwen3-1.7b ``ContinuousEngine`` on the card with bf16 blocks
  and prefix sharing gives every request bitwise the tokens of the same
  engine on the card's slot pool.
* A cold-tier evict / restore round trip through a CUDA pool restores the
  blocks bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core.spec import KVCompressionSpec
from repro_torch.models import dense
from repro_torch.models import layers
from repro_torch.serving import engine
from repro_torch.serving.batching import (ContinuousEngine, Request,
                                          poisson_trace, replay)
from repro_torch.serving.kvcache import BlockKVManager
from repro_torch.serving.kvcache import blocks

MAX_LEN = 48
BS = 8
CHUNK = 8
CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scatter_case(seed):
    rng = np.random.default_rng(seed)
    L, NB, KV, hd = 2, 7, 8, 128
    pool = torch.from_numpy(rng.normal(size=(L, NB, BS, KV, hd)).astype(
        np.float32)).bfloat16()
    # lanes 0-1 live, lanes 2-3 idle: all-trash rows writing positions 0..2
    bt = torch.tensor([[3, 5, 0], [1, 2, 6], [0, 0, 0], [0, 0, 0]])
    pos = torch.tensor([[6, 7, 8], [0, 9, 17], [0, 1, 2], [0, 1, 2]])
    val = torch.from_numpy(rng.normal(size=(4, 3, KV, hd)).astype(
        np.float32)).bfloat16()
    return pool, bt, pos, val


@pytest.mark.cuda
def test_scatter_in_place_on_card_equals_cpu(card):
    pool, bt, pos, val = _scatter_case(0)
    out = []
    for dev in (card, CPU):
        stacked = pool.to(dev)
        ptr = stacked[1].data_ptr()
        got = layers.scatter_blocks(stacked[1], bt.to(dev), pos.to(dev),
                                    val.to(dev))
        assert got.data_ptr() == ptr
        out.append(stacked.cpu())
    on_card, on_cpu = out
    assert torch.equal(on_card[:, 1:], on_cpu[:, 1:])      # all but trash
    assert torch.equal(on_card[0], pool[0])
    assert torch.equal(on_card[1, 3, 6], val[0, 0])
    assert torch.equal(on_card[1, 6, 1], val[1, 2])


@pytest.mark.cuda
def test_trash_only_duplicates_leave_live_blocks_untouched(card):
    pool, bt, pos, val = _scatter_case(1)
    stacked = pool.to(card)
    before = stacked.clone()
    for _ in range(3):                 # repeated idle-lane decode writes
        layers.scatter_blocks(stacked[0], bt[2:].to(card),
                              pos[2:, :1].to(card), val[2:, :1].to(card))
    assert torch.equal(stacked[:, 1:], before[:, 1:])
    assert torch.equal(stacked[1], before[1])
    # CUDA resolves duplicates element by element: each element of the
    # trash row comes from one of the two idle lanes
    trash = stacked[0, 0, 0]
    assert bool(((trash == val[2, 0].to(card))
                 | (trash == val[3, 0].to(card))).all())


@pytest.mark.cuda
def test_paged_bits16_engine_bitwise_slot_pool_on_card(card):
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    params = dense.init(cfg, 0, card)
    sc = engine.ServeConfig(max_len=MAX_LEN)
    trace = poisson_trace(10, rate_per_s=100.0, prompt_max=32, gen_max=8,
                          vocab=cfg.vocab, seed=0, prefix_pool=2,
                          prefix_len=2 * BS)

    def run(spec=None):
        ce = ContinuousEngine(cfg, params, sc, n_slots=4, prefill_chunk=CHUNK,
                              kv_spec=spec, device=card)
        reqs, shed, _ = replay(ce, trace)
        assert shed == 0 and all(r.finish_reason == "length" for r in reqs)
        return [r.output for r in reqs], ce

    want, _ = run()
    got, ce = run(KVCompressionSpec(bits=16, block_size=BS, sharing=True))
    assert got == want
    assert ce.slots.stats()["shared_hits"] > 0
    assert ce.slots.pool["k"].device.type == card.type


@pytest.mark.cuda
def test_cold_evict_restore_round_trip_on_card(card):
    cfg = registry.reduced(registry.get("qwen3-1.7b"))
    m = BlockKVManager(cfg, 2, MAX_LEN, device=card, n_blocks=7,
                       prefill_chunk=CHUNK,
                       spec=KVCompressionSpec(bits=4, block_size=BS,
                                              codec="rans", sharing=True))
    rng = np.random.default_rng(0)

    def req(n, seed):
        prompt = np.random.default_rng(seed).integers(0, cfg.vocab, (n,))
        return Request(prompt=prompt.astype(np.int32), max_new_tokens=8)

    a = req(2 * BS, 10)
    sa, _ = m.alloc(a)
    row = m.table_rows([sa])[0]
    for j in range(2):
        for c in m.pool.values():
            shape = tuple(c[:, int(row[j])].shape)
            c[:, int(row[j])] = (
                torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
                if c.dtype == torch.uint8 else
                torch.from_numpy(rng.normal(size=shape).astype(np.float32)))
    originals = [blocks._read_block(m.pool, int(row[j])) for j in range(2)]
    m.insert(sa, 2 * BS)
    m.release(sa)
    sb, _ = m.alloc(req(5 * BS, 11))
    assert m.cold_evictions == 2
    m.insert(sb, 5 * BS)
    m.release(sb)
    sa2, skip = m.alloc(req(2 * BS, 10))
    assert m.cold_restores == 2 and skip == BS
    row2 = m.table_rows([sa2])[0]
    for j in range(2):
        got = blocks._read_block(m.pool, int(row2[j]))
        for k in got:
            np.testing.assert_array_equal(got[k], originals[j][k])
