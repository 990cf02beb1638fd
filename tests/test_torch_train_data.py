"""The port's token pipeline (``data/pipeline.py``, numpy only) against the
JAX package's: every batch bitwise, for the synthetic Markov source (with
and without the encdec source frames, sharded) and the memmapped file
source, including restart from a step."""
import numpy as np
import pytest

from repro.data import pipeline as jdata
from repro_torch.data import pipeline as tdata

CONFIGS = [dict(vocab=512, seq_len=64, global_batch=8),
           dict(vocab=151936, seq_len=17, global_batch=4, seed=3),
           dict(vocab=512, seq_len=9, global_batch=4, src_embed_dim=16,
                src_len=5),
           dict(vocab=1000, seq_len=12, global_batch=8, shard=1,
                num_shards=2)]


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("kw", CONFIGS, ids=["smoke", "qwen3-vocab",
                                             "encdec", "shard"])
def test_synthetic_batches_bitwise(kw):
    j = jdata.SyntheticSource(jdata.DataConfig(**kw))
    t = tdata.SyntheticSource(tdata.DataConfig(**kw))
    np.testing.assert_array_equal(j.succ, t.succ)
    for step, (a, b) in enumerate(zip(iter(j), iter(t))):
        _equal(a, b)
        _equal(b, t.batch(step))
        if step == 3:
            break
    _equal(next(j.iter_from(11)), next(t.iter_from(11)))
    assert t.local_batch == kw["global_batch"] // kw.get("num_shards", 1)


def test_file_source_batches_bitwise(tmp_path):
    path = str(tmp_path / "tokens.u32")
    np.random.default_rng(0).integers(0, 2 ** 32, 5000, dtype=np.uint64
                                      ).astype(np.uint32).tofile(path)
    kw = dict(vocab=700, seq_len=32, global_batch=4, seed=2)
    j = jdata.FileSource(jdata.DataConfig(**kw), path)
    t = tdata.FileSource(tdata.DataConfig(**kw), path)
    assert j.windows == t.windows == (5000 - 1) // 32
    for a, b, _ in zip(iter(j), iter(t), range(3)):
        _equal(a, b)
        assert int(b["tokens"].max()) < 700
    _equal(next(j.iter_from(9)), next(t.iter_from(9)))
