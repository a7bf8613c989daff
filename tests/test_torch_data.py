"""The port's numpy copy of the synthetic data pipeline
(``repro_torch.data``) against ``repro.data``: the same ``(cfg, step,
shard)`` gives the same arrays, bit for bit, and the cases of
``tests/test_data.py`` hold for the copy."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import data as jax_data  # noqa: E402
from repro_torch import data  # noqa: E402


@pytest.mark.parametrize("kw,step,shard,n_shards", [
    (dict(vocab=1000, seq_len=64, global_batch=8), 3, 0, 2),
    (dict(vocab=151_936, seq_len=128, global_batch=8, seed=7), 0, 0, 1),
    (dict(vocab=512, seq_len=33, global_batch=6, seed=2, eos_id=3, mean_doc_len=8), 11, 2, 3),
])
def test_host_batch_bit_equal(kw, step, shard, n_shards):
    got = data.host_batch(data.DataConfig(**kw), step, shard, n_shards)
    want = jax_data.host_batch(jax_data.DataConfig(**kw), step, shard, n_shards)
    assert sorted(got) == sorted(want) == ["mask", "targets", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    assert dataclasses.asdict(data.DataConfig(**kw)) == dataclasses.asdict(
        jax_data.DataConfig(**kw))


def test_iterate_and_restart_match():
    cfg = data.DataConfig(vocab=500, seq_len=16, global_batch=2)
    jcfg = jax_data.DataConfig(vocab=500, seq_len=16, global_batch=2)
    it, jit = data.iterate(cfg, start_step=3), jax_data.iterate(jcfg, start_step=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], next(jit)["tokens"])
    seq = [b["tokens"] for b, _ in zip(data.iterate(cfg), range(5))]
    np.testing.assert_array_equal(next(data.iterate(cfg, start_step=3))["tokens"], seq[3])


def test_cases_of_the_reference():
    cfg = data.DataConfig(vocab=1000, seq_len=64, global_batch=8)
    a = data.host_batch(cfg, step=0, shard=0, n_shards=2)
    b = data.host_batch(cfg, step=0, shard=1, n_shards=2)
    assert a["tokens"].shape == (4, 64) and not np.array_equal(a["tokens"], b["tokens"])
    d = data.host_batch(data.DataConfig(vocab=100, seq_len=128, global_batch=4), 0, 0, 1)
    np.testing.assert_array_equal(d["tokens"][:, 1:], d["targets"][:, :-1])
    assert d["tokens"].min() >= 1 and d["tokens"].max() < 100
    with pytest.raises(ValueError, match="does not split"):
        data.host_batch(cfg, 0, 0, 3)
