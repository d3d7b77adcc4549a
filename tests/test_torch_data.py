"""The port's data pipeline against the reference's: the token stream is
host numpy in both, so it is compared bit for bit."""
import itertools

import numpy as np
import pytest

from repro.data import pipeline as JD

from repro_torch.data import pipeline as TD


def _both(**kw):
    return (JD.ShardedSyntheticDataset(JD.DataConfig(**kw)),
            TD.ShardedSyntheticDataset(TD.DataConfig(**kw)))


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("vocab", [512, 50304])
def test_global_batches_bit_equal(seed, vocab):
    j, t = _both(vocab=vocab, seq_len=33, global_batch=8, seed=seed)
    for step in (0, 1, 7, 1000, 2 ** 31 + 5):
        _equal(t.global_batch_at(step), j.global_batch_at(step))
    b = t.global_batch_at(3)
    assert b["tokens"].shape == (8, 33) and b["tokens"].dtype == np.int32
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_host_splits_bit_equal_and_cover_the_global_batch(n_hosts):
    j, t = _both(vocab=1000, seq_len=16, global_batch=8, seed=3)
    for host in range(n_hosts):
        got = list(itertools.islice(t.iterate(5, host, n_hosts), 3))
        want = list(itertools.islice(j.iterate(5, host, n_hosts), 3))
        for a, b in zip(got, want):
            _equal(a, b)
    per = 8 // n_hosts
    shards = [next(t.iterate(5, h, n_hosts))["tokens"]
              for h in range(n_hosts)]
    assert np.array_equal(np.concatenate(shards),
                          t.global_batch_at(5)["tokens"])
    assert all(s.shape[0] == per for s in shards)


def test_modality_stubs_bit_equal():
    j, t = _both(vocab=300, seq_len=8, global_batch=4, seed=2, n_patches=3,
                 enc_frames=5, d_model=16)
    for step in (0, 4):
        _equal(t.global_batch_at(step), j.global_batch_at(step))
        _equal(t.batch_slice(step, 1, 3), j.batch_slice(step, 1, 3))


@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.2, 0.5, 0.3)])
def test_mix_datasets_draws_the_same_order(weights):
    def streams(mod):
        return [mod.ShardedSyntheticDataset(mod.DataConfig(
            vocab=100 + i, seq_len=4, global_batch=2, seed=i)).iterate()
            for i in range(len(weights))]
    got = list(itertools.islice(TD.mix_datasets(streams(TD), weights, 9), 20))
    want = list(itertools.islice(JD.mix_datasets(streams(JD), weights, 9),
                                 20))
    for a, b in zip(got, want):
        _equal(a, b)
