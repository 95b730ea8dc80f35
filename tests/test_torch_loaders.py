"""The port's shard-aware and prefetching loaders against the JAX package.

Batch order must be identical (both packages draw the shard permutation
and each shard's shuffle from one ``default_rng((seed, epoch))``), and the
``PrefetchLoader`` keeps the termination contract of tests/test_shards.py.
"""
import threading

import numpy as np
import pytest

from repro.data.loader import ShardAwareLoader as JaxShardAwareLoader
from repro.distributed.sharding import owned_shards as jax_owned_shards

from repro_torch.data import PrefetchLoader, ShardAwareLoader
from repro_torch.distributed import owned_shards


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_shard_aware_order_matches_jax(seed, hosts):
    host_id, num_hosts = hosts
    args = dict(num_samples=77, batch_size=5, samples_per_shard=6, seed=seed,
                host_id=host_id, num_hosts=num_hosts)
    a, b = ShardAwareLoader(**args), JaxShardAwareLoader(**args)
    xs, ys = list(a.iter_epochs(2)), list(b.iter_epochs(2))
    assert len(xs) == len(ys) == 2 * a.steps_per_epoch > 0
    assert all(np.array_equal(x, y) for x, y in zip(xs, ys))
    assert a.steps_per_epoch == b.steps_per_epoch and a.state() == b.state()
    # each host reads only the shards it owns
    assert set(np.concatenate(xs) // 6) <= set(owned_shards(13, host_id,
                                                            num_hosts).tolist())


def test_owned_shards_match_jax():
    for num_shards, hosts in ((10, 3), (8, 4), (5, 1), (7, 7), (3, 5)):
        for h in range(hosts):
            assert np.array_equal(owned_shards(num_shards, h, hosts),
                                  jax_owned_shards(num_shards, h, hosts))
    with pytest.raises(ValueError, match="host_id"):
        owned_shards(4, 2, 2)


def test_shard_aware_restore_mid_epoch_matches_jax():
    a = ShardAwareLoader(48, 8, 8, seed=6)
    it = iter(a)
    for _ in range(3):
        next(it)
    state = a.state()
    rest_a = [next(it) for _ in range(4)]            # crosses into epoch 1
    b, c = ShardAwareLoader(48, 8, 8, seed=0), JaxShardAwareLoader(48, 8, 8, seed=0)
    b.restore(state)
    c.restore(state)
    rest_b = [next(iter(b)) for _ in range(4)]
    rest_c = [next(iter(c)) for _ in range(4)]
    for x, y, z in zip(rest_a, rest_b, rest_c):
        assert np.array_equal(x, y) and np.array_equal(x, z)


def test_shard_aware_loader_rejects_starved_host():
    with pytest.raises(ValueError, match="owns 0 samples"):
        ShardAwareLoader(64, 8, 32, host_id=3, num_hosts=4)
    with pytest.raises(ValueError, match="owns 4 samples"):
        ShardAwareLoader(36, 8, 4, host_id=8, num_hosts=9)
    ld = ShardAwareLoader(36, 8, 4, host_id=8, num_hosts=9,
                          drop_remainder=False)
    assert ld.steps_per_epoch == 1
    with pytest.raises(ValueError, match="samples_per_shard"):
        ShardAwareLoader(36, 8, 0)


def test_prefetch_ends_cleanly_and_keeps_order():
    batches = [np.arange(i, i + 3) for i in range(0, 30, 3)]
    pf = PrefetchLoader(iter(batches), fetch=lambda idx: idx * 2, depth=2)
    got = list(pf)
    assert len(got) == len(batches)
    assert all(np.array_equal(g, b * 2) for g, b in zip(got, batches))
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_propagates_worker_exceptions():
    def fetch(idx):
        if (idx >= 30).any():
            raise ValueError("corrupt shard")
        return idx

    pf = PrefetchLoader(iter([np.arange(4), np.arange(30, 34)]), fetch=fetch)
    assert next(pf).shape[0] == 4
    with pytest.raises(ValueError, match="corrupt shard"):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetch_close_joins_a_blocked_worker():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield np.array([i])
            i += 1

    before = threading.active_count()
    with PrefetchLoader(endless(), fetch=lambda idx: idx, depth=1) as pf:
        assert next(pf)[0] == 0
        started.wait(5)
    assert not pf._thread.is_alive()
    assert threading.active_count() == before
    with pytest.raises(StopIteration):
        next(pf)
