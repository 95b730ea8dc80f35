"""The port's on-disk and in-memory stores against the JAX package's.

Raw, per-sample compressed (fixed-accuracy and fixed-rate) and sharded
stores are built by both packages from the same samples; batches must be
identical bit for bit, the accounting equal, and the sharded store's files
byte-identical, so each package opens the other's directory.
"""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from repro.data import (CompressedArrayStore as JaxCompressedStore,
                        DeviceResidentCompressedStore as JaxDeviceStore,
                        RawArrayStore as JaxRawStore,
                        ShardedCompressedStore as JaxShardedStore)
from repro.train.source import make_loader as jax_make_loader

from repro_torch.data import (CompressedArrayStore, DeviceResidentCompressedStore,
                              IoStats, RawArrayStore, ShardAwareLoader,
                              ShardedCompressedStore, ShardedLoader)
from repro_torch.data.shards import MANIFEST_NAME, atomic_write_json
from repro_torch.train.source import make_loader

torch.set_num_threads(2)

N = 19


@pytest.fixture(scope="module")
def samples():
    r = np.random.default_rng(11)
    t = np.linspace(0, 1, 22)
    xx, yy = np.meshgrid(np.linspace(0, 1, 14), t)       # ragged: 22 x 14
    return np.stack([(np.sin(6 * xx + 0.2 * i) + 0.3 * np.cos(14 * yy * xx)
                      + 0.05 * r.standard_normal((2, 22, 14)))
                     .astype(np.float32) * 2.0 ** (i % 5 - 2) for i in range(N)])


@pytest.fixture(scope="module")
def tolerances():
    r = np.random.default_rng(5)
    return (0.01 * (1 + r.random(N))).astype(np.float32)


BATCHES = (np.array([3, 0, 18, 3, 7]), np.arange(N), np.array([12]))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _assert_batches_match(store, jstore):
    for idx in BATCHES:
        assert _same_bits(store.get_batch(idx).numpy(), jstore.get_batch(idx))
    assert store.stats.batches == jstore.stats.batches == len(BATCHES)
    assert store.stats.bytes_read == jstore.stats.bytes_read
    assert store.stats.read_seconds > 0


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "disk"])
def test_raw_store_matches_jax(samples, tmp_path, on_disk):
    root = str(tmp_path / "port") if on_disk else None
    jroot = str(tmp_path / "jax") if on_disk else None
    store = RawArrayStore(samples, root=root, device="cpu")
    jstore = JaxRawStore(list(samples), root=jroot)
    assert store.stored_bytes == jstore.stored_bytes
    assert store.sample_nbytes == jstore.sample_nbytes
    _assert_batches_match(store, jstore)
    assert _same_bits(store.get_batch(np.arange(N)).numpy(), samples)
    if on_disk:
        names = sorted(os.listdir(root))
        assert names == sorted(os.listdir(jroot)) and len(names) == N
        assert all(filecmp.cmp(os.path.join(root, f), os.path.join(jroot, f),
                               shallow=False) for f in names)


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "disk"])
@pytest.mark.parametrize("mode", ["fixed_accuracy", "fixed_rate"])
def test_compressed_store_matches_jax(samples, tolerances, tmp_path, mode,
                                      on_disk):
    kw = ({"tolerances": [float(t) for t in tolerances]}
          if mode == "fixed_accuracy" else {"bits_per_value": 11})
    root = str(tmp_path / "port") if on_disk else None
    store = CompressedArrayStore(samples, root=root, device="cpu", **kw)
    jstore = JaxCompressedStore(list(samples), **kw,
                                root=str(tmp_path / "jax") if on_disk else None)
    assert store.logical_bytes == jstore.logical_bytes
    assert store.ratio == jstore.ratio and store.ratio > 1
    assert store._widths == jstore._widths
    _assert_batches_match(store, jstore)
    assert store.stats.decode_seconds > 0
    if mode == "fixed_accuracy":
        err = np.abs(store.get_batch(np.arange(N)).numpy() - samples)
        assert (err.max(axis=(1, 2, 3)) <= tolerances).all()
        assert len(set(store._widths)) > 1           # padded to the batch max
    if on_disk:
        z = np.load(os.path.join(root, "sample_000004.npz"))
        jz = np.load(str(tmp_path / "jax" / "sample_000004.npz"))
        assert all(np.array_equal(z[k], jz[k]) for k in ("payload", "emax"))
    with pytest.raises(ValueError, match="either"):
        CompressedArrayStore(samples, device="cpu")


@pytest.fixture(scope="module")
def sharded_dirs(samples, tolerances, tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    port = ShardedCompressedStore(samples, tolerances, root=str(root / "port"),
                                  shard_size=4, device="cpu")
    jax_store = JaxShardedStore(list(samples), tolerances=tolerances,
                                root=str(root / "jax"), shard_size=4)
    return port, jax_store


def test_sharded_store_files_are_byte_identical(sharded_dirs):
    port, jstore = sharded_dirs
    names = sorted(os.listdir(port.root))
    assert names == sorted(os.listdir(jstore.root))
    assert len([n for n in names if n.startswith("shard_")]) == 5
    for name in names:
        if name.startswith("shard_"):
            assert filecmp.cmp(os.path.join(port.root, name),
                               os.path.join(jstore.root, name), shallow=False)
    with open(os.path.join(port.root, MANIFEST_NAME)) as f:
        m = json.load(f)
    with open(os.path.join(jstore.root, MANIFEST_NAME)) as f:
        jm = json.load(f)
    assert m == jm and m["format"] == "repro-shards-v1"
    assert port.manifest() == jstore.manifest()
    assert port.logical_bytes == jstore.logical_bytes
    assert port.ratio == jstore.ratio


def test_each_package_opens_the_others_store(sharded_dirs, samples, tolerances):
    port, jstore = sharded_dirs
    from_jax = ShardedCompressedStore.open(jstore.root, device="cpu")
    from_port = JaxShardedStore.open(port.root)
    for idx in BATCHES + (np.array([0, 3, 4, 16, 18]),):
        want = np.asarray(jstore.get_batch(idx))
        assert _same_bits(from_jax.get_batch(idx).numpy(), want)
        assert _same_bits(port.get_batch(idx).numpy(), want)
        assert _same_bits(from_port.get_batch(idx), want)
    assert from_jax.stats.bytes_read == from_port.stats.bytes_read > 0
    assert from_jax.manifest() == jstore.manifest()
    out = from_jax.get_batch(np.arange(N)).numpy()
    assert (np.abs(out - samples).max(axis=(1, 2, 3)) <= tolerances).all()
    # same streams as the per-sample store, in a different container
    per_sample = CompressedArrayStore(
        samples, tolerances=[float(t) for t in tolerances], device="cpu")
    assert _same_bits(per_sample.get_batch(BATCHES[0]).numpy(),
                      from_jax.get_batch(BATCHES[0]).numpy())
    assert per_sample.stored_bytes == from_jax.stored_bytes


def test_in_memory_sharded_store_matches_disk(sharded_dirs, samples, tolerances):
    port, _ = sharded_dirs
    mem = ShardedCompressedStore(samples, tolerances, shard_size=4, device="cpu")
    assert mem.root is None and mem.manifest() == port.manifest()
    idx = np.arange(0, N, 3)
    assert _same_bits(mem.get_batch(idx).numpy(), port.get_batch(idx).numpy())


def test_device_resident_upload_of_sharded_store(sharded_dirs):
    port, jstore = sharded_dirs
    store = DeviceResidentCompressedStore.from_store(port, device="cpu")
    jres = JaxDeviceStore.from_store(jstore)
    assert store.shard_size == jres.shard_size == 4
    assert np.array_equal(store.nplanes.numpy(), np.asarray(jres.nplanes))
    assert np.array_equal(store.payload.numpy(), np.asarray(jres.payload))
    assert store.logical_bytes == port.logical_bytes
    for idx in BATCHES:
        got = store.decode_indices(torch.as_tensor(idx)).numpy()
        assert _same_bits(got, port.get_batch(idx).numpy())
        assert _same_bits(store.get_batch(idx).numpy(), got)
    assert store.stats.batches == len(BATCHES) and store.stats.bytes_read == 0
    assert _same_bits(port.as_device_resident(device="cpu").payload.numpy(),
                      store.payload.numpy())


def test_make_loader_is_shard_aware_as_in_jax(sharded_dirs):
    """The satellite repair: a store with a shard_size (the sharded store
    and its device-resident upload) gets the shard-aware order JAX uses."""
    port, jstore = sharded_dirs
    resident = DeviceResidentCompressedStore.from_store(port, device="cpu")
    for ours, theirs in ((port, jstore),
                         (resident, JaxDeviceStore.from_store(jstore))):
        ld = make_loader(ours, 3, seed=7)
        jld = jax_make_loader(theirs, None, 3, 7)
        assert isinstance(ld, ShardAwareLoader)
        got, want = list(ld.iter_epochs(2)), list(jld.iter_epochs(2))
        assert len(got) == len(want) == 2 * ld.steps_per_epoch > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    flat = make_loader(RawArrayStore(np.zeros((6, 4, 4)), device="cpu"), 2, 0)
    assert type(flat) is ShardedLoader


def test_io_stats_accounting(samples, tolerances):
    st = ShardedCompressedStore(samples, tolerances, shard_size=8, device="cpu")
    st.get_batch(np.arange(4))
    assert st.stats.batches == 1
    assert st.stats.bytes_read > 0
    assert st.ratio > 1.0
    assert isinstance(st.stats, IoStats)
    snap = st.stats.snapshot()
    assert snap["batches"] == 1 and snap["throughput_mbs"] > 0


def test_manifest_write_is_atomic_under_crash(samples, tolerances, tmp_path,
                                              monkeypatch):
    """A kill mid-manifest-write leaves either the old manifest or none --
    never a torn JSON document."""
    root = str(tmp_path / "store")
    ShardedCompressedStore(samples, tolerances, root=root, shard_size=8,
                           device="cpu")
    path = os.path.join(root, MANIFEST_NAME)
    before = open(path, "rb").read()

    real_dump = json.dump

    def dying_dump(obj, f, **kw):
        f.write('{"format": "torn')
        f.flush()
        raise OSError("simulated kill mid-write")

    monkeypatch.setattr(json, "dump", dying_dump)
    with pytest.raises(OSError, match="simulated kill"):
        atomic_write_json(path, {"format": "new"})
    monkeypatch.setattr(json, "dump", real_dump)
    assert open(path, "rb").read() == before
    assert ShardedCompressedStore.open(root, device="cpu").num_samples == N

    real_replace = os.replace
    monkeypatch.setattr(os, "replace",
                        lambda *a: (_ for _ in ()).throw(
                            OSError("simulated kill pre-rename")))
    with pytest.raises(OSError, match="pre-rename"):
        atomic_write_json(path, {"format": "new"})
    monkeypatch.setattr(os, "replace", real_replace)
    assert open(path, "rb").read() == before
    assert not [f for f in os.listdir(root) if f.endswith(".tmp")]


def test_stores_need_a_gpu_unless_cpu_is_asked(samples, tolerances, monkeypatch,
                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: RawArrayStore(samples),
                  lambda: CompressedArrayStore(samples, bits_per_value=8),
                  lambda: ShardedCompressedStore(samples, tolerances)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    ShardedCompressedStore(samples, tolerances, root=str(tmp_path / "s"),
                           device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedCompressedStore.open(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="unknown format"):
        ShardedCompressedStore(_manifest={"format": "nope"}, device="cpu")
