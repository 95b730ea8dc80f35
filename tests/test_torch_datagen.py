"""The port's streaming datagen on the CPU: every case of
tests/test_datagen.py at that file's sizes, with ``device="cpu"``, and the
cases that hold the port to the JAX package:

  (a) ``config_hash()`` equal for fixed-accuracy and fixed-rate plans,
      ``use_pallas`` both ways;
  (b) a root the port produced opens in ``repro.datagen.open_produced``,
      decodes there bit for bit as the port decodes it, and gives equal
      ``scenario_conditions``;
  (c) fed the JAX solver's fields (``run_simulation`` of the produce module
      replaced), the port's ``shard_*.bin`` and ``manifest.json`` equal the
      JAX package's ``produce`` of the same plan byte for byte;
  (d) ``certify_tolerance(train_fields=<path>, conditions=None)`` reads the
      fields and conditions the JAX package's ``produced_training_arrays``
      reads.
"""
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch

import repro.datagen as jax_datagen
from repro.compression import decode_fixed_rate, encode_fixed_rate
from repro.sim.solver import run_simulation as jax_run_simulation

import repro_torch.datagen as datagen
from repro_torch.compression import CompressedField, decode_batch, encode_fixed_rate_batch
from repro_torch.data.shards import MANIFEST_NAME, ShardedCompressedStore
from repro_torch.datagen import (CodecPlan, ProductionPlan, ScenarioPlan,
                                 ShardWriter, finalize, open_produced, produce,
                                 produced_training_arrays, resolve_store,
                                 scenario_conditions)
from repro_torch.sim.ensemble import EnsembleSpec
from repro_torch.sim.solver import run_simulation

torch.set_num_threads(2)
# the module (the package's ``produce`` attribute is the function)
produce_mod = importlib.import_module("repro_torch.datagen.produce")

SPEC = EnsembleSpec(name="rt", ny=16, nx=8, nsnaps=6, nsteps=30)
PLAN = ProductionPlan(
    scenarios=(ScenarioPlan("rt", SPEC, num_sims=3, seed=7),),
    codec=CodecPlan(tolerance=1e-3), shard_size=4)
TOL = 1e-3
N, SHARDS = 18, 5                      # 3 sims x 6 snaps, shard_size 4
CPU = dict(device="cpu")


def _jax_plan(plan):
    return jax_datagen.ProductionPlan.from_dict(plan.to_dict())


def _shard_bytes(d, k):
    with open(os.path.join(d, f"shard_{k:05d}.bin"), "rb") as f:
        return f.read()


def _store_equal(a, b, shards=SHARDS):
    with open(os.path.join(a, MANIFEST_NAME), "rb") as fa, \
            open(os.path.join(b, MANIFEST_NAME), "rb") as fb:
        ma, mb = fa.read(), fb.read()
    assert json.loads(ma) == json.loads(mb)
    for k in range(shards):
        assert _shard_bytes(a, k) == _shard_bytes(b, k), f"shard {k} differs"
    return ma == mb


@pytest.fixture(scope="module")
def produced(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("produced"))
    report = produce(PLAN, root, **CPU)
    return root, report


@pytest.fixture(scope="module")
def produced16(tmp_path_factory):
    """PLAN on a 16x16 grid, for the cases that train a surrogate at a
    width where its dense layer has outputs (below 16 it has none, in both
    packages, and the output then ignores the conditions)."""
    root = str(tmp_path_factory.mktemp("produced16"))
    spec = dataclasses.replace(SPEC, nx=16)
    plan = dataclasses.replace(PLAN, scenarios=(
        ScenarioPlan("rt", spec, num_sims=3, seed=7),))
    assert produce(plan, root, **CPU).finalized
    return root


@pytest.fixture(scope="module")
def ref_fields():
    return [run_simulation(p, ny=SPEC.ny, nx=SPEC.nx, nsteps=SPEC.nsteps,
                           nsnaps=SPEC.nsnaps, **CPU).numpy()
            for p in PLAN.scenarios[0].params()]


@pytest.fixture(scope="module")
def ref_store_dir(ref_fields, tmp_path_factory):
    samples = np.concatenate([np.moveaxis(f, -1, 1) for f in ref_fields])
    root = str(tmp_path_factory.mktemp("refstore"))
    ShardedCompressedStore(list(samples), tolerances=[TOL] * len(samples),
                           root=root, shard_size=PLAN.shard_size, **CPU)
    return root


# ---------------------------------------------------------------------------
# plan schema
# ---------------------------------------------------------------------------

def test_plan_roundtrip_and_hash():
    again = ProductionPlan.from_dict(PLAN.to_dict())
    assert again == PLAN
    assert again.config_hash() == PLAN.config_hash()
    other = dataclasses.replace(PLAN, shard_size=8)
    assert other.config_hash() != PLAN.config_hash()


@pytest.mark.parametrize("bad", [
    lambda: ProductionPlan(scenarios=()),
    lambda: ProductionPlan(scenarios=(
        ScenarioPlan("a/b", SPEC, num_sims=1),)),
    lambda: ProductionPlan(scenarios=(
        ScenarioPlan("a", SPEC, num_sims=0),)),
    lambda: ProductionPlan(scenarios=(ScenarioPlan("a", SPEC, num_sims=1),),
                           codec=CodecPlan(mode="nope")),
    lambda: ProductionPlan(scenarios=(ScenarioPlan("a", SPEC, num_sims=1),),
                           codec=CodecPlan(tolerance=0.0)),
    lambda: ProductionPlan(scenarios=(ScenarioPlan("a", SPEC, num_sims=1),
                                      ScenarioPlan("a", SPEC, num_sims=1))),
])
def test_plan_validation(bad):
    with pytest.raises((ValueError, KeyError)):
        bad().validate()


@pytest.mark.parametrize("codec", [
    CodecPlan(tolerance=1e-3), CodecPlan(tolerance=2.5e-2, use_pallas=True),
    CodecPlan(mode="fixed_rate", bits_per_value=9),
    CodecPlan(mode="fixed_rate", bits_per_value=9, use_pallas=True),
], ids=["fa", "fa-pallas", "fr", "fr-pallas"])
def test_config_hash_equals_jax(codec):
    """(a) The same plan hashes the same in both packages, and a JAX
    plan's JSON reads back into the port."""
    plan = ProductionPlan(
        scenarios=(ScenarioPlan("rt", SPEC, num_sims=3, seed=7),
                   ScenarioPlan("pchip", EnsembleSpec(name="pchip", ny=16, nx=16,
                                                      pchip=True, nsteps=40),
                                num_sims=2, seed=1)),
        codec=codec, shard_size=4)
    jplan = _jax_plan(plan)
    assert plan.config_hash() == jplan.config_hash()
    assert ProductionPlan.from_dict(json.loads(json.dumps(jplan.to_dict()))) \
        .config_hash() == jplan.config_hash()


# ---------------------------------------------------------------------------
# streaming == in-memory, bit for bit
# ---------------------------------------------------------------------------

def test_produced_report(produced):
    _, report = produced
    r = report.scenario("rt")
    assert r.finalized and not r.preempted
    assert r.sims_run == 3 and r.shards_written == SHARDS
    assert r.samples_produced == N


def test_bit_identical_to_in_memory_build(produced, ref_store_dir):
    root, _ = produced
    _store_equal(os.path.join(root, "rt"), ref_store_dir)


def test_sequential_produce_identical(tmp_path, produced):
    """overlap=False runs the same ingest inline -> identical bytes."""
    root, _ = produced
    seq = str(tmp_path / "seq")
    assert produce(PLAN, seq, overlap=False, **CPU).finalized
    _store_equal(os.path.join(seq, "rt"), os.path.join(root, "rt"))


def test_open_and_decode_error_bound(produced, ref_fields):
    root, _ = produced
    store = resolve_store(root, **CPU)
    assert store.num_samples == N and store.shape == (6, 16, 8)
    batch = np.moveaxis(store.get_batch(np.arange(6)).numpy(), 1, -1)
    assert np.max(np.abs(batch - ref_fields[0])) <= TOL * (1 + 1e-5)


# ---------------------------------------------------------------------------
# kill + resume
# ---------------------------------------------------------------------------

def test_kill_and_resume_bit_identical(tmp_path, produced):
    root, _ = produced
    rdir = str(tmp_path / "resume")
    first = produce(PLAN, rdir, max_shards=2, **CPU).scenario("rt")
    assert first.preempted and not first.finalized
    assert first.shards_written == 2
    assert not os.path.exists(os.path.join(rdir, "rt", MANIFEST_NAME))
    mtimes = {k: os.stat(os.path.join(rdir, "rt", f"shard_{k:05d}.bin"))
              .st_mtime_ns for k in range(2)}

    second = produce(PLAN, rdir, **CPU).scenario("rt")
    assert second.finalized
    assert second.shards_written == SHARDS - 2       # only unfinished shards
    assert second.sims_run == 2                       # sims 1,2 overlap them
    for k, m in mtimes.items():                       # finished: untouched
        assert os.stat(os.path.join(rdir, "rt",
                                    f"shard_{k:05d}.bin")).st_mtime_ns == m
    _store_equal(os.path.join(rdir, "rt"), os.path.join(root, "rt"))

    third = produce(PLAN, rdir, **CPU).scenario("rt")  # fully done: no-op
    assert third.finalized and third.sims_run == 0
    assert third.shards_written == 0


def test_resume_refuses_different_plan(tmp_path):
    rdir = str(tmp_path / "mixed")
    produce(PLAN, rdir, max_shards=1, **CPU)
    other = ProductionPlan(
        scenarios=(ScenarioPlan("rt", SPEC, num_sims=3, seed=8),),
        codec=CodecPlan(tolerance=TOL), shard_size=4)
    with pytest.raises(ValueError, match="refusing"):
        produce(other, rdir, **CPU)


def test_crash_during_finalize_manifest(tmp_path, monkeypatch, produced):
    """A kill mid-manifest-write leaves no torn manifest; re-running
    produce() finalizes with zero recomputation."""
    root, _ = produced
    rdir = str(tmp_path / "crash")
    real_replace = os.replace

    def dying_replace(src, dst):
        if dst.endswith(MANIFEST_NAME):
            raise OSError("simulated kill mid-finalize")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError, match="simulated kill"):
        produce(PLAN, rdir, **CPU)
    monkeypatch.undo()

    sdir = os.path.join(rdir, "rt")
    assert not os.path.exists(os.path.join(sdir, MANIFEST_NAME))
    rep = produce(PLAN, rdir, **CPU).scenario("rt")   # all shards committed:
    assert rep.finalized and rep.sims_run == 0        # finalize only
    _store_equal(sdir, os.path.join(root, "rt"))


# ---------------------------------------------------------------------------
# multi-host partition
# ---------------------------------------------------------------------------

def test_multi_host_partition(tmp_path, produced):
    root, _ = produced
    mdir = str(tmp_path / "hosts")
    r0 = produce(PLAN, mdir, host_id=0, num_hosts=2, **CPU).scenario("rt")
    assert not r0.finalized                           # host 1 still missing
    r1 = produce(PLAN, mdir, host_id=1, num_hosts=2, **CPU).scenario("rt")
    assert r1.finalized
    assert r0.shards_written + r1.shards_written == SHARDS
    assert finalize(PLAN, mdir)                       # idempotent
    _store_equal(os.path.join(mdir, "rt"), os.path.join(root, "rt"))


# ---------------------------------------------------------------------------
# fixed-rate codec path
# ---------------------------------------------------------------------------

def test_fixed_rate_production(tmp_path, ref_fields):
    plan = ProductionPlan(
        scenarios=(ScenarioPlan("rt", SPEC, num_sims=2, seed=7),),
        codec=CodecPlan(mode="fixed_rate", bits_per_value=9, use_pallas=True),
        shard_size=4)
    rdir = str(tmp_path / "fr")
    assert produce(plan, rdir, **CPU).finalized
    store = resolve_store(rdir, **CPU)
    got = store.get_batch(np.array([0]))[0]
    x = np.moveaxis(ref_fields[0], -1, 1)[:1]
    want = decode_batch(encode_fixed_rate_batch(torch.from_numpy(x), 9))[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    jax_want = np.asarray(decode_fixed_rate(encode_fixed_rate(x[0], 9)))
    assert np.array_equal(got.numpy().view(np.int32), jax_want.view(np.int32))


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------

def test_conditions_from_provenance(produced):
    root, _ = produced
    cond = scenario_conditions(os.path.join(root, "rt"))
    assert cond.shape == (N, 7)
    # time channel cycles 0..1 per sim
    assert cond[0, -1] == 0.0 and cond[5, -1] == 1.0 and cond[6, -1] == 0.0


def test_produced_training_arrays(produced, ref_fields):
    root, _ = produced
    cond, fields = produced_training_arrays(root, **CPU)
    assert cond.shape == (N, 7) and fields.shape == (N, 16, 8, 6)
    assert np.max(np.abs(fields[:6] - ref_fields[0])) <= TOL * (1 + 1e-5)


def test_open_produced_handle(produced):
    root, _ = produced
    ds = open_produced(root)
    assert ds.names == ["rt"]
    assert ds.store("rt", **CPU).num_samples == N
    prov = ds.provenance("rt")
    assert prov["plan_hash"] == PLAN.config_hash()
    assert len(prov["sims"]) == 3
    assert prov["plan"]["codec"]["tolerance"] == TOL


def test_train_on_produced_path(produced16):
    from repro_torch.data.store import channels_last
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.train.loop import TrainConfig, train_surrogate
    root = produced16
    cond = scenario_conditions(os.path.join(root, "rt"))
    cfg = SurrogateConfig(height=16, width=16, base_channels=8)
    tc = TrainConfig(epochs=1, batch_size=4, lr=1e-3, log_every=1)
    _, losses = train_surrogate(cfg, tc, cond, os.path.join(root, "rt"),
                                target_transform=channels_last, **CPU)
    assert len(losses) == 4 and np.isfinite([l for _, l in losses]).all()


def test_train_on_produced_path_at_jax_width(produced):
    """The JAX package's own scenario: the 16x8 produced path, a width-8
    surrogate (zero-width dense layer, stages 0 -> 1 -> 2 -> 4 -> 8)."""
    from repro_torch.data.store import channels_last
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.train.loop import TrainConfig, train_surrogate
    root, _ = produced
    cond = scenario_conditions(os.path.join(root, "rt"))
    cfg = SurrogateConfig(height=16, width=8, base_channels=8)
    tc = TrainConfig(epochs=1, batch_size=4, lr=1e-3, log_every=1)
    _, losses = train_surrogate(cfg, tc, cond, os.path.join(root, "rt"),
                                target_transform=channels_last, **CPU)
    assert len(losses) == 4 and np.isfinite([l for _, l in losses]).all()


def test_resolve_store_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="no produced dataset"):
        resolve_store(str(tmp_path), **CPU)
    produce(PLAN, str(tmp_path / "part"), max_shards=1, **CPU)
    with pytest.raises(FileNotFoundError, match="unfinished"):
        resolve_store(str(tmp_path / "part"), **CPU)


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def test_port_root_opens_in_jax(produced):
    """(b) The JAX package opens the port's root, decodes each sample as
    the port does, and rebuilds the same conditions."""
    root, _ = produced
    jds = jax_datagen.open_produced(root)
    assert jds.names == ["rt"]
    idx = np.arange(N)
    got = resolve_store(root, **CPU).get_batch(idx).numpy()
    want = np.asarray(jds.store("rt").get_batch(idx))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(scenario_conditions(os.path.join(root, "rt")),
                          jax_datagen.scenario_conditions(os.path.join(root, "rt")))
    jcond, jfields = jax_datagen.produced_training_arrays(root)
    cond, fields = produced_training_arrays(root, **CPU)
    assert np.array_equal(cond, jcond)
    assert np.array_equal(fields.view(np.int32), jfields.view(np.int32))


def _jax_fields(params, ny, nx, nsteps, nsnaps, device):
    return torch.from_numpy(np.array(jax_run_simulation(
        params, ny=ny, nx=nx, nsteps=nsteps, nsnaps=nsnaps))).to(device)


@pytest.mark.parametrize("codec", [CodecPlan(tolerance=1e-3),
                                   CodecPlan(mode="fixed_rate", bits_per_value=9)],
                         ids=["fixed_accuracy", "fixed_rate"])
def test_same_fields_same_bytes_as_jax(tmp_path, monkeypatch, codec):
    """(c) Fed the JAX solver's fields, the port writes the JAX package's
    shard and manifest bytes; a JAX root opens in the port."""
    plan = dataclasses.replace(PLAN, codec=codec)
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_datagen.produce(_jax_plan(plan), jroot).finalized
    monkeypatch.setattr(produce_mod, "run_simulation", _jax_fields)
    assert produce(plan, proot, **CPU).finalized
    assert _store_equal(os.path.join(proot, "rt"), os.path.join(jroot, "rt"))
    jprov = datagen.load_provenance(os.path.join(jroot, "rt"))
    assert ProductionPlan.from_dict(jprov["plan"]).config_hash() == jprov["plan_hash"]
    assert jprov["sims"] == datagen.load_provenance(os.path.join(proot, "rt"))["sims"]
    got = resolve_store(jroot, **CPU).get_batch(np.arange(N)).numpy()
    want = np.asarray(jax_datagen.resolve_store(jroot).get_batch(np.arange(N)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_certify_reads_produced_path_as_jax(produced16, monkeypatch):
    """(d) certify_tolerance(train_fields=<path>, conditions=None) trains on
    the fields and conditions JAX's produced_training_arrays reads."""
    from repro_torch.core.ensemble import certify_tolerance
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.train.loop import TrainConfig
    root = produced16
    seen = []
    real = datagen.produced_training_arrays

    def recording(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(datagen, "produced_training_arrays", recording)
    jcond, jfields = jax_datagen.produced_training_arrays(root)
    res = certify_tolerance(
        SurrogateConfig(height=16, width=16, base_channels=8),
        TrainConfig(epochs=1, batch_size=4, lr=1e-3, log_every=10), None, root,
        eval_conditions=jcond[:6], eval_targets=jfields[:6], seeds=(0, 1),
        multiples=(1.0,), shard_size=4, **CPU)
    assert len(seen) == 1
    cond, fields = seen[0]
    assert np.array_equal(cond, jcond)
    assert np.array_equal(fields.view(np.int32), jfields.view(np.int32))
    assert res.base_tolerances.shape == (N,)
    assert [c.multiple for c in res.candidates] == [1.0]


# ---------------------------------------------------------------------------
# writer contract
# ---------------------------------------------------------------------------

def _fake_cf(n, nb=4, w=2):
    """Minimal batched CompressedField-shaped records for writer tests."""
    return CompressedField(
        payload=torch.ones((n, nb, w), dtype=torch.int32),
        emax=torch.zeros((n, nb), dtype=torch.int32),
        nplanes=torch.full((n, nb), 2 * w, dtype=torch.int32),
        shape=(4, 4), padded_shape=(4, 4))


def test_writer_incomplete_coverage_fails(tmp_path):
    w = ShardWriter(str(tmp_path), shard_size=4, num_samples=8,
                    target_shards=[0, 1])
    w.put(0, _fake_cf(6))                 # shard 1 never completes
    with pytest.raises(RuntimeError, match="incomplete shards \\[1\\]"):
        w.close()


def test_writer_drops_non_target_samples(tmp_path):
    done = []
    w = ShardWriter(str(tmp_path), shard_size=4, num_samples=8,
                    target_shards=[1], on_shard=lambda k, m: done.append(k))
    w.put(0, _fake_cf(8))
    w.close()
    assert done == [1]
    assert not os.path.exists(str(tmp_path / "shard_00000.bin"))
    assert os.path.exists(str(tmp_path / "shard_00001.bin"))


def test_writer_worker_error_is_sticky_and_joins(tmp_path):
    """A worker failure re-raises the ORIGINAL error (not an
    incomplete-shards report) and never leaks the worker thread."""
    def bad_cb(k, meta):
        raise ValueError("disk exploded")

    w = ShardWriter(str(tmp_path), shard_size=4, num_samples=8,
                    target_shards=[0, 1], on_shard=bad_cb)
    w.put(0, _fake_cf(8))
    with pytest.raises(ValueError, match="disk exploded"):
        w.close()
    w._thread.join(timeout=10)
    assert not w._thread.is_alive()
    w.abort()                                         # idempotent, no raise


def test_writer_abort_joins_worker(tmp_path):
    w = ShardWriter(str(tmp_path), shard_size=4, num_samples=8,
                    target_shards=[0, 1])
    w.put(0, _fake_cf(3))                             # incomplete on purpose
    w.abort()
    w._thread.join(timeout=10)
    assert not w._thread.is_alive()
    w.abort()


def test_config_hash_ignores_unused_codec_fields():
    """Settings the selected codec mode never reads cannot rename the
    dataset (and so cannot spuriously refuse a resume)."""
    a = dataclasses.replace(PLAN, codec=CodecPlan(tolerance=1e-3))
    b = dataclasses.replace(PLAN, codec=CodecPlan(tolerance=1e-3,
                                                  use_pallas=True,
                                                  bits_per_value=5))
    assert a.config_hash() == b.config_hash()
    fr = dataclasses.replace(PLAN, codec=CodecPlan(mode="fixed_rate",
                                                   bits_per_value=9))
    assert fr.config_hash() != a.config_hash()
