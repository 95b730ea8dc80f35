"""Exact resume in the port, and resume across the two packages, on the CPU.

Every case of ``tests/test_resume.py`` on the port, for the raw and sharded
host-streaming stores and for the device-resident store (the main path): a
run killed at step 5 and resumed from its step-4 checkpoint ends with
parameters bit-identical to an uninterrupted run, and its loss history
equals the fresh run's post-resume entries bit for bit; prefetch and
synchronous fetch give the same run; the manifest records the loader state.

Across packages: a JAX run preempted at step 5 and resumed by the port (and
the reverse) continues from the same loader position, with post-resume
losses within ``tests/test_torch_train.py``'s trajectory tolerance of the
other package's fresh run (the two runtimes' convolutions round
differently, so bits are not compared there).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.data import DeviceResidentCompressedStore as JaxStore
from repro.data import channels_last as jax_channels_last
from repro.models.surrogate import SurrogateConfig as JaxConfig, init_surrogate as jax_init
from repro.train import checkpoint as jckpt
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import train_surrogate as jax_train_surrogate

from repro_torch.data import (DeviceResidentCompressedStore, RawArrayStore,
                              ShardedCompressedStore, channels_last)
from repro_torch.models.surrogate import SurrogateConfig, params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, train_surrogate

torch.set_num_threads(2)

CFG = SurrogateConfig(height=48, width=16, base_channels=8)
LOSS_RTOL = 1e-5          # tests/test_torch_train.py's per-step trajectory tolerance


def _mkdata(n=48):
    rng = np.random.default_rng(0)
    fields = rng.standard_normal((n, 48, 16, 6)).astype(np.float32)
    cond = rng.standard_normal((n, CFG.cond_dim)).astype(np.float32)
    return cond, fields


def _mkstore(kind, fields):
    if kind == "raw":
        return RawArrayStore(fields, device="cpu"), None
    samples = np.ascontiguousarray(np.transpose(fields, (0, 3, 1, 2)))
    tols = np.full(len(fields), 0.1, np.float32)
    if kind == "sharded":
        return ShardedCompressedStore(samples, tols, shard_size=16,
                                      device="cpu"), channels_last
    return DeviceResidentCompressedStore.from_samples(samples, tols,
                                                      device="cpu"), channels_last


def _assert_models_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("kind", ["raw", "sharded", "device"])
def test_kill_and_resume_bit_identical(tmp_path, kind):
    """48 samples, bs=16 -> 3 steps/epoch, 3 epochs = 9 steps.  Kill at
    step 5 (mid-epoch 1); the last checkpoint is step 4 (also mid-epoch),
    so the resumed run must replay step 5 with the fresh run's batch."""
    cond, fields = _mkdata()
    store, transform = _mkstore(kind, fields)
    base = dict(epochs=3, batch_size=16, lr=1e-3, seed=7, log_every=1)

    ref_model, ref_losses = train_surrogate(CFG, TrainConfig(**base), cond, store,
                                            target_transform=transform, device="cpu")
    assert [s for s, _ in ref_losses] == list(range(1, 10))

    cdir = str(tmp_path / kind)
    tck = TrainConfig(**base, ckpt_dir=cdir, ckpt_every_steps=2)
    _, killed = train_surrogate(CFG, dataclasses.replace(tck, max_steps=5), cond, store,
                                target_transform=transform, device="cpu")
    assert [s for s, _ in killed] == list(range(1, 6))
    latest = ckpt.latest_checkpoint(cdir)
    assert latest is not None and latest.endswith("step_0000000004")

    res_model, res_losses = train_surrogate(CFG, tck, cond, store,
                                            target_transform=transform, device="cpu")
    _assert_models_equal(ref_model, res_model)
    assert res_losses == [(s, l) for s, l in ref_losses if s > 4]
    # the finished run saved its last step; a call at max_steps returns at once
    assert ckpt.latest_checkpoint(cdir).endswith("step_0000000009")
    model, losses = train_surrogate(CFG, dataclasses.replace(tck, max_steps=9), cond,
                                    store, target_transform=transform, device="cpu")
    assert losses == []
    _assert_models_equal(ref_model, model)


def test_prefetch_and_sync_paths_bit_identical():
    cond, fields = _mkdata(32)
    base = dict(epochs=2, batch_size=16, lr=1e-3, seed=3, log_every=1)
    m_sync, l_sync = train_surrogate(CFG, TrainConfig(**base, prefetch=0), cond,
                                     RawArrayStore(fields, device="cpu"), device="cpu")
    m_pre, l_pre = train_surrogate(CFG, TrainConfig(**base, prefetch=3), cond,
                                   RawArrayStore(fields, device="cpu"), device="cpu")
    assert l_sync == l_pre and len(l_sync) == 4
    _assert_models_equal(m_sync, m_pre)


def test_prefetch_resume_bit_identical(tmp_path):
    """With a prefetch worker the live loader runs ahead of the step; the
    checkpoint must still record the position of the last consumed batch."""
    cond, fields = _mkdata(48)
    store = RawArrayStore(fields, device="cpu")
    base = dict(epochs=3, batch_size=16, lr=1e-3, seed=5, log_every=1, prefetch=3)
    ref_model, ref_losses = train_surrogate(CFG, TrainConfig(**base), cond, store,
                                            device="cpu")
    tck = TrainConfig(**base, ckpt_dir=str(tmp_path), ckpt_every_steps=2)
    train_surrogate(CFG, dataclasses.replace(tck, max_steps=5), cond, store,
                    device="cpu")
    res_model, res_losses = train_surrogate(CFG, tck, cond, store, device="cpu")
    _assert_models_equal(ref_model, res_model)
    assert res_losses == [(s, l) for s, l in ref_losses if s > 4]


def test_manifest_records_loader_state(tmp_path):
    cond, fields = _mkdata(32)
    cdir = str(tmp_path / "ck")
    tc = TrainConfig(epochs=1, batch_size=16, lr=1e-3, seed=11,
                     ckpt_dir=cdir, ckpt_every_steps=1, log_every=1)
    train_surrogate(CFG, tc, cond, RawArrayStore(fields, device="cpu"), device="cpu")
    latest = ckpt.latest_checkpoint(cdir)
    with open(os.path.join(latest, "manifest.json")) as f:
        meta = json.load(f)
    lstate = meta["extra"]["loader"]
    assert lstate["seed"] == 11
    assert {"epoch", "step_in_epoch", "seed"} <= set(lstate)
    assert (lstate["epoch"], lstate["step_in_epoch"]) in {(0, 2), (1, 0)}
    assert meta["step"] == 2


def test_pre_loader_manifest_resumes_at_epoch_start(tmp_path):
    """A manifest without ``extra["loader"]`` (written before the loader
    state was recorded) resumes at the start of its recorded epoch."""
    cond, fields = _mkdata(32)
    store = RawArrayStore(fields, device="cpu")
    cdir = str(tmp_path / "old")
    tc = TrainConfig(epochs=3, batch_size=16, lr=1e-3, seed=2, log_every=1,
                     ckpt_dir=cdir, ckpt_every_steps=2)
    train_surrogate(CFG, dataclasses.replace(tc, max_steps=2), cond, store, device="cpu")
    latest = ckpt.latest_checkpoint(cdir)
    mpath = os.path.join(latest, "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    del meta["extra"]["loader"]
    meta["extra"]["epoch"] = 1
    with open(mpath, "w") as f:
        json.dump(meta, f)
    _, losses = train_surrogate(CFG, tc, cond, store, device="cpu")
    assert [s for s, _ in losses] == [3, 4, 5, 6]


# ---------------------------------------------------------------------------
# across packages (device-resident stores, the main path)
# ---------------------------------------------------------------------------

XCFG = dict(height=16, width=16, base_channels=8)
XBASE = dict(epochs=3, batch_size=8, lr=1e-3, seed=4, log_every=1)


def _xdata():
    rng = np.random.default_rng(1)
    n = 24
    samples = (0.5 * rng.standard_normal((n, 6, 16, 16))).astype(np.float32)
    cond = rng.standard_normal((n, SurrogateConfig(**XCFG).cond_dim)).astype(np.float32)
    tols = np.full(n, 1e-3, np.float32)
    return cond, samples, tols


def _jax_fresh(cond, samples, tols):
    jcfg = JaxConfig(**XCFG)
    jparams = jax_init(jax.random.PRNGKey(0), jcfg)
    store = JaxStore.from_samples(list(samples), tols)
    return jcfg, jparams, store, jax_train_surrogate(
        jcfg, JaxTrainConfig(**XBASE), cond, store, params=jparams,
        target_transform=jax_channels_last)


def _loader_state(cdir):
    with open(os.path.join(ckpt.latest_checkpoint(cdir), "manifest.json")) as f:
        return json.load(f)["extra"]["loader"]


def test_jax_checkpoint_resumed_by_the_port(tmp_path):
    cond, samples, tols = _xdata()
    jcfg, jparams, jstore, (_, jl) = _jax_fresh(cond, samples, tols)
    assert [s for s, _ in jl] == list(range(1, 10))
    cdir = str(tmp_path / "ck")
    jax_train_surrogate(jcfg, JaxTrainConfig(**XBASE, ckpt_dir=cdir, ckpt_every_steps=2,
                                             max_steps=5),
                        cond, jstore, params=jparams, target_transform=jax_channels_last)
    assert jckpt.latest_checkpoint(cdir).endswith("step_0000000004")
    before = _loader_state(cdir)

    store = DeviceResidentCompressedStore.from_samples(samples, tols, device="cpu")
    steps_seen = []
    _, losses = train_surrogate(
        SurrogateConfig(**XCFG), TrainConfig(**XBASE, ckpt_dir=cdir, ckpt_every_steps=2),
        cond, store, hooks=[lambda s, m, l: steps_seen.append(s)],
        target_transform=channels_last, device="cpu")
    assert before == {"epoch": 1, "step_in_epoch": 1, "seed": XBASE["seed"]}
    assert steps_seen == list(range(5, 10))
    want = [(s, l) for s, l in jl if s > 4]
    assert [s for s, _ in losses] == [s for s, _ in want]
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in want],
                               rtol=LOSS_RTOL, atol=0)
    # the port's final save is read back by the JAX package
    assert jckpt.latest_checkpoint(cdir).endswith("step_0000000009")


def test_port_checkpoint_resumed_by_jax(tmp_path):
    cond, samples, tols = _xdata()
    jcfg, jparams, jstore, (_, jl) = _jax_fresh(cond, samples, tols)
    cdir = str(tmp_path / "ck")
    store = DeviceResidentCompressedStore.from_samples(samples, tols, device="cpu")
    train_surrogate(SurrogateConfig(**XCFG),
                    TrainConfig(**XBASE, ckpt_dir=cdir, ckpt_every_steps=2, max_steps=5),
                    cond, store, params=params_from_jax(jax.tree.map(np.asarray, jparams)),
                    target_transform=channels_last, device="cpu")
    assert ckpt.latest_checkpoint(cdir).endswith("step_0000000004")
    assert _loader_state(cdir) == {"epoch": 1, "step_in_epoch": 1, "seed": XBASE["seed"]}

    _, losses = jax_train_surrogate(
        jcfg, JaxTrainConfig(**XBASE, ckpt_dir=cdir, ckpt_every_steps=2), cond, jstore,
        params=jparams, target_transform=jax_channels_last)
    want = [(s, l) for s, l in jl if s > 4]
    assert [s for s, _ in losses] == [s for s, _ in want]
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in want],
                               rtol=LOSS_RTOL, atol=0)
