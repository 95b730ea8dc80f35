"""The port's seed ensemble and certification against its own sequential
runs and against the JAX package, on the CPU.

The JAX test's tiny configuration (16x16 grid, ``base_channels=16``, 32
samples, seeds 0, 1, 2).  The port's ensemble (stacked parameters, one
member-folded step for all members) is held to N ``train_surrogate`` runs with
the criteria of tests/test_ensemble.py ``_assert_equivalent``, on raw,
sharded, device-resident and per-member stores; and, with the JAX
members' initial parameters carried over (``params_from_jax``), to JAX's
``train_ensemble``: the first step's losses to tests/test_torch_train.py's
``LOSS_RTOL``, then the same ``_assert_equivalent`` criteria.  A band
written by either package loads in the other, and ``certify_tolerance``
meets tests/test_ensemble.py's assertions with Algorithm-1 tolerances
equal to JAX's at the same model error.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import find_tolerance_batch as jax_find_tolerance_batch
from repro.core.ensemble import (BandArtifact as JaxBandArtifact,
                                 init_ensemble as jax_init_ensemble,
                                 train_ensemble as jax_train_ensemble)
from repro.data import RawArrayStore as JaxRawStore
from repro.data.loader import (EnsembleLoader as JaxEnsembleLoader,
                               ShardAwareLoader as JaxShardAwareLoader,
                               ShardedLoader as JaxShardedLoader)
from repro.models.surrogate import SurrogateConfig as JaxConfig
from repro.train.loop import TrainConfig as JaxTrainConfig

from repro_torch.compression import get_codec
from repro_torch.core.ensemble import (BandArtifact, CertificationResult,
                                       certify_tolerance, ensemble_train_step,
                                       init_ensemble, train_ensemble)
from repro_torch.data import (DeviceResidentCompressedStore, EnsembleLoader,
                              RawArrayStore, ShardAwareLoader, ShardedCompressedStore,
                              ShardedLoader, channels_last)
from repro_torch.kernels import ops
from repro_torch.models.surrogate import (SurrogateConfig, init_surrogate,
                                          params_from_jax, stack_params)
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.synthetic import synthetic_study
from repro_torch.train.loop import TrainConfig, train_surrogate
from repro_torch.train.optimizer import AdamConfig, adam_init

torch.set_num_threads(2)

CFG = SurrogateConfig(height=16, width=16, base_channels=16)
SEEDS = (0, 1, 2)
TC = TrainConfig(epochs=2, batch_size=8, lr=1e-3, log_every=1)
# against JAX: the first step's losses (the same parameters and batch) to
# tests/test_torch_train.py's LOSS_RTOL; after it, the criteria of
# tests/test_ensemble.py, which hold JAX's vmapped ensemble to its own
# sequential runs.  test_torch_train.py's PARAM_ATOL/FLIP_SHARE do not hold
# here: at this configuration a float-noise sign flip of the L1 gradient
# spreads to most parameters within 8 steps, and JAX's own vmapped and
# sequential runs of seed 2 differ by 1.5e-4 in relative loss.
LOSS_RTOL = 1e-5
# eval trajectories after that drift: to 1e-2 of each metric's largest
# magnitude.  Momentum is a sum of density x velocity over the grid whose
# means sit near zero and which moves most with the drifted parameters
# (seed 2: 3e-3 of that scale)
TRAJ_RTOL = 1e-2


@pytest.fixture(scope="module")
def tiny_study():
    cfg, cond, fields = synthetic_study(n=32, height=CFG.height, width=CFG.width,
                                        base_channels=CFG.base_channels)
    assert cfg == CFG
    return cond, fields


def _cf(fields):
    return np.ascontiguousarray(np.transpose(fields, (0, 3, 1, 2)))


def _assert_equivalent(ens, sequential, loss_atol=2e-3):
    """Params + logged losses of the ensemble vs N runs ((model or state
    dict, losses) each), by the criteria of tests/test_ensemble.py
    ``_assert_equivalent``."""
    for m, (params_m, losses_m) in enumerate(sequential):
        want = params_m if isinstance(params_m, dict) else params_m.state_dict()
        got = ens.member_params(m)
        diffs = np.concatenate([(got[k] - want[k]).abs().numpy().ravel()
                                for k in want])
        assert diffs.max() < 2e-2, f"member {m}: max drift {diffs.max():.2e}"
        assert np.quantile(diffs, 0.99) < 1e-3, f"member {m}: widespread drift"
        assert np.median(diffs) < 1e-4
        ens_losses = np.array([l[m] for _, l in ens.losses])
        seq_losses = np.array([l for _, l in losses_m])
        assert ens_losses.shape == seq_losses.shape
        assert np.abs(ens_losses - seq_losses).max() < loss_atol


def test_ensemble_loader_matches_jax(tiny_study):
    _, fields = tiny_study
    n = len(fields)
    for make, jmake in ((lambda s: ShardedLoader(n, 8, seed=s),
                         lambda s: JaxShardedLoader(n, 8, seed=s)),
                        (lambda s: ShardAwareLoader(n, 8, 5, seed=s),
                         lambda s: JaxShardAwareLoader(n, 8, 5, seed=s))):
        ens = EnsembleLoader([make(s) for s in SEEDS])
        jens = JaxEnsembleLoader([jmake(s) for s in SEEDS])
        assert ens.seeds == jens.seeds == list(SEEDS)
        assert ens.steps_per_epoch == jens.steps_per_epoch
        got, want = list(ens.iter_epochs(3)), list(jens.iter_epochs(3))
        assert len(got) == len(want) == 3 * ens.steps_per_epoch
        assert all(np.array_equal(a, b) and a.shape == (3, 8) for a, b in zip(got, want))
        assert ens.state() == jens.state()
    state = ens.state()
    ens.restore({**state, "epoch": 1, "step_in_epoch": 2})
    jens.restore({**state, "epoch": 1, "step_in_epoch": 2})
    assert np.array_equal(next(iter(ens)), next(iter(jens)))
    with pytest.raises(ValueError, match="seeds"):
        ens.restore({**state, "seeds": state["seeds"][:-1]})
    with pytest.raises(ValueError, match="steps/epoch"):
        EnsembleLoader([ShardedLoader(n, 8, seed=0), ShardedLoader(n // 2, 8, seed=1)])


def _stores(kind, fields):
    samples = _cf(fields)
    n = len(fields)
    if kind == "raw":
        return RawArrayStore(fields, device="cpu"), None, SEEDS
    if kind == "sharded":
        return (ShardedCompressedStore(samples, [0.02] * n, shard_size=8, device="cpu"),
                channels_last, SEEDS)
    if kind == "device":
        return (DeviceResidentCompressedStore.from_samples(
            samples, [0.02] * n, shard_size=8, device="cpu"), channels_last, SEEDS)
    if kind == "per_member_sharded":
        return ([ShardedCompressedStore(samples, [tol] * n, shard_size=8, device="cpu")
                 for tol in (0.01, 0.5)], channels_last, (7, 7))
    return ([DeviceResidentCompressedStore.from_samples(samples, [tol] * n, shard_size=8,
                                                        device="cpu")
             for tol in (0.01, 0.5)], channels_last, (7, 7))


@pytest.mark.parametrize("kind", ["raw", "sharded", "device", "per_member_sharded",
                                  "per_member_device"])
def test_ensemble_matches_sequential(tiny_study, kind):
    cond, fields = tiny_study
    data, transform, seeds = _stores(kind, fields)
    ens = train_ensemble(CFG, TC, cond, data, seeds, target_transform=transform,
                         device="cpu")
    assert ens.steps == 2 * (len(fields) // 8) and ens.num_members == len(seeds)
    stores = data if isinstance(data, list) else [data] * len(seeds)
    sequential = [train_surrogate(CFG, dataclasses.replace(TC, seed=s), cond, st,
                                  target_transform=transform, device="cpu")
                  for s, st in zip(seeds, stores)]
    _assert_equivalent(ens, sequential)
    if isinstance(data, list):      # the two members really saw different data
        a, b = ens.member_params(0), ens.member_params(1)
        assert any(float((a[k] - b[k]).abs().max()) > 1e-4 for k in a)


def test_ensemble_matches_jax(tiny_study):
    """The port's ensemble from the JAX members' initial parameters, against
    JAX's train_ensemble: losses, final params and eval trajectories."""
    cond, fields = tiny_study
    jcfg = JaxConfig(height=16, width=16, base_channels=16)
    jinit = jax.tree.map(np.asarray, jax_init_ensemble(jcfg, SEEDS))
    jtc = JaxTrainConfig(epochs=2, batch_size=8, lr=1e-3, log_every=1)
    jres = jax_train_ensemble(jcfg, jtc, cond, JaxRawStore(fields), SEEDS,
                              eval_conditions=cond[:8], eval_targets=fields[:8])
    init = stack_params([params_from_jax(jax.tree.map(lambda x: x[m], jinit))
                         for m in range(len(SEEDS))])
    res = train_ensemble(CFG, TC, cond, RawArrayStore(fields, device="cpu"), SEEDS,
                         eval_conditions=cond[:8], eval_targets=fields[:8],
                         params=init, device="cpu")
    assert res.steps == jres.steps == 8
    assert [s for s, _ in res.losses] == [s for s, _ in jres.losses]
    np.testing.assert_allclose(res.losses[0][1], jres.losses[0][1],
                               rtol=LOSS_RTOL, atol=0)
    jax_members = [(params_from_jax(jax.tree.map(lambda x: np.asarray(x[m]), jres.params)),
                    [(s, l[m]) for s, l in jres.losses]) for m in range(len(SEEDS))]
    _assert_equivalent(res, jax_members)
    assert set(res.trajectories) == set(jres.trajectories)
    for k, v in res.trajectories.items():
        assert v.shape == (len(SEEDS), 2)
        want = jres.trajectories[k]
        np.testing.assert_allclose(v, want, rtol=0,
                                   atol=TRAJ_RTOL * np.abs(want).max())
    # training reduces the mean eval L1 across members
    assert res.trajectories["l1"][:, -1].mean() < res.trajectories["l1"][:, 0].mean()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_band_artifact_loads_in_both_packages(tmp_path, writer):
    rng = np.random.default_rng(5)
    kw = dict(trajectories={"psnr": rng.standard_normal((4, 7)),
                            "mass": rng.standard_normal((4, 7))},
              seeds=[0, 1, 2, 3], sigmas=2.5, meta={"epochs": 7})
    root = str(tmp_path / "band")
    (BandArtifact if writer == "port" else JaxBandArtifact)(**kw).save(root)
    for cls in (BandArtifact, JaxBandArtifact):
        back = cls.load(root)
        assert back.seeds == [0, 1, 2, 3] and back.sigmas == 2.5
        assert back.meta == {"epochs": 7} and back.metrics == ["mass", "psnr"]
        for k, v in kw["trajectories"].items():
            assert np.array_equal(back.trajectories[k], v)
    with np.load(tmp_path / "band" / "bands.npz") as z:
        assert sorted(z.files) == sorted(f"{p}_{k}" for p in ("traj", "mean", "std")
                                         for k in ("mass", "psnr"))
        port_band = BandArtifact.load(root).band("psnr")
        assert np.array_equal(z["mean_psnr"], port_band.mean)
        assert np.array_equal(z["std_psnr"], port_band.std)
    v = BandArtifact.load(root).verdict("psnr", kw["trajectories"]["psnr"][0])
    jv = JaxBandArtifact.load(root).verdict("psnr", kw["trajectories"]["psnr"][0])
    assert dataclasses.asdict(v) == dataclasses.asdict(jv)


@pytest.mark.parametrize("device_resident", [True, False], ids=["device", "host"])
def test_certify_tolerance_end_to_end(tiny_study, tmp_path, device_resident):
    """tests/test_ensemble.py's certification assertions, on both store
    backends; the base tolerances equal JAX's Algorithm 1 at the same e."""
    cond, fields = tiny_study
    tc = TrainConfig(epochs=3, batch_size=8, lr=3e-3, log_every=10)
    res = certify_tolerance(
        CFG, tc, cond, fields, eval_conditions=cond, eval_targets=fields,
        seeds=SEEDS, multiples=(0.5, 16.0), shard_size=8,
        device_resident=device_resident, artifact_dir=str(tmp_path / "cert"),
        device="cpu")
    assert isinstance(res, CertificationResult)
    assert [c.multiple for c in res.candidates] == [0.5, 16.0]
    ratios = [c.ratio for c in res.candidates]
    assert all(r > 1.0 for r in ratios) and ratios[1] > ratios[0]
    assert res.model_l1_error > 0
    assert res.base_tolerances.shape == (len(fields),)
    assert (res.base_tolerances > 0).all()
    devs = [c.per_metric["psnr"].dev_vs_seeds for c in res.candidates]
    assert devs[1] > devs[0]
    assert res.max_benign is not None
    assert res.max_benign.multiple == 0.5 and res.max_benign.ratio > 1.0
    for cls in (BandArtifact, JaxBandArtifact):
        art = cls.load(str(tmp_path / "cert"))
        assert set(art.trajectories) == {"l1", "psnr", "mass", "mom_x", "mom_y"}
    assert (tmp_path / "cert" / "certification.json").exists()
    s = res.summary()
    assert len(s["candidates"]) == 2
    assert s["max_benign_ratio"] == res.max_benign.ratio
    want = jax_find_tolerance_batch(_cf(fields), np.full(len(fields), res.model_l1_error,
                                                         np.float32))
    assert np.array_equal(res.base_tolerances, want.tolerance)


def test_one_fetch_per_step(tiny_study, monkeypatch):
    """A shared host store is read once per step (the union of the
    members' indices); device-resident stores decode every member's batch
    in one gathered decode per step, per-member stores included."""
    cond, fields = tiny_study
    store = RawArrayStore(fields, device="cpu")
    tc = dataclasses.replace(TC, prefetch=0)
    res = train_ensemble(CFG, tc, cond, store, SEEDS, device="cpu")
    assert store.stats.batches == res.steps
    calls = []
    real = ops.zfp_decode_blocks_fa_gather

    def counting(payload, emax, nplanes, idx, padded_shape, shape):
        calls.append((payload.shape[0], idx.shape[0]))
        return real(payload, emax, nplanes, idx, padded_shape, shape)

    monkeypatch.setattr(ops, "zfp_decode_blocks_fa_gather", counting)
    stores, transform, seeds = _stores("per_member_device", fields)
    res = train_ensemble(CFG, tc, cond, stores, seeds, target_transform=transform,
                         device="cpu")
    n = len(fields)
    assert calls == [(2 * n, 2 * 8)] * res.steps
    steps_before = get_registry().counter("ensemble.steps").value
    train_ensemble(CFG, dataclasses.replace(tc, max_steps=2), cond, stores[0], SEEDS,
                   target_transform=transform, device="cpu")
    assert calls[-2:] == [(n, 3 * 8)] * 2
    assert get_registry().counter("ensemble.steps").value == steps_before + 2


def test_ensemble_train_step_and_guards(tiny_study):
    cond, fields = tiny_study
    store = RawArrayStore(fields, device="cpu")
    params = init_ensemble(CFG, SEEDS, device="cpu")
    for m, s in enumerate(SEEDS):
        one = init_surrogate(CFG, s, "cpu").state_dict()
        assert all(torch.equal(params[k][m], one[k]) for k in one)
    opt_cfg = AdamConfig(lr=1e-3)
    idx = np.stack([np.arange(8)] * len(SEEDS))
    c = torch.from_numpy(cond[idx])
    t = torch.from_numpy(fields[idx])
    new, opt, loss = ensemble_train_step(params, adam_init(params, opt_cfg), c, t,
                                         CFG, opt_cfg)
    assert loss.shape == (len(SEEDS),) and int(opt.step) == 1
    assert all(new[k].shape == params[k].shape for k in params)
    with pytest.raises(ValueError, match="checkpoint"):
        train_ensemble(CFG, dataclasses.replace(TC, ckpt_dir="ckpt"), cond, store,
                       SEEDS, device="cpu")
    with pytest.raises(ValueError, match="members"):
        train_ensemble(CFG, TC, cond, [store], SEEDS, device="cpu")
    dev_store = DeviceResidentCompressedStore.from_samples(_cf(fields), [0.1] * 32,
                                                           device="cpu")
    with pytest.raises(ValueError, match="mix"):
        train_ensemble(CFG, TC, cond, [store, dev_store], (0, 1), device="cpu")
    with pytest.raises(ValueError, match="fixed-accuracy"):
        DeviceResidentCompressedStore.from_samples(
            _cf(fields), [0.1] * 32, codec=get_codec("fixed_rate"), device="cpu")
    with pytest.raises(FileNotFoundError, match="holds no produced dataset"):
        certify_tolerance(CFG, TC, None, "produced/dataset", eval_conditions=cond,
                          eval_targets=fields, device="cpu")
    with pytest.raises(ValueError, match="conditions=None"):
        certify_tolerance(CFG, TC, None, fields, eval_conditions=cond,
                          eval_targets=fields, device="cpu")
