"""The port's study (``repro_torch.study``) against the JAX study
(``benchmarks/common.py`` ``build_study``), on the CPU at a reduced size.

Both modules' size constants are set alike for the test: 4 RT members of
32x16 over 40 solver steps and 21 snapshots, 1 test member, 2 seeds,
multiples (0.5, 16), base 8, 2 epochs of batch 8 (the surrogate needs
both grid sides divisible by 16).  The JAX ``build_study`` runs itself,
unmodified, into a temporary directory; the port's gets each seed's JAX
initial parameters through ``params_from_jax`` (its ``_train_on`` seam)
and the same loader order, so the two studies train the same models up
to float noise.  Held:

  * the fields and normalised fields to ``tests/test_torch_solver.py``'s
    ``SMALL_RTOL``; conditions, parameters and the split exactly;
  * every model's parameters by ``tests/test_ensemble.py``'s
    ``_assert_equivalent`` criteria; predictions pointwise to
    ``PRED_RTOL`` of each array's largest magnitude and their density
    PSNR to ``tests/test_torch_ensemble.py``'s ``TRAJ_RTOL``;
  * the model error ``e`` to ``E_RTOL``;
  * Algorithm 1 at JAX's ``e`` on JAX's sample: JAX's tolerance, ratio and
    iterations (the search runs through the codec's plain versions, bit
    for bit with JAX's; F2's power-of-two corner does not arise here);
  * each lossy store at JAX's tolerance on JAX's samples: JAX's ratio, and
    its samples decoded bit for bit as JAX's.

A second call reads the cache and trains nothing; ``per_sim_series`` and
``denormalize`` equal JAX's on the same arrays; the JAX study's checked-in
``experiments/data/study.{json,npz}`` hash the same before and after.
"""
import dataclasses
import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks import common  # noqa: E402
from repro.metrics import psnr as jax_psnr  # noqa: E402
from repro.models.surrogate import SurrogateConfig as JaxConfig  # noqa: E402
from repro.models.surrogate import init_surrogate as jax_init  # noqa: E402
from repro.train.loop import TrainConfig as JaxTrainConfig  # noqa: E402

from repro_torch import study  # noqa: E402
from repro_torch.core import find_tolerance  # noqa: E402
from repro_torch.data import CompressedArrayStore  # noqa: E402
from repro_torch.metrics import psnr  # noqa: E402
from repro_torch.models.surrogate import SurrogateConfig, params_from_jax  # noqa: E402
from repro_torch.train.loop import TrainConfig  # noqa: E402

torch.set_num_threads(2)

SIZE = dict(N_SIMS=4, N_TEST_SIMS=1, N_SEEDS=2, LOSSY_MULTIPLES=(0.5, 16.0))
GRID = dict(ny=32, nx=16, nsteps=40, nsnaps=21)
MODEL = dict(height=32, width=16, base_channels=8)
TRAIN = dict(epochs=2, batch_size=8, lr=1e-3)
SMALL_RTOL = 1e-5           # tests/test_torch_solver.py
TRAJ_RTOL = 1e-2            # tests/test_torch_ensemble.py
# predictions, pointwise, to this share of each array's largest magnitude.
# The raw models train on fields equal to 1e-5 (measured 2.5e-5 of the
# max); models trained on computed targets drift further from the same
# init and the same bits of data (the lossy stores decode bit for bit
# alike): a float-noise sign flip of the L1 gradient spreads, as in
# tests/test_torch_ensemble.py (measured 2.2e-2 of the max at x16, 9e-3
# for the student; their parameters stay within _assert_equivalent's
# criteria and their density PSNR within TRAJ_RTOL)
PRED_RTOL = {"raw_preds": TRAJ_RTOL, "lossy_preds": 5e-2, "student_preds": 5e-2}
E_RTOL = 1e-3
JAX_STUDY_FILES = [os.path.join(REPO, "experiments", "data", f)
                   for f in ("study.json", "study.npz")]


def _digests():
    out = {}
    for p in JAX_STUDY_FILES:
        with open(p, "rb") as f:
            out[p] = hashlib.sha256(f.read()).hexdigest()
    return out


def _jax_params(seed):
    p = jax_init(jax.random.PRNGKey(seed), JaxConfig(**MODEL))
    return params_from_jax(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both studies at the reduced size, with what each passed to
    Algorithm 1, to its lossy stores and to its trainer."""
    before = _digests()
    root = tmp_path_factory.mktemp("study")
    seen = {"jax_alg1": [], "jax_stores": [], "jax_seeds": [], "port_seeds": [],
            "jax_params": [], "port_params": []}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (common, study):
            for k, v in SIZE.items():
                mp.setattr(mod, k, v)
        mp.setattr(common, "RT_MINI", dataclasses.replace(common.RT_MINI, **GRID))
        mp.setattr(common, "MODEL_CFG", JaxConfig(**MODEL))
        mp.setattr(common, "TRAIN_CFG", JaxTrainConfig(**TRAIN))
        mp.setattr(common, "DATA_DIR", str(root / "jax"))
        mp.setattr(common, "_STUDY", None)
        mp.setattr(study, "RT_MINI", dataclasses.replace(study.RT_MINI, **GRID))
        mp.setattr(study, "MODEL_CFG", SurrogateConfig(**MODEL))
        mp.setattr(study, "TRAIN_CFG", TrainConfig(**TRAIN))

        jfind, jstore, jtrain = common.find_tolerance, common.CompressedArrayStore, \
            common._train_on

        def find(sample, e, **kw):
            res = jfind(sample, e, **kw)
            seen["jax_alg1"].append((np.array(sample), e, res))
            return res

        def store(samples, **kw):
            st = jstore(samples, **kw)
            seen["jax_stores"].append((np.stack(samples), kw["tolerances"], st))
            return st

        def jax_train_on(*a, seed, **kw):
            seen["jax_seeds"].append(seed)
            params = jtrain(*a, seed=seed, **kw)
            seen["jax_params"].append(params_from_jax(jax.tree.map(np.asarray, params)))
            return params

        mp.setattr(common, "find_tolerance", find)
        mp.setattr(common, "CompressedArrayStore", store)
        mp.setattr(common, "_train_on", jax_train_on)
        jstudy = common.build_study(force=True)

        ptrain = study._train_on

        def port_train_on(cfg, tc, cond, data, seed, device, **kw):
            seen["port_seeds"].append(seed)
            model = ptrain(cfg, tc, cond, data, seed, device, params=_jax_params(seed),
                           **kw)
            seen["port_params"].append(model.state_dict())
            return model

        mp.setattr(study, "_train_on", port_train_on)
        mp.setattr(study, "_STUDY", None)
        pdir = str(root / "port")
        pstudy = study.build_study(force=True, data_dir=pdir, device="cpu")
        yield {"jax": jstudy, "port": pstudy, "port_dir": pdir, "seen": seen,
               "digests_before": before}
        mp.setattr(study, "_STUDY", None)


def test_same_keys_shapes_and_split(built):
    j, p = built["jax"], built["port"]
    assert set(p) == set(j)
    assert set(p["meta"]) == set(j["meta"])
    for k in j:
        if k != "meta":
            assert p[k].shape == j[k].shape and p[k].dtype == j[k].dtype, k
    n_test = SIZE["N_TEST_SIMS"] * GRID["nsnaps"]
    assert p["test_nf"].shape == (n_test, GRID["ny"], GRID["nx"], 6)
    assert p["raw_preds"].shape[0] == SIZE["N_SEEDS"]
    assert p["lossy_preds"].shape[0] == len(SIZE["LOSSY_MULTIPLES"])
    for k in ("n_sims", "n_test_sims", "n_seeds", "nsnaps", "lossy_multiples",
              "rho_bounds"):
        assert p["meta"][k] == j["meta"][k], k
    assert np.array_equal(p["test_cond"], j["test_cond"])
    assert np.array_equal(p["test_pvec"], j["test_pvec"])
    # the same models in the same order: 5 raw seeds, 100 per multiple, the
    # teacher (0) and the student (200)
    seeds = built["seen"]
    assert seeds["port_seeds"] == seeds["jax_seeds"] == [0, 1, 100, 100, 0, 200]


def _worst_rel(got, want):
    return max(float(np.abs(got[..., f] - want[..., f]).max()
                     / np.abs(want[..., f]).max()) for f in range(want.shape[-1]))


def test_fields_and_normalisation_match_jax(built):
    j, p = built["jax"], built["port"]
    assert _worst_rel(p["test_nf"], j["test_nf"]) <= SMALL_RTOL
    # means of the velocities sit near 0: held to the bound of each field's scale
    std = np.asarray(j["meta"]["norm_std"])
    np.testing.assert_allclose(p["meta"]["norm_std"], std, rtol=SMALL_RTOL)
    assert (np.abs(np.subtract(p["meta"]["norm_mean"], j["meta"]["norm_mean"]))
            <= SMALL_RTOL * std).all()
    # denormalised test fields: the solver's fields within the same bound
    assert _worst_rel(study.denormalize(p, p["test_nf"]),
                      common.denormalize(j, j["test_nf"])) <= SMALL_RTOL


@pytest.mark.parametrize("key", ["raw_preds", "lossy_preds", "student_preds"])
def test_predictions_match_jax(built, key):
    got, want = built["port"][key], built["jax"][key]
    assert np.isfinite(got).all()
    got, want = got.reshape(-1, *want.shape[-4:]), want.reshape(-1, *want.shape[-4:])
    density = torch.from_numpy(np.array(built["jax"]["test_nf"][..., 0]))
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= PRED_RTOL[key] * np.abs(w).max(), key
        pg = psnr(density, torch.from_numpy(g[..., 0])).numpy()
        pw = np.asarray(jax_psnr(jnp.asarray(density.numpy()), jnp.asarray(w[..., 0])))
        assert np.abs(pg - pw).max() <= TRAJ_RTOL * np.abs(pw).max(), key


def test_models_match_jax(built):
    """Every trained model's parameters by tests/test_ensemble.py's
    ``_assert_equivalent`` criteria."""
    seen = built["seen"]
    assert len(seen["port_params"]) == len(seen["jax_params"]) == 6
    for m, (got, want) in enumerate(zip(seen["port_params"], seen["jax_params"])):
        assert got.keys() == want.keys()
        diffs = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() for k in want])
        assert diffs.max() < 2e-2, f"model {m}: max drift {diffs.max():.2e}"
        assert np.quantile(diffs, 0.99) < 1e-3, f"model {m}: widespread drift"
        assert np.median(diffs) < 1e-4, m


def test_model_error_matches_jax(built):
    e, je = built["port"]["meta"]["model_l1_error"], built["jax"]["meta"]["model_l1_error"]
    assert e == pytest.approx(je, rel=E_RTOL)


def test_algorithm1_at_jax_error_on_jax_sample(built):
    (sample, e, jres), = built["seen"]["jax_alg1"]
    meta = built["jax"]["meta"]
    assert e == meta["model_l1_error"] and jres.tolerance == meta["alg1_tolerance"]
    res = find_tolerance(sample, e, device="cpu")
    assert (res.tolerance, res.iterations) == (jres.tolerance, jres.iterations)
    assert res.ratio == pytest.approx(jres.ratio, rel=1e-6)
    assert res.compression_l1 == pytest.approx(jres.compression_l1, rel=1e-5)
    # the port's own search on its own numbers gave its meta
    pm = built["port"]["meta"]
    assert pm["alg1_iterations"] >= 1 and pm["alg1_tolerance"] > 0


def test_store_ratios_at_jax_tolerances_match_jax(built):
    stores = built["seen"]["jax_stores"]
    assert [t[0] for _, t, _ in stores] == built["jax"]["meta"]["lossy_tolerances"]
    for samples, tols, jstore in stores:
        store = CompressedArrayStore(list(samples), tolerances=tols, device="cpu")
        assert store.ratio == jstore.ratio
        idx = np.arange(len(samples))
        assert np.array_equal(store.get_batch(idx).numpy(), np.asarray(jstore.get_batch(idx)))
    # and the port's own ratios rise with the multiple, as JAX's do
    for m in (built["port"]["meta"], built["jax"]["meta"]):
        assert m["lossy_ratios"] == sorted(m["lossy_ratios"])


def test_second_call_loads_the_cache_without_training(built, monkeypatch):
    def fail(*a, **kw):
        raise AssertionError("the cached study was rebuilt")

    monkeypatch.setattr(study, "_train_on", fail)
    monkeypatch.setattr(study, "generate_ensemble", fail)
    same = study.build_study(data_dir=built["port_dir"])
    assert same is built["port"]                 # the process's copy
    monkeypatch.setattr(study, "_STUDY", None)
    loaded = study.build_study(data_dir=built["port_dir"])
    assert loaded is not built["port"]           # read back from the directory
    assert loaded["meta"] == json.loads(json.dumps(built["port"]["meta"]))
    for k, v in built["port"].items():
        if k != "meta":
            assert np.array_equal(loaded[k], v), k
    samples, tol, st = study.study_test_samples(5, data_dir=built["port_dir"])
    assert st is loaded and tol == loaded["meta"]["alg1_tolerance"]
    assert len(samples) == 5 and samples[0].shape == (6, GRID["ny"], GRID["nx"])
    assert np.array_equal(samples[1], np.transpose(loaded["test_nf"][1], (2, 0, 1)))


def test_per_sim_series_and_denormalize_equal_jax(built):
    j = built["jax"]
    for arr in (j["test_nf"], j["raw_preds"][0], j["lossy_preds"][-1]):
        want = common.per_sim_series(j, arr)
        got = study.per_sim_series(j, arr)
        assert got.shape == want.shape == (SIZE["N_TEST_SIMS"], GRID["nsnaps"],
                                           GRID["ny"], GRID["nx"], 6)
        assert np.array_equal(got, want)
        assert np.array_equal(study.denormalize(j, arr), common.denormalize(j, arr))


def test_default_cache_is_not_the_jax_study(built):
    port_dir = os.path.realpath(study.DATA_DIR)
    assert port_dir == os.path.join(os.path.realpath(REPO), "experiments", "data_torch")
    assert port_dir != os.path.realpath(os.path.join(REPO, "experiments", "data"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "experiments/data_torch/" in f.read().split()
    assert _digests() == built["digests_before"]

