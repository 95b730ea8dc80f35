"""The paper's study at container scale, built by the port.

Counterpart of the study half of ``benchmarks/common.py``: built once and
cached under ``experiments/data_torch/`` (never the JAX study's
``experiments/data/``):

  * an RT mini ensemble from the spectral solver,
  * 5 raw-data surrogate models (different seeds) -- the variability band,
  * lossy models trained on ZFP-compressed data at Algorithm-1-derived
    tolerance multiples (x0.5, x1, x2 benign; x16 over-compressed),
  * a generation-loss model trained on the raw model's own outputs.

The constants have the JAX module's names and values; ``build_study``
reads them when it is called, so a caller may change them first.  Every
model trains from a store of the port: the raw models and the teacher
from a ``RawArrayStore`` of the normalised training fields, the lossy
models from a ``CompressedArrayStore`` at one tolerance for every sample
(channels-last targets), the student from a ``RawArrayStore`` of the
teacher's outputs.  Batches follow ``ShardedLoader(n, batch_size,
seed)``, the order the JAX study's loader draws.  The models are
initialised from ``torch.Generator`` seeds, so they are not the JAX
study's models: its numbers are of the same kind, not the same.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tolerance import find_tolerance
from repro_torch.data.store import CompressedArrayStore, RawArrayStore, channels_last
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.surrogate import (FieldNormalizer, SurrogateConfig,
                                          make_conditions)
from repro_torch.sim import PCHIP_SPEC, RT_SPEC, generate_ensemble
from repro_torch.train.loop import TrainConfig, predict_fields, train_surrogate

DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "experiments",
                        "data_torch")

RT_MINI = dataclasses.replace(RT_SPEC, ny=48, nx=16, nsteps=500)
PCHIP_MINI = dataclasses.replace(PCHIP_SPEC, ny=32, nx=32, nsteps=400)

N_SIMS = 16
N_TEST_SIMS = 4
N_SEEDS = 5
LOSSY_MULTIPLES = (0.5, 1.0, 2.0, 16.0)
MODEL_CFG = SurrogateConfig(height=48, width=16, base_channels=16)
TRAIN_CFG = TrainConfig(epochs=6, batch_size=32, lr=1e-3)


def _train_on(cfg, tc, cond, data, seed, device, target_transform=None,
              params=None):
    """One model of the study, trained from ``data`` with ``tc``'s
    settings and ``seed``; ``params`` (a state dict) replaces the seed's
    initial parameters."""
    tc = dataclasses.replace(tc, seed=seed)
    model, _ = train_surrogate(cfg, tc, cond, data, params=params,
                               target_transform=target_transform, device=device)
    return model


# One study per process and directory: every caller shares it.
_STUDY: Optional[dict] = None
_STUDY_DIR: Optional[str] = None
_STUDY_SAMPLES: dict = {}


def study_test_samples(n: int, *, data_dir: Optional[str] = None,
                       device: DeviceLike = None):
    """``n`` channels-first (C, H, W) samples cycled from the study's test
    fields, plus its Algorithm-1 tolerance: ``(samples, tolerance,
    study)``.  Treat the samples as read-only."""
    study = build_study(data_dir=data_dir, device=device)
    if n not in _STUDY_SAMPLES:
        test = study["test_nf"]
        _STUDY_SAMPLES[n] = [np.transpose(test[i % len(test)], (2, 0, 1))
                             for i in range(n)]
    return _STUDY_SAMPLES[n], float(study["meta"]["alg1_tolerance"]), study


def _load(data_dir: str) -> Optional[dict]:
    cache = os.path.join(data_dir, "study.npz")
    meta_p = os.path.join(data_dir, "study.json")
    if not (os.path.exists(cache) and os.path.exists(meta_p)):
        return None
    with np.load(cache) as z:
        arrays = {k: z[k] for k in z.files}
    with open(meta_p) as f:
        meta = json.load(f)
    return {"meta": meta, **arrays}


def build_study(force: bool = False, *, data_dir: Optional[str] = None,
                device: DeviceLike = None) -> dict:
    """The study: ``meta`` plus ``raw_preds`` (seeds, Ntest, H, W, 6),
    ``lossy_preds`` (multiples, ...), ``student_preds``, ``test_nf``,
    ``test_cond`` and ``test_pvec``, as ``benchmarks/common.py`` builds
    them.  Loaded from ``data_dir`` (default ``experiments/data_torch/``)
    unless ``force``; built on ``device`` (the card unless
    ``device="cpu"``) and written there otherwise."""
    global _STUDY, _STUDY_DIR
    data_dir = os.path.abspath(data_dir or DATA_DIR)
    if not force:
        if _STUDY is not None and _STUDY_DIR == data_dir:
            return _STUDY
        study = _load(data_dir)
        if study is not None:
            _STUDY, _STUDY_DIR = study, data_dir
            _STUDY_SAMPLES.clear()
            return study
    dev = resolve_device(device)
    os.makedirs(data_dir, exist_ok=True)

    t_start = time.time()
    pvec, fields = generate_ensemble(RT_MINI, N_SIMS, seed=0, device=dev)
    nsnaps = fields.shape[1]
    norm = FieldNormalizer.fit(fields)
    flat = fields.reshape(-1, *fields.shape[2:])
    nf = norm.normalize(torch.from_numpy(flat)).numpy()
    cond = make_conditions(pvec, nsnaps)
    n_train = (N_SIMS - N_TEST_SIMS) * nsnaps
    train_nf, test_nf = nf[:n_train], nf[n_train:]
    train_cond, test_cond = cond[:n_train], cond[n_train:]
    raw_store = RawArrayStore(train_nf, device=dev)

    def predict(model, c):
        return predict_fields(model, c, device=dev)

    # --- 5 raw-data models (training-variability band) --------------------
    raw_preds = np.stack([
        predict(_train_on(MODEL_CFG, TRAIN_CFG, train_cond, raw_store, s, dev),
                test_cond)
        for s in range(N_SEEDS)])                         # (S, Ntest, H, W, 6)

    # --- Algorithm 1 tolerance from model error ---------------------------
    e_model = float(np.mean(np.abs(raw_preds[0] - test_nf)))
    sample = np.transpose(train_nf[nsnaps // 2], (2, 0, 1))
    tol_res = find_tolerance(sample, e_model, device=dev)

    # --- lossy models at tolerance multiples -------------------------------
    samples = [np.transpose(x, (2, 0, 1)) for x in train_nf]
    lossy_preds, lossy_ratios, lossy_tols = [], [], []
    for mult in LOSSY_MULTIPLES:
        tol = tol_res.tolerance * mult
        store = CompressedArrayStore(samples, tolerances=[tol] * n_train, device=dev)
        model = _train_on(MODEL_CFG, TRAIN_CFG, train_cond, store, 100, dev,
                          target_transform=channels_last)
        lossy_preds.append(predict(model, test_cond))
        lossy_ratios.append(float(store.ratio))
        lossy_tols.append(tol)
    lossy_preds = np.stack(lossy_preds)

    # --- generation-loss model (paper Fig. 5) ------------------------------
    teacher = _train_on(MODEL_CFG, TRAIN_CFG, train_cond, raw_store, 0, dev)
    teacher_out = predict(teacher, train_cond)
    student = _train_on(MODEL_CFG, TRAIN_CFG, train_cond,
                        RawArrayStore(teacher_out, device=dev), 200, dev)
    student_preds = predict(student, test_cond)

    meta = {
        "build_seconds": round(time.time() - t_start, 1),
        "n_sims": N_SIMS, "n_test_sims": N_TEST_SIMS, "n_seeds": N_SEEDS,
        "nsnaps": int(nsnaps),
        "model_l1_error": e_model,
        "alg1_tolerance": tol_res.tolerance,
        "alg1_ratio": tol_res.ratio,
        "alg1_iterations": tol_res.iterations,
        "lossy_multiples": list(LOSSY_MULTIPLES),
        "lossy_ratios": lossy_ratios,
        "lossy_tolerances": lossy_tols,
        "norm_mean": norm.mean.tolist(),
        "norm_std": norm.std.tolist(),
        "rho_bounds": [1.0, None],
    }
    arrays = dict(raw_preds=raw_preds, lossy_preds=lossy_preds,
                  student_preds=student_preds, test_nf=test_nf,
                  test_cond=test_cond, test_pvec=pvec[N_SIMS - N_TEST_SIMS:])
    np.savez_compressed(os.path.join(data_dir, "study.npz"), **arrays)
    with open(os.path.join(data_dir, "study.json"), "w") as f:
        json.dump(meta, f, indent=1)
    _STUDY, _STUDY_DIR = {"meta": meta, **arrays}, data_dir
    _STUDY_SAMPLES.clear()
    return _STUDY


def denormalize(study, x):
    m = np.asarray(study["meta"]["norm_mean"], np.float32)
    s = np.asarray(study["meta"]["norm_std"], np.float32)
    return x * s + m


def per_sim_series(study, arr):
    """(N_test*T, H, W, 6) -> (n_test_sims, T, H, W, 6) raw units."""
    t = study["meta"]["nsnaps"]
    n = study["meta"]["n_test_sims"]
    return denormalize(study, arr).reshape(n, t, *arr.shape[1:])
