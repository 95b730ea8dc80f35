"""The paper's full §III-§V study on the port at container scale, the
counterpart of ``examples/compression_study.py``: variability bands,
Algorithm-1 tolerance, lossy models at several ratios, benign/degraded
verdicts on physics + PSNR metrics, then the batched Algorithm 1 and the
sharded store, exact resume, device-resident training,
``certify_tolerance`` and streaming production.

The study comes from :mod:`repro_torch.study` (built once and cached
under ``experiments/data_torch/``; the JAX study's ``experiments/data/``
is never read).  The exact-resume section runs under
``torch.use_deterministic_algorithms(True)``: on the card a resumed run
is bit-identical to an uninterrupted one only with deterministic
kernels, and cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` before its first
handle, which ``main`` sets unless the caller did.

Run:  PYTHONPATH=src python examples/compression_study_torch.py
      PYTHONPATH=src python examples/compression_study_torch.py --device cpu
(The first run builds and caches the study.)
"""
import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import study as study_mod
from repro_torch.core import band_verdict, compute_band, find_tolerance_batch
from repro_torch.core.ensemble import certify_tolerance
from repro_torch.data import ShardAwareLoader, ShardedCompressedStore, channels_last
from repro_torch.datagen import (CodecPlan, ProductionPlan, ScenarioPlan, produce,
                                 scenario_conditions)
from repro_torch.device import resolve_device
from repro_torch.metrics import psnr, total_momentum
from repro_torch.models.surrogate import SurrogateConfig
from repro_torch.sim import EnsembleSpec
from repro_torch.train.loop import TrainConfig, train_surrogate


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside, the caller's setting restored after."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _same_state(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def study_verdicts(study, dev) -> dict:
    """The paper's Fig. 3 verdicts and the density PSNRs of a study's
    models (any dict of ``build_study``'s arrays and meta), printed as the
    JAX example prints them: the y-momentum band of the raw models, each
    lossy model's share inside it and its verdict, the raw models' PSNR
    range and each lossy model's PSNR."""
    meta = study["meta"]

    def dev_tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def y_momentum(pred):
        series = study_mod.per_sim_series(study, pred)
        return total_momentum(dev_tensor(series))[..., 1].cpu().numpy().ravel()

    raw_tr = [y_momentum(p) for p in study["raw_preds"]]
    band = compute_band(raw_tr)
    print("y-momentum variability band (paper Fig. 3): "
          f"mean width +/-2sigma = {2 * band.std.mean():.2f}")
    print(f"{'mult':>6} {'ratio':>8} {'inside band':>12} {'verdict'}")
    verdicts = []
    for mult, ratio, pred in zip(meta["lossy_multiples"], meta["lossy_ratios"],
                                 study["lossy_preds"]):
        v = band_verdict(band, raw_tr, y_momentum(pred), frac_required=0.9)
        verdict = "benign" if v.benign else "DEGRADED (over-compressed)"
        verdicts.append({"multiple": mult, "ratio": ratio, "inside_frac": v.inside_frac,
                         "benign": v.benign})
        print(f"{mult:>6g} {ratio:>7.1f}x {v.inside_frac:>11.1%}  {verdict}")

    print("\nPSNR (density field), raw-model range vs lossy models:")
    density = dev_tensor(study["test_nf"][..., 0])

    def density_psnr(pred):
        return float(psnr(density, dev_tensor(pred[..., 0])).mean())

    raw_psnr = [density_psnr(p) for p in study["raw_preds"]]
    print(f"  raw models: [{min(raw_psnr):.2f}, {max(raw_psnr):.2f}] dB")
    lossy_psnr = []
    for mult, ratio, pred in zip(meta["lossy_multiples"], meta["lossy_ratios"],
                                 study["lossy_preds"]):
        lossy_psnr.append(density_psnr(pred))
        print(f"  x{mult:<4g} ({ratio:5.1f}x): {lossy_psnr[-1]:.2f} dB")
    return {"band_width": float(2 * band.std.mean()), "verdicts": verdicts,
            "raw_psnr": raw_psnr, "lossy_psnr": lossy_psnr}


def main(argv=None) -> dict:
    """Prints what the JAX example prints; returns the device, the band,
    the verdicts, the PSNRs, each later section's readings and the seconds
    of every section."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--data-dir", default=None,
                    help="the study's cache (default experiments/data_torch/)")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = resolve_device(args.device)
    seconds = {}
    t_sec = [time.perf_counter()]

    def section_done(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = now - t_sec[0]
        t_sec[0] = now

    study = study_mod.build_study(data_dir=args.data_dir, device=dev)
    section_done("study")
    meta = study["meta"]
    print(f"study: {meta['n_seeds']} raw models, "
          f"{len(meta['lossy_multiples'])} lossy models, "
          f"model L1 error e={meta['model_l1_error']:.4f}")
    print(f"Algorithm 1: tolerance={meta['alg1_tolerance']:.3g} "
          f"ratio={meta['alg1_ratio']:.1f}x in {meta['alg1_iterations']} iters\n")

    quality = study_verdicts(study, dev)
    section_done("band_psnr")
    test = study["test_nf"]

    # --- per-sample Algorithm 1, batched + sharded store -------------------
    # One search over the whole stack, one batched encode per shard chunk,
    # one kernel decode per batch fetch.
    n = min(32, len(test))
    samples = np.stack([np.transpose(test[i], (2, 0, 1)) for i in range(n)])
    br = find_tolerance_batch(samples, [meta["model_l1_error"]] * n, device=dev)
    store = ShardedCompressedStore(samples, tolerances=br.tolerance, shard_size=16,
                                   device=dev)
    loader = ShardAwareLoader.for_store(store, batch_size=8, seed=0)
    batch = store.get_batch(loader.take(1)[0])
    print(f"\nSharded store ({n} samples, shard_size=16):")
    print(f"  per-sample tolerances: [{br.tolerance.min():.3g}, "
          f"{br.tolerance.max():.3g}] in <= {int(br.iterations.max())} iters")
    print(f"  {store.num_shards} shards, ratio {store.ratio:.1f}x, "
          f"logical {store.stored_bytes / 1e3:.1f} kB "
          f"(raw {store.sample_nbytes * n / 1e3:.1f} kB)")
    print(f"  one-call batch decode: {tuple(batch.shape)} "
          f"in {store.stats.decode_seconds * 1e3:.1f} ms")
    section_done("sharded_store")

    # --- exact-resume training through the sharded store -------------------
    # The §III variability bands are only a valid compression yardstick if a
    # preempted run is bit-identical to an uninterrupted one: train through
    # the unified store/loader loop, kill mid-epoch, resume, compare.
    cond_n = study["test_cond"][:n]
    cfg = study_mod.MODEL_CFG
    tc = TrainConfig(epochs=2, batch_size=8, lr=1e-3, seed=0,
                     ckpt_every_steps=3, log_every=1)

    def train(train_cfg, data):
        return train_surrogate(cfg, train_cfg, cond_n, data,
                               target_transform=channels_last, device=dev)

    with deterministic():
        full, _ = train(tc, store)
        with tempfile.TemporaryDirectory() as td:
            tck = dataclasses.replace(tc, ckpt_dir=td)
            train(dataclasses.replace(tck, max_steps=5), store)          # "kill" @5
            resumed, _ = train(tck, store)
    exact = _same_state(full, resumed)
    print(f"  kill@step5 + resume vs uninterrupted: "
          f"bit-identical params = {exact}")
    section_done("exact_resume")

    # --- device-resident training: gather + decode inside the step ---------
    # The compressed store fits in device memory (that is the paper's whole
    # economics), so upload it once and train through the fused step: zero
    # host bytes per batch, decoded targets bit-identical to get_batch.
    resident = store.as_device_resident(device=dev)
    probe = loader.take(1)[0]
    same = bool(torch.equal(store.get_batch(probe), resident.get_batch(probe)))
    dev_model, _ = train(tc, resident)
    sf, sd = full.state_dict(), dev_model.state_dict()
    drift = max(float((sf[k] - sd[k]).abs().max()) for k in sf)
    print(f"\ndevice-resident store: {resident.resident_bytes / 1e3:.1f} kB in "
          f"device memory ({resident.ratio:.1f}x), batch decode bit-identical = "
          f"{same}, fused-step training drift vs host path = {drift:.2g}")
    section_done("device_resident")

    # --- end-to-end certification (ensemble subsystem) ---------------------
    # One call runs the whole paper pipeline on this data: 3-seed band
    # ensemble, per-sample Algorithm-1 tolerances, every candidate multiple
    # retrained in ONE stacked sweep, band_verdict per metric.
    print("\ncertify_tolerance (stacked ensemble + lossy sweep):")
    res = certify_tolerance(
        cfg, TrainConfig(epochs=3, batch_size=8, lr=1e-3, log_every=10),
        study["test_cond"], test, eval_conditions=study["test_cond"],
        eval_targets=test, seeds=(0, 1, 2), multiples=(0.5, 2.0, 16.0),
        shard_size=16, device=dev)
    candidates = []
    for c in res.candidates:
        worst = max(c.per_metric.values(), key=lambda v: v.dev_vs_seeds)
        candidates.append({"multiple": c.multiple, "ratio": c.ratio,
                           "worst_dev": worst.dev_vs_seeds, "benign": c.benign})
        print(f"  x{c.multiple:<4g} ratio={c.ratio:5.1f}x "
              f"worst_dev={worst.dev_vs_seeds:5.2f} "
              f"{'benign' if c.benign else 'DEGRADED'}")
    mb = res.max_benign
    print("  certified max benign: "
          + ("none at these multiples (a 3-epoch model is far from "
             "converged, so Algorithm 1's error bound already compresses "
             "aggressively)" if mb is None else
             f"x{mb.multiple:g} at {mb.ratio:.1f}x compression "
             f"({res.ensemble_seconds:.0f}s for the 3-seed band)"))
    section_done("certify")

    # --- streaming production: simulate -> encode-on-device -> store -------
    # Datasets are produced *already compressed*: the datagen subsystem
    # streams solver snapshots through the batched encoder into a sharded
    # store.  A preempted production run resumes from its shard manifests
    # and yields a bit-identical store; the produced path feeds
    # train_surrogate directly.
    print("\nstreaming production (repro_torch.datagen):")
    plan = ProductionPlan(
        scenarios=(ScenarioPlan(
            "rt_demo", EnsembleSpec(name="rt", ny=32, nx=16, nsnaps=9,
                                    nsteps=120), num_sims=4, seed=3),),
        codec=CodecPlan(tolerance=1e-3), shard_size=8)
    with tempfile.TemporaryDirectory() as td:
        part = produce(plan, td, max_shards=2, device=dev).scenarios[0]   # "preempted"
        rep = produce(plan, td, device=dev).scenarios[0]                  # resume
        print(f"  produce: {part.shards_written}+{rep.shards_written} shards "
              f"(kill after 2, resume recomputed {rep.sims_run}/"
              f"{plan.scenarios[0].num_sims} sims), "
              f"finalized={rep.finalized}")
        cond = scenario_conditions(rep.store_dir)
        small = SurrogateConfig(height=32, width=16, base_channels=8)
        _, hist = train_surrogate(
            small, TrainConfig(epochs=2, batch_size=8, lr=1e-3, log_every=1),
            cond, rep.store_dir, target_transform=channels_last, device=dev)
        print(f"  trained on produced path: loss {hist[0][1]:.3f} -> "
              f"{hist[-1][1]:.3f} over {len(hist)} steps")
    section_done("produce")

    return {"device": dev.type, "meta": meta, **quality,
            "batch_tolerances": br.tolerance, "batch_iterations": br.iterations,
            "sharded_ratio": store.ratio, "exact_resume": exact,
            "resident_same": same, "resident_drift": drift,
            "candidates": candidates,
            "max_benign": None if mb is None else mb.multiple,
            "produce": {"shards": (part.shards_written, rep.shards_written),
                        "sims_rerun": rep.sims_run, "finalized": rep.finalized,
                        "losses": hist},
            "seconds": seconds}


if __name__ == "__main__":
    main()
