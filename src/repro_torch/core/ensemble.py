"""Seed-ensemble training on stacked parameters + end-to-end certification.

Counterpart of ``repro/core/ensemble.py``.  The paper's method (§III-§IV)
needs N identically configured models that differ only in seed (the
variability band) plus one retrained model per candidate compression
tolerance.  Here one step advances all N members:

  * parameters and Adam moments are stacked, ``{name: (N, ...)}``; the
    step is the gradient of every member's L1 loss through one
    member-folded forward (the members' channels grouped in one
    channels-last batch, ``repro_torch.models.folded``), then one Adam
    update of the stacks (``repro_torch.train.source``);
  * every member consumes the batch stream an independent
    ``train_surrogate`` run with the same seed would (``EnsembleLoader``);
  * a shared host store is read and decoded once per step for the union of
    the members' indices; per-member stores (one lossy store per tolerance
    candidate) are read per member; device-resident stores decode every
    member's batch in one launch of the gathered decode, and on the card
    their step replays CUDA graphs from its second step on;
  * per-epoch metric trajectories (L1, PSNR, total mass and momentum) come
    from one member-folded forward of the eval set and feed
    ``compute_band`` and a persisted
    ``BandArtifact`` (``repro-band-v1``, the JAX package's format: a band
    written by either package loads in the other).

``certify_tolerance`` drives the whole pipeline: the raw seed ensemble,
per-sample Algorithm-1 tolerances (``find_tolerance_batch``), one store per
tolerance multiple, all candidates trained as one ensemble, and the largest
multiple whose trajectories stay within training randomness
(``band_verdict``), with its compression ratio.

Everything runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.tolerance import find_tolerance_batch
from repro_torch.core.variability import (BandVerdict, VariabilityBand,
                                          band_verdict, compute_band)
from repro_torch.data.loader import EnsembleLoader, ShardAwareLoader
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.kernels import zfp_codec
from repro_torch.metrics import psnr, total_mass, total_momentum
from repro_torch.models.folded import folded_forward
from repro_torch.models.surrogate import (SurrogateConfig, init_surrogate,
                                          member_params, stack_params)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace

TRAJECTORY_METRICS = ("l1", "psnr", "mass", "mom_x", "mom_y")

# core sits below train in the import order (train.checkpoint uses
# core.tolerance for certified checkpoints), so the trainer plumbing this
# module drives -- optimizer, batch sources, TrainConfig -- is imported inside
# the functions that need it.  ``TrainConfig`` and ``AdamConfig`` appear only
# in annotations (strings under ``from __future__ import annotations``).


# ---------------------------------------------------------------------------
# stacked ensemble: init / step / eval
# ---------------------------------------------------------------------------

def init_ensemble(model_cfg: SurrogateConfig, seeds: Sequence[int],
                  device: DeviceLike = None) -> dict:
    """Stacked parameters ``{name: (N, ...)}`` on ``device``; member m is
    ``init_surrogate(model_cfg, seeds[m])`` (one ``torch.Generator`` per
    seed)."""
    dev = resolve_device(device)
    return stack_params([init_surrogate(model_cfg, int(s), dev).state_dict()
                         for s in seeds])


def ensemble_train_step(params, opt_state, cond, target, cfg: SurrogateConfig,
                        opt_cfg: AdamConfig):
    """One step of all members: cond (N, B, cond_dim), target (N, B, H, W,
    F), stacked params and Adam state -> (params, opt_state, (N,) loss)."""
    from repro_torch.train.source import make_ensemble_update
    return make_ensemble_update(cfg, opt_cfg)(params, opt_state, cond, target)


@torch.no_grad()
def _eval_ensemble(params, cfg: SurrogateConfig, cond, targets) -> dict:
    """Per-member metrics on a fixed eval set, every member in one
    member-folded forward.

    Returns (N,) tensors: mean L1, mean per-sample-per-field PSNR, mean
    total mass and mean total momentum (x and y) of the predictions.
    """
    n = next(iter(params.values())).shape[0]
    pred = folded_forward(cfg, params, cond.expand(n, -1, -1))   # (N, B, H, W, F)
    mom = total_momentum(pred).mean(dim=1)
    return {"l1": (pred - targets).abs().flatten(1).mean(dim=1),
            "psnr": psnr(targets, pred, axis=(-3, -2)).flatten(1).mean(dim=1),
            "mass": total_mass(pred).mean(dim=1),
            "mom_x": mom[:, 0], "mom_y": mom[:, 1]}


# ---------------------------------------------------------------------------
# ensemble trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EnsembleResult:
    params: dict                            # stacked state dict, leading axis N
    losses: list                            # [(step, (N,) loss), ...]
    trajectories: dict                      # metric -> (N, n_evals)
    seeds: list
    seconds: float
    steps: int

    @property
    def num_members(self) -> int:
        return len(self.seeds)

    def member_params(self, m: int) -> dict:
        """Member ``m``'s state dict (loads into a ``Surrogate``)."""
        return member_params(self.params, m)


def train_ensemble(model_cfg: SurrogateConfig, train_cfg: TrainConfig,
                   conditions: np.ndarray, data: Union[object, Sequence],
                   seeds: Sequence[int],
                   eval_conditions=None, eval_targets=None,
                   eval_every: int = 1,
                   target_transform: Optional[Callable] = None,
                   params=None,
                   loader: Optional[EnsembleLoader] = None,
                   device: DeviceLike = None) -> EnsembleResult:
    """Train N seed models at once on ``device`` (the card unless
    ``device="cpu"``); returns an ``EnsembleResult``.

    ``data`` is ONE store shared by all members (the seed ensemble:
    identical data, per-seed init and shuffle) or a sequence of per-member
    stores (one lossy store per tolerance candidate in
    ``certify_tolerance``).  The stores must live on ``device``.

    With ``eval_conditions``/``eval_targets`` an eval runs at the end
    of every ``eval_every``-th epoch, and the per-member trajectories (l1,
    psnr, mass, mom_x, mom_y) stream into ``result.trajectories`` as (N,
    n_evals) arrays.  ``params`` is a stacked state dict (default
    :func:`init_ensemble`).  ``loader`` overrides the per-seed
    ``EnsembleLoader``.  Ensembles do not checkpoint.
    """
    from repro_torch.train.optimizer import AdamConfig, adam_init
    from repro_torch.train.source import (batch_stream, make_ensemble_source,
                                          make_fused_ensemble_step,
                                          make_host_ensemble_step, make_loader)
    if train_cfg.ckpt_dir is not None:
        raise ValueError("ensemble training does not checkpoint; "
                         "use train_surrogate for single runs")
    dev = resolve_device(device)
    seeds = [int(s) for s in seeds]
    per_member = isinstance(data, (list, tuple))
    if per_member and len(data) != len(seeds):
        raise ValueError(f"{len(data)} data sources for {len(seeds)} members")
    sources = list(data) if per_member else [data] * len(seeds)
    source = make_ensemble_source(data, conditions, target_transform)
    if not same_device(source.device, dev):
        raise ValueError(f"stores live on {source.device}, training was asked "
                         f"to run on {dev}")
    if loader is None:
        loader = EnsembleLoader([make_loader(src, train_cfg.batch_size, seed=s)
                                 for src, s in zip(sources, seeds)])
    elif loader.num_members != len(seeds):
        raise ValueError(f"loader has {loader.num_members} members for "
                         f"{len(seeds)} seeds")

    opt_cfg = AdamConfig(lr=train_cfg.lr)
    params = (init_ensemble(model_cfg, seeds, dev) if params is None else
              {k: torch.as_tensor(v).to(dev) for k, v in params.items()})
    opt_state = adam_init(params, opt_cfg)
    device_path = source.kind == "device"
    if device_path:
        step_fn = make_fused_ensemble_step(source, model_cfg, opt_cfg)
        prefetch = 0
    else:
        step_fn = make_host_ensemble_step(model_cfg, opt_cfg)
        prefetch = train_cfg.prefetch

    do_eval = eval_conditions is not None and eval_targets is not None
    if do_eval:
        eval_cond = torch.as_tensor(np.asarray(eval_conditions, np.float32)).to(dev)
        eval_tgt = torch.as_tensor(np.asarray(eval_targets, np.float32)).to(dev)
    # telemetry: the train loop's first-step split.  The first step (kernel
    # build, allocator growth, cuDNN's algorithm choice) is synced and
    # reported once (ensemble.compile_seconds) and kept out of
    # ensemble.dispatch_seconds: host seconds from the step function's call
    # to its return, no sync (the ensemble.dispatch span; the step's device
    # ranges carry its step).  A kernel library built after the first step
    # is flagged by the watcher
    reg = obs_metrics.get_registry()
    dispatch_hist = reg.histogram("ensemble.dispatch_seconds")
    watcher = torchprof.get_watcher()
    watcher.watch("ensemble.fused_step" if device_path else "ensemble.step",
                  zfp_codec.build)
    traj = {k: [] for k in TRAJECTORY_METRICS}
    spe = loader.steps_per_epoch
    losses = []
    step = 0
    t0 = time.time()
    stream = batch_stream(loader, source.fetch, train_cfg.epochs, prefetch)
    try:
        for _lstate, item in stream:
            rec = obs_trace.active()        # no span, nor its attributes, when off
            with obs_trace.NULL_SPAN if rec is None else rec.span(
                    "ensemble.dispatch", "ensemble", step=step + 1):
                t0s = time.perf_counter()
                params, opt_state, loss = step_fn(params, opt_state, item)
                dispatch_s = time.perf_counter() - t0s
            step += 1
            if step == 1:
                torchprof.block_until_ready(loss)
                compile_s = time.perf_counter() - t0s
                reg.gauge("ensemble.compile_seconds").set(compile_s)
                obs_trace.instant("ensemble.compile", cat="ensemble",
                                  members=len(seeds), seconds=compile_s)
                watcher.rebase()
            else:
                dispatch_hist.observe(dispatch_s)
            if step % train_cfg.log_every == 0:
                losses.append((step, loss.cpu().numpy()))
            if do_eval and step % spe == 0 and (step // spe) % eval_every == 0:
                with obs_trace.span("ensemble.eval", cat="ensemble",
                                    step=step, members=len(seeds)):
                    vals = _eval_ensemble(params, model_cfg, eval_cond, eval_tgt)
                for k in TRAJECTORY_METRICS:
                    traj[k].append(vals[k].cpu().numpy())
            if train_cfg.max_steps is not None and step >= train_cfg.max_steps:
                break
    finally:
        stream.close()
        reg.counter("ensemble.steps").add(step)
        watcher.check()
    trajectories = {k: np.stack(v, axis=1) for k, v in traj.items() if v}
    return EnsembleResult(params=params, losses=losses,
                          trajectories=trajectories, seeds=seeds,
                          seconds=time.time() - t0, steps=step)


# ---------------------------------------------------------------------------
# band artifact: persisted (JSON manifest + npz) seed-ensemble bands
# ---------------------------------------------------------------------------

BAND_FORMAT = "repro-band-v1"


@dataclasses.dataclass
class BandArtifact:
    """Per-seed metric trajectories + the bands derived from them.

    On disk (``save``/``load``), the JAX package's format:
      root/band.json  -- format tag, seeds, sigmas, metric shape table,
                         npz pointer, free-form meta
      root/bands.npz  -- traj_<metric> (N, T), mean_<metric>, std_<metric>
    """
    trajectories: dict                       # metric -> (n_models, T)
    seeds: list
    sigmas: float = 2.0
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def metrics(self) -> list:
        return sorted(self.trajectories)

    def band(self, metric: str) -> VariabilityBand:
        return compute_band(list(self.trajectories[metric]),
                            sigmas=self.sigmas)

    def verdict(self, metric: str, trajectory, frac_required: float = 0.9,
                dev_allowance: float = 1.5) -> BandVerdict:
        return band_verdict(self.band(metric),
                            list(self.trajectories[metric]), trajectory,
                            frac_required=frac_required,
                            dev_allowance=dev_allowance)

    def save(self, root: str) -> str:
        os.makedirs(root, exist_ok=True)
        arrays = {}
        for name, t in self.trajectories.items():
            b = self.band(name)
            arrays[f"traj_{name}"] = np.asarray(t)
            arrays[f"mean_{name}"] = np.asarray(b.mean)
            arrays[f"std_{name}"] = np.asarray(b.std)
        np.savez(os.path.join(root, "bands.npz"), **arrays)
        manifest = {
            "format": BAND_FORMAT,
            "seeds": [int(s) for s in self.seeds],
            "n_models": len(self.seeds),
            "sigmas": float(self.sigmas),
            "metrics": {k: list(np.asarray(v).shape)
                        for k, v in self.trajectories.items()},
            "npz": "bands.npz",
            "meta": self.meta,
        }
        path = os.path.join(root, "band.json")
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)
        return path

    @classmethod
    def load(cls, root: str) -> "BandArtifact":
        with open(os.path.join(root, "band.json")) as f:
            m = json.load(f)
        if m.get("format") != BAND_FORMAT:
            raise ValueError(f"unknown band artifact format {m.get('format')!r}")
        with np.load(os.path.join(root, m["npz"])) as z:
            trajectories = {k: np.array(z[f"traj_{k}"]) for k in m["metrics"]}
        return cls(trajectories=trajectories, seeds=m["seeds"],
                   sigmas=m["sigmas"], meta=m.get("meta", {}))


# ---------------------------------------------------------------------------
# certification: max benign tolerance via band containment
# ---------------------------------------------------------------------------

CERT_METRICS = ("mass", "mom_x", "mom_y", "psnr")


@dataclasses.dataclass
class CandidateVerdict:
    multiple: float                    # tolerance multiple of the Alg-1 base
    median_tolerance: float            # median per-sample L-inf tolerance
    ratio: float                       # achieved compression ratio
    benign: bool                       # benign on EVERY certified metric
    per_metric: dict                   # metric -> BandVerdict


@dataclasses.dataclass
class CertificationResult:
    model_l1_error: float              # e: Algorithm 1's model-error bound
    base_tolerances: np.ndarray        # (n_train,) per-sample Alg-1 tolerances
    candidates: list                   # CandidateVerdict, sorted by multiple
    band: BandArtifact                 # raw seed-ensemble bands
    ensemble_seconds: float            # raw N-seed training time
    sweep_seconds: float               # lossy candidates + verdicts time

    @property
    def max_benign(self) -> Optional[CandidateVerdict]:
        benign = [c for c in self.candidates if c.benign]
        return max(benign, key=lambda c: c.multiple) if benign else None

    def summary(self) -> dict:
        mb = self.max_benign
        return {
            "model_l1_error": self.model_l1_error,
            "candidates": [{
                "multiple": c.multiple, "ratio": c.ratio, "benign": c.benign,
                "median_tolerance": c.median_tolerance,
                "per_metric": {k: dataclasses.asdict(v)
                               for k, v in c.per_metric.items()},
            } for c in self.candidates],
            "max_benign_multiple": None if mb is None else mb.multiple,
            "max_benign_tolerance": None if mb is None else mb.median_tolerance,
            "max_benign_ratio": None if mb is None else mb.ratio,
            "ensemble_seconds": self.ensemble_seconds,
            "sweep_seconds": self.sweep_seconds,
        }


def _judge(band_art: BandArtifact, lossy_traj: dict, member: int,
           multiple: float, store, metrics, frac_required: float,
           dev_allowance: float) -> CandidateVerdict:
    per_metric = {}
    for name in metrics:
        per_metric[name] = band_art.verdict(
            name, lossy_traj[name][member],
            frac_required=frac_required, dev_allowance=dev_allowance)
    return CandidateVerdict(
        multiple=float(multiple),
        median_tolerance=float(np.median(store.tolerances)),
        ratio=float(store.ratio),
        benign=all(v.benign for v in per_metric.values()),
        per_metric=per_metric)


def certify_tolerance(model_cfg: SurrogateConfig, train_cfg: TrainConfig,
                      conditions: Optional[np.ndarray],
                      train_fields: Union[np.ndarray, str], *,
                      eval_conditions, eval_targets,
                      seeds: Sequence[int] = (0, 1, 2, 3),
                      multiples: Sequence[float] = (0.5, 1.0, 2.0, 4.0, 8.0,
                                                    16.0),
                      metrics: Sequence[str] = CERT_METRICS,
                      frac_required: float = 0.9, dev_allowance: float = 1.5,
                      sigmas: float = 2.0, shard_size: int = 32,
                      bisect_rounds: int = 0,
                      lossy_seed: Optional[int] = None,
                      device_resident: bool = False,
                      artifact_dir: Optional[str] = None,
                      device: DeviceLike = None) -> CertificationResult:
    """The paper's pipeline on ``device`` (the card unless
    ``device="cpu"``): seed ensemble -> Algorithm 1 -> lossy sweep -> max
    benign tolerance.

    ``train_fields``: (n_train, H, W, F) normalized channels-last training
    fields, with ``conditions`` (n_train, cond_dim); or a produced-dataset
    path (:func:`repro_torch.datagen.produce`), whose store is decoded
    batchwise on ``device``; ``conditions=None`` then rebuilds them from its
    provenance manifest.  The eval set supplies the trajectories the band
    verdict compares.

    Steps:
      1. the raw seed ensemble -> per-epoch trajectories -> BandArtifact;
      2. e = the members' mean eval L1 at the last epoch; per-sample
         Algorithm-1 tolerances for the whole training set
         (``find_tolerance_batch``);
      3. one store per tolerance multiple (``ShardedCompressedStore``, or
         with ``device_resident=True`` a ``DeviceResidentCompressedStore``
         with true per-block plane counts); all candidates train as one
         ensemble with per-member stores, on the same shard-aware batch
         order as the raw members;
      4. ``band_verdict`` per candidate on every certified metric; benign
         needs every metric within training randomness;
      5. optional geometric bisection between the largest benign and the
         smallest degraded multiple (``bisect_rounds`` single-member
         trainings).

    ``artifact_dir`` persists the band artifact and a certification.json.
    """
    from repro_torch.data.device_store import DeviceResidentCompressedStore
    from repro_torch.data.shards import ShardedCompressedStore
    from repro_torch.data.store import RawArrayStore, channels_last

    dev = resolve_device(device)
    if isinstance(train_fields, str):
        from repro_torch.datagen import produced_training_arrays
        conditions, train_fields = produced_training_arrays(
            train_fields, conditions, device=dev)
    elif conditions is None:
        raise ValueError("conditions=None is only valid when train_fields "
                         "is a produced-dataset path (conditions are then "
                         "rebuilt from its provenance manifest)")
    train_fields = np.asarray(train_fields, np.float32)
    n_train = len(train_fields)
    if lossy_seed is None:
        # retrain a band member's seed on the compressed data: as the
        # tolerance goes to zero the lossy run converges to that member, so
        # the verdict isolates compression effects from seed effects
        lossy_seed = int(seeds[0])

    # every run (raw members and lossy candidates) draws batches through the
    # same shard-aware layout, so two runs with the same seed consume the
    # same batch order
    def matched_loader(member_seeds):
        return EnsembleLoader([
            ShardAwareLoader(n_train, train_cfg.batch_size, shard_size,
                             seed=int(s)) for s in member_seeds])

    # 1) raw seed ensemble + bands
    raw_store = RawArrayStore(train_fields, device=dev)
    with obs_trace.span("certify.seed_ensemble", cat="certify",
                        members=len(seeds)):
        ens = train_ensemble(model_cfg, train_cfg, conditions, raw_store,
                             seeds, eval_conditions=eval_conditions,
                             eval_targets=eval_targets,
                             loader=matched_loader(seeds), device=dev)
    if not ens.trajectories:
        raise ValueError("certification needs per-epoch trajectories; "
                         "train for at least one full epoch")
    band_art = BandArtifact(
        trajectories=ens.trajectories, seeds=list(seeds), sigmas=sigmas,
        meta={"epochs": train_cfg.epochs, "batch_size": train_cfg.batch_size,
              "lr": train_cfg.lr, "n_train": n_train,
              "eval_samples": int(np.asarray(eval_targets).shape[0])})

    # 2) Algorithm 1: per-sample tolerances bounded by the model's own error
    e_model = float(ens.trajectories["l1"][:, -1].mean())
    samples_cf = np.ascontiguousarray(np.transpose(train_fields, (0, 3, 1, 2)))
    with obs_trace.span("certify.algorithm1", cat="certify",
                        samples=n_train, model_l1=e_model):
        base = find_tolerance_batch(samples_cf,
                                    np.full(n_train, e_model, np.float32),
                                    device=dev)

    def lossy_candidates(mults):
        with obs_trace.span("certify.build_stores", cat="certify",
                            candidates=len(mults),
                            backend="device" if device_resident else "host"):
            if device_resident:
                stores = [DeviceResidentCompressedStore.from_samples(
                    samples_cf, base.tolerance * m, shard_size=shard_size,
                    device=dev) for m in mults]
            else:
                stores = [ShardedCompressedStore(
                    samples_cf, tolerances=base.tolerance * m,
                    shard_size=shard_size, device=dev) for m in mults]
        with obs_trace.span("certify.lossy_sweep", cat="certify",
                            candidates=len(mults)):
            run = train_ensemble(
                model_cfg, dataclasses.replace(train_cfg, seed=lossy_seed),
                conditions, stores, [lossy_seed] * len(stores),
                eval_conditions=eval_conditions, eval_targets=eval_targets,
                target_transform=channels_last,
                loader=matched_loader([lossy_seed] * len(stores)), device=dev)
        verdicts = []
        for m, mult in enumerate(mults):
            with obs_trace.span("certify.judge", cat="certify",
                                multiple=float(mult)) as sp:
                v = _judge(band_art, run.trajectories, m, mult, stores[m],
                           metrics, frac_required, dev_allowance)
                sp.set(benign=v.benign, ratio=v.ratio)
            verdicts.append(v)
        return verdicts

    # 3+4) the sweep: every multiple trained in ONE ensemble
    t0 = time.time()
    candidates = lossy_candidates(list(multiples))

    # 5) geometric bisection on the benign/degraded edge
    for _ in range(bisect_rounds):
        ordered = sorted(candidates, key=lambda c: c.multiple)
        lo = max((c.multiple for c in ordered if c.benign), default=None)
        hi = min((c.multiple for c in ordered
                  if not c.benign and (lo is None or c.multiple > lo)),
                 default=None)
        if lo is None or hi is None or hi / lo < 1.1:
            break
        mid = float(np.sqrt(lo * hi))
        candidates += lossy_candidates([mid])

    candidates.sort(key=lambda c: c.multiple)
    result = CertificationResult(
        model_l1_error=e_model, base_tolerances=base.tolerance,
        candidates=candidates, band=band_art,
        ensemble_seconds=ens.seconds, sweep_seconds=time.time() - t0)

    if artifact_dir is not None:
        band_art.save(artifact_dir)
        with open(os.path.join(artifact_dir, "certification.json"), "w") as f:
            json.dump(result.summary(), f, indent=1)
    return result
