"""Surrogate training loop over any store of the port.

Counterpart of ``repro/train/loop.py``.  The ``BatchSource`` seam
(:mod:`repro_torch.train.source`) picks the backend per store:

  * host-streaming (``RawArrayStore``, ``CompressedArrayStore``,
    ``ShardedCompressedStore``): each batch is read on the host and decoded
    on the device, on a ``PrefetchLoader`` worker thread when
    ``TrainConfig.prefetch > 0`` so the read overlaps the step;
  * device-resident: each step ships only the (B,) index vector, and
    gather + fixed-accuracy decode + L1 + Adam run on the device
    (``prefetch`` is ignored; there is no host work to overlap).

Batches follow the loaders' ``(seed, epoch)`` order (shard-aware for
sharded stores), the same as the JAX package's.

Telemetry, with the JAX loop's names: the first step of a run pays the
kernel build, cuDNN's algorithm choice and the allocator's growth; it is
timed to a device sync and reported once (``train.compile_seconds`` gauge,
``train.compile`` instant).  The later steps are timed without a sync, so
their histogram is the host's dispatch, ``train.dispatch_seconds``; what
the device spends in each phase of a step is a device range of the
tracer (:mod:`repro_torch.train.source`).  Every step is a ``train.step``
span (its ``step`` is the one the step's device ranges carry), every
periodic save a ``train.checkpoint`` span; the summed wait for batches
goes to the ``train.fetch_wait_seconds`` counter.  The recompile watcher
(:mod:`repro_torch.obs.torchprof`) flags a kernel library built after the
first step.

Checkpoints and exact resume: with ``TrainConfig.ckpt_dir`` the loop saves
every ``ckpt_every_steps`` steps, and at the end unless the last step was
saved or the run stopped at ``max_steps`` (a simulated preemption), the
parameters and Adam state in the JAX package's layout
(:func:`~repro_torch.models.surrogate.params_to_jax`) with the loader state
(epoch, step_in_epoch, seed) in the manifest.  A run started on a directory
that holds a checkpoint resumes from it: the same batches, in the same
order, at the same global steps as an uninterrupted run, so final
parameters and the post-resume loss history are bit-identical to it
(where the device's kernels are deterministic).  Either package resumes
from the other's checkpoints.  Lossy checkpoints
(``lossy_ckpt_bits``, ``ckpt_codec``) encode on the device; a
fixed-accuracy codec without a default tolerance certifies per-leaf
tolerances at each save from the last step's displacement.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.loader import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.kernels import ln_lrelu, zfp_codec
from repro_torch.models.surrogate import (Surrogate, SurrogateConfig,
                                          adam_state_from_jax, adam_state_to_jax,
                                          init_surrogate, params_from_jax,
                                          params_to_jax)
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig, adam_init
from repro_torch.train.source import (batch_stream, make_batch_source,
                                      make_fused_step, make_host_step,
                                      make_loader)


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 40
    batch_size: int = 64
    lr: float = 1e-4
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every_steps: int = 200
    ckpt_keep: int = 3
    lossy_ckpt_bits: Optional[int] = None
    # any codec of the port (repro_torch.compression.get_codec(...)); takes
    # precedence over lossy_ckpt_bits.  A fixed-accuracy codec with no
    # default tolerance certifies per-leaf tolerances at each save
    # (Algorithm 1 on the parameters, the last step's displacement as bound).
    ckpt_codec: Optional[object] = None
    log_every: int = 50
    max_steps: Optional[int] = None  # simulated preemption: stop, no final save
    prefetch: int = 2                # queue depth; 0 = synchronous fetch


def _needs_certify(train_cfg: TrainConfig) -> bool:
    codec = train_cfg.ckpt_codec
    return (codec is not None
            and getattr(codec, "tolerance", 0) is None
            and codec.name.startswith("fixed_accuracy"))


def _save(train_cfg: TrainConfig, step: int, params, opt_state,
          loader_state: dict, params_prev=None) -> None:
    """Checkpoint ``params`` (a state dict) and ``opt_state`` in the JAX
    layout; certified per-leaf tolerances come from ``params_prev``."""
    codec = train_cfg.ckpt_codec
    lossy_bits = None if codec is not None else train_cfg.lossy_ckpt_bits
    jparams = params_to_jax(params)
    tolerances = None
    if _needs_certify(train_cfg) and params_prev is not None:
        tolerances = {"params": ckpt.certify_param_tolerances(
            params_to_jax(params_prev), jparams)}
    ckpt.save_checkpoint(
        train_cfg.ckpt_dir, step,
        {"params": jparams, "opt": adam_state_to_jax(opt_state)},
        extra={"loader": dict(loader_state),
               "epoch": loader_state["epoch"],
               "seed": loader_state["seed"]},
        lossy_bits=lossy_bits, codec=codec, tolerances=tolerances,
        keep=train_cfg.ckpt_keep)


def _resume(train_cfg: TrainConfig, model: Surrogate, opt_state, loader):
    """Load the newest checkpoint of ``train_cfg.ckpt_dir`` into ``model``,
    the Adam state and ``loader``; returns (opt_state, step), step 0 when
    there is none."""
    latest = ckpt.latest_checkpoint(train_cfg.ckpt_dir)
    if not latest:
        return opt_state, 0
    params = {n: p.detach() for n, p in model.named_parameters()}
    state, meta = ckpt.restore_checkpoint(
        latest, {"params": params_to_jax(params),
                 "opt": adam_state_to_jax(opt_state)})
    restored = params_from_jax(state["params"])
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(restored[n])
    lstate = meta["extra"].get("loader")
    if lstate is None:          # pre-loader manifest: epoch granularity
        lstate = {"epoch": meta["extra"].get("epoch", 0),
                  "step_in_epoch": 0, "seed": loader.seed}
    loader.restore(lstate)
    return adam_state_from_jax(state["opt"]), meta["step"]


def train_surrogate(model_cfg: SurrogateConfig, train_cfg: TrainConfig,
                    conditions: np.ndarray, data,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    hooks: Sequence[Callable] = (),
                    target_transform: Optional[Callable] = None,
                    loader: Optional[ShardedLoader] = None,
                    device: DeviceLike = None):
    """Train; returns (model, loss_history of (step, loss) pairs).

    ``data`` is an ``ArrayStore`` of the port whose batches come back on
    ``device`` (the card unless ``device="cpu"``), or a produced-dataset
    path from :func:`repro_torch.datagen.produce` (opened with
    ``resolve_store`` on ``device``; produced stores are channels-first, so
    pass ``target_transform=channels_last`` and conditions from
    ``repro_torch.datagen.scenario_conditions``).  ``params`` is an
    optional state dict, e.g. from
    :func:`repro_torch.models.surrogate.params_from_jax`; otherwise the
    model is initialised from ``train_cfg.seed``.  A checkpoint in
    ``train_cfg.ckpt_dir`` takes precedence over both, and the loss
    history then holds the steps after it.  Each hook is called as
    ``hook(step, model, loss)`` after every step.  ``loader`` overrides the
    one built from the store and ``train_cfg.seed``, e.g. one member loader
    of an ensemble's ``EnsembleLoader``, so that a single run draws that
    member's batches.
    """
    dev = resolve_device(device)
    if isinstance(data, str):
        from repro_torch.datagen import resolve_store
        data = resolve_store(data, device=dev)
    source = make_batch_source(data, conditions, target_transform)
    if not same_device(source.device, dev):
        raise ValueError(f"store lives on {source.device}, training "
                         f"was asked to run on {dev}")
    model = init_surrogate(model_cfg, train_cfg.seed, dev)
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    opt_cfg = AdamConfig(lr=train_cfg.lr)
    opt_state = adam_init(dict(model.named_parameters()), opt_cfg)
    if loader is None:
        loader = make_loader(data, train_cfg.batch_size, train_cfg.seed)
    step = 0
    if train_cfg.ckpt_dir:
        opt_state, step = _resume(train_cfg, model, opt_state, loader)
    if train_cfg.max_steps is not None and step >= train_cfg.max_steps:
        return model, []                # already at the preemption point
    if source.kind == "device":
        train_step = make_fused_step(source, model, opt_cfg)
        prefetch = 0
    else:
        train_step = make_host_step(model, opt_cfg)
        prefetch = train_cfg.prefetch

    # views of the parameters, which the step updates in place: a certified
    # save's pre-step parameters are copied into buffers before each step
    live = {n: p.detach() for n, p in model.named_parameters()}
    params_prev = None
    if train_cfg.ckpt_dir and _needs_certify(train_cfg):
        params_prev = {n: torch.empty_like(p) for n, p in live.items()}

    reg = get_registry()
    fetch_wait = reg.counter("train.fetch_wait_seconds")
    dispatch_hist = reg.histogram("train.dispatch_seconds")
    watcher = torchprof.get_watcher()
    watcher.watch("train.fused_step" if source.kind == "device" else "train.step",
                  zfp_codec.build)
    watcher.watch("train.ln_lrelu", ln_lrelu.build)
    first_in_run = True
    start_step = step
    losses = []
    # the loader position to store in the next checkpoint: with prefetch
    # the live loader runs ahead, so each batch carries its own snapshot
    last_state = dict(loader.state())
    saved_step = -1
    stream = batch_stream(loader, source.fetch, train_cfg.epochs, prefetch)
    try:
        t_iter = time.perf_counter()
        for lstate, item in stream:
            fetch_wait.add(time.perf_counter() - t_iter)
            if params_prev is not None:
                torch._foreach_copy_(list(params_prev.values()),
                                     list(live.values()))
            # the histogram keeps its own clock pair: it is fed with
            # recording off too, when no span is opened
            rec = obs_trace.active()
            with obs_trace.NULL_SPAN if rec is None else rec.span(
                    "train.step", "train", step=step + 1):
                t0s = time.perf_counter()
                opt_state, loss = train_step(opt_state, item)
                if first_in_run:
                    torchprof.block_until_ready(loss)
                dur = time.perf_counter() - t0s
            step += 1
            if first_in_run:
                first_in_run = False
                reg.gauge("train.compile_seconds").set(dur)
                obs_trace.instant("train.compile", cat="train", step=step,
                                  seconds=dur)
                watcher.rebase()        # first-step builds are expected
            else:
                dispatch_hist.observe(dur)
            last_state = lstate
            if step % train_cfg.log_every == 0:
                losses.append((step, float(loss)))
            for h in hooks:
                h(step, model, loss)
            if train_cfg.ckpt_dir and step % train_cfg.ckpt_every_steps == 0:
                with obs_trace.span("train.checkpoint", cat="train", step=step):
                    _save(train_cfg, step, live, opt_state, last_state,
                          params_prev)
                saved_step = step
            if train_cfg.max_steps is not None and step >= train_cfg.max_steps:
                return model, losses    # preempted: no final save
            t_iter = time.perf_counter()
    finally:
        stream.close()
        reg.counter("train.steps").add(step - start_step)
        watcher.check()     # flags (event + counter) steady-state rebuilds
    if train_cfg.ckpt_dir and step != saved_step:
        _save(train_cfg, step, live, opt_state, last_state, params_prev)
    return model, losses


@torch.no_grad()
def predict_fields(model: Surrogate, conditions, batch: int = 256,
                   device: DeviceLike = None) -> np.ndarray:
    """Predict (N, H, W, fields) for (N, cond_dim) conditions on ``device``
    (the card unless ``device="cpu"``); the model must live there."""
    dev = resolve_device(device)
    p_dev = next(model.parameters()).device
    if not same_device(p_dev, dev):
        raise ValueError(f"model lives on {p_dev}, prediction was asked to "
                         f"run on {dev}")
    conditions = np.asarray(conditions, np.float32)
    outs = []
    for i in range(0, len(conditions), batch):
        c = torch.from_numpy(conditions[i:i + batch]).to(dev)
        outs.append(model(c).cpu().numpy())
    return np.concatenate(outs)
