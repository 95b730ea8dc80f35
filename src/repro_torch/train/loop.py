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
sharded stores), the same as the JAX package's.  The summed wait for
batches goes to the ``train.fetch_wait_seconds`` counter of the metrics
registry.  Checkpointing waits for ROADMAP Queue 1 item 8 and telemetry
spans for item 9.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.loader import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.models.surrogate import Surrogate, SurrogateConfig, init_surrogate
from repro_torch.obs.metrics import get_registry
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
    ckpt_dir: Optional[str] = None   # not ported: must stay None
    log_every: int = 50
    max_steps: Optional[int] = None  # stop after this many steps
    prefetch: int = 2                # queue depth; 0 = synchronous fetch


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
    model is initialised from ``train_cfg.seed``.  Each hook is called as
    ``hook(step, model, loss)`` after every step.  ``loader`` overrides the
    one built from the store and ``train_cfg.seed``, e.g. one member loader
    of an ensemble's ``EnsembleLoader``, so that a single run draws that
    member's batches.
    """
    if train_cfg.ckpt_dir:
        raise NotImplementedError("checkpointing is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
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
    if source.kind == "device":
        train_step = make_fused_step(source, model, opt_cfg)
        prefetch = 0
    else:
        train_step = make_host_step(model, opt_cfg)
        prefetch = train_cfg.prefetch

    fetch_wait = get_registry().counter("train.fetch_wait_seconds")
    losses = []
    step = 0
    stream = batch_stream(loader, source.fetch, train_cfg.epochs, prefetch)
    try:
        t_iter = time.perf_counter()
        for _, item in stream:
            fetch_wait.add(time.perf_counter() - t_iter)
            opt_state, loss = train_step(opt_state, item)
            step += 1
            if step % train_cfg.log_every == 0:
                losses.append((step, float(loss)))
            for h in hooks:
                h(step, model, loss)
            if train_cfg.max_steps is not None and step >= train_cfg.max_steps:
                break
            t_iter = time.perf_counter()
    finally:
        stream.close()
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
