"""BatchSource seam: device-resident stores feed one fused train step.

Counterpart of the device-resident half of ``repro/train/source.py``.  A
``DeviceResidentCompressedStore`` holds the whole compressed dataset on the
device, so a fetch is the (B,) index upload and the step runs gather ->
fixed-accuracy decode -> layout transform -> L1 -> backward -> Adam on the
device.  Host-streaming stores, the prefetch worker and the ensemble
sources wait for later slices (ROADMAP Queue 1 items 3 and 6).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.device_store import DeviceResidentCompressedStore
from repro_torch.data.loader import ShardedLoader
from repro_torch.models.surrogate import Surrogate, l1_loss
from repro_torch.train.optimizer import AdamConfig, AdamState, adam_update


def make_loader(data, batch_size: int, seed: int) -> ShardedLoader:
    """Loader over the store's samples (flat ``ShardedLoader`` order)."""
    return ShardedLoader(data.num_samples, batch_size, seed=seed)


def batch_stream(loader: ShardedLoader, fetch: Callable,
                 epochs: Optional[int]) -> Iterator:
    """Yield ``(loader_state_at_draw, fetch(idx))`` for every batch,
    synchronously (the prefetch worker waits for the host-streaming port)."""
    for idx in loader.iter_epochs(epochs):
        yield dict(loader.state()), fetch(idx)


class DeviceResidentSource:
    """Indices-only fetch; gather + decode run inside the fused step."""

    def __init__(self, store: DeviceResidentCompressedStore, conditions,
                 target_transform: Optional[Callable] = None):
        self.store = store
        self.conditions = torch.as_tensor(np.asarray(conditions, np.float32)
                                          ).to(store.device)
        self.transform = target_transform

    def fetch(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx), dtype=torch.int64
                               ).to(self.store.device)

    def gather(self, idx: torch.Tensor):
        """(conditions, decoded targets) of one batch of device indices."""
        tgt = self.store.decode_indices(idx)
        if self.transform is not None:
            tgt = self.transform(tgt)
        return self.conditions[idx], tgt


def make_batch_source(data, conditions,
                      target_transform=None) -> DeviceResidentSource:
    """Source matched to the store type.  Only device-resident stores are
    ported; other stores raise and name the slice that brings them."""
    if isinstance(data, DeviceResidentCompressedStore):
        return DeviceResidentSource(data, conditions, target_transform)
    raise NotImplementedError(
        f"{type(data).__name__} is not supported yet: host-streaming and "
        "sharded stores come with ROADMAP Queue 1 item 3; build a "
        "DeviceResidentCompressedStore")


def make_fused_step(source: DeviceResidentSource, model: Surrogate,
                    opt_cfg: AdamConfig) -> Callable:
    """One train step on the device: payload gather -> kernel decode ->
    loss/grad -> Adam.  ``step(opt_state, idx) -> (opt_state, loss)``;
    the model's parameters are replaced in place by the updated ones."""
    names = [n for n, _ in model.named_parameters()]

    def step(opt_state: AdamState, idx: torch.Tensor):
        cond, target = source.gather(idx)
        model.zero_grad(set_to_none=True)
        loss = l1_loss(model, cond, target)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {n: params[n].grad for n in names}
        new, opt_state = adam_update(grads, opt_state,
                                     {n: params[n].detach() for n in names},
                                     opt_cfg)
        with torch.no_grad():
            for n in names:
                params[n].copy_(new[n])
        return opt_state, loss.detach()

    return step
