"""BatchSource seam: the link between loaders and the train step.

Counterpart of the single-model half of ``repro/train/source.py``.  Two
backends, picked per store by :func:`make_batch_source`:

  * **host-streaming** -- any ``ArrayStore`` of the port (raw, per-sample
    compressed, sharded): each batch is read on the host and decoded on
    the store's device by one kernel call, optionally on a
    ``PrefetchLoader`` worker thread that overlaps the train step;
  * **device-resident** -- a ``DeviceResidentCompressedStore``: the whole
    compressed dataset lives on the device, so a fetch is the (B,) index
    upload and gather -> decode -> L1 -> backward -> Adam run in the step.

Both steps share one update (:func:`make_update`), so they cannot drift.
The ensemble sources wait for ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.data.device_store import DeviceResidentCompressedStore
from repro_torch.data.loader import PrefetchLoader, ShardAwareLoader, ShardedLoader
from repro_torch.data.store import ArrayStore, on_device, upload
from repro_torch.models.surrogate import Surrogate, l1_loss
from repro_torch.train.optimizer import AdamConfig, AdamState, adam_update


# ---------------------------------------------------------------------------
# shared building blocks (getter / loader / stream assembly)
# ---------------------------------------------------------------------------

def make_getter(data, target_transform: Optional[Callable] = None) -> Callable:
    """Batch getter of an ``ArrayStore``, optionally post-processed by
    ``target_transform``."""
    get = data.get_batch
    if target_transform is not None:
        get = (lambda base: lambda idx: target_transform(base(idx)))(get)
    return get


def make_loader(data, batch_size: int, seed: int) -> ShardedLoader:
    """Loader matched to a data source: shard-aware for sharded stores
    (including device-resident uploads of them, so batch order stays
    interchangeable across backends), plain ``ShardedLoader`` otherwise."""
    if getattr(data, "shard_size", None):  # align batches with shard layout
        return ShardAwareLoader.for_store(data, batch_size, seed=seed)
    return ShardedLoader(data.num_samples, batch_size, seed=seed)


def batch_stream(loader, fetch: Callable, epochs: Optional[int],
                 prefetch: int):
    """Yield ``(loader_state_at_draw, fetch(idx))`` for every batch.

    Snapshots the loader state when each batch is drawn (with prefetch the
    live loader runs ahead of consumption) and, when ``prefetch > 0``, runs
    ``fetch`` on a ``PrefetchLoader`` worker thread so host read + decode
    overlaps the train step.  The generator's ``close()`` shuts the worker
    down, so abandoning iteration never leaks the thread.
    """
    def _snapshots():
        for idx in loader.iter_epochs(epochs):
            yield dict(loader.state()), idx

    def _fetch(item):
        lstate, idx = item
        return lstate, fetch(idx)

    if prefetch > 0:
        pl = PrefetchLoader(_snapshots(), _fetch, depth=prefetch)
        try:
            yield from pl
        finally:
            pl.close()
    else:
        yield from map(_fetch, _snapshots())


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

class HostStreamSource:
    """Host read + decode per batch on the store's device; ``fetch``
    returns the finished ``(cond, target)`` tensors there."""
    kind = "host"

    def __init__(self, data, conditions, target_transform=None):
        self.data = data
        self.device = data.device
        self.conditions = np.asarray(conditions, np.float32)
        self._get = make_getter(data, target_transform)

    def fetch(self, idx: np.ndarray):
        cond, _ = on_device(self.device, lambda: upload(
            self.device, self.conditions[np.asarray(idx)])[0])
        return cond, self._get(idx)


class DeviceResidentSource:
    """Indices-only fetch; gather + decode run inside the fused step."""
    kind = "device"

    def __init__(self, store: DeviceResidentCompressedStore, conditions,
                 target_transform: Optional[Callable] = None):
        self.store = store
        self.device = store.device
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


def make_batch_source(data, conditions, target_transform=None):
    """Source matched to the store type: device-resident stores get the
    in-step decode, every other ``ArrayStore`` streams from the host."""
    if isinstance(data, DeviceResidentCompressedStore):
        return DeviceResidentSource(data, conditions, target_transform)
    if isinstance(data, ArrayStore):
        return HostStreamSource(data, conditions, target_transform)
    raise TypeError(f"{type(data).__name__} is not an ArrayStore of the port "
                    "(get_batch, stats, device, ...); wrap the samples in a "
                    "RawArrayStore")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_update(model: Surrogate, opt_cfg: AdamConfig) -> Callable:
    """``update(opt_state, cond, target) -> (opt_state, loss)``: L1 ->
    backward -> Adam; the model's parameters are replaced in place by the
    updated ones."""
    names = [n for n, _ in model.named_parameters()]

    def update(opt_state: AdamState, cond, target):
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

    return update


def make_fused_step(source: DeviceResidentSource, model: Surrogate,
                    opt_cfg: AdamConfig) -> Callable:
    """One train step on the device: payload gather -> kernel decode ->
    loss/grad -> Adam.  ``step(opt_state, idx) -> (opt_state, loss)``."""
    update = make_update(model, opt_cfg)

    def step(opt_state: AdamState, idx: torch.Tensor):
        return update(opt_state, *source.gather(idx))

    return step


def make_host_step(model: Surrogate, opt_cfg: AdamConfig) -> Callable:
    """One train step on a fetched batch: ``step(opt_state, (cond,
    target)) -> (opt_state, loss)``.  On the card the batch was built on
    another stream (possibly another thread's): recording it on this
    thread's stream keeps its memory from reuse until the step is done."""
    update = make_update(model, opt_cfg)

    def step(opt_state: AdamState, item):
        cond, target = item
        if target.is_cuda:
            stream = torch.cuda.current_stream(target.device)
            cond.record_stream(stream)
            target.record_stream(stream)
        return update(opt_state, cond, target)

    return step
