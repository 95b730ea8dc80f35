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
Each phase of a step is a device range of the tracer (``train.gather_decode``
in the fused step, ``train.forward``, ``train.backward``,
``train.optimizer``; ``ensemble.gather_decode``, ``ensemble.grad``,
``ensemble.optimizer`` in the ensemble's), recorded when a tracer is
configured or a ``torch.profiler`` capture runs.

The seed ensemble has the same two backends (:func:`make_ensemble_source`)
and one update for all members (:func:`make_ensemble_update`): the
gradient of every member's L1 loss through one member-folded forward
(the members' channels grouped in one channels-last batch,
``models/folded.py``), then Adam on the stacked parameters.  The gather +
decode of every member's batch is one launch of the gathered decode for
all members.  On the card the device-resident ensemble step replays CUDA
graphs of its three phases from its second call on
(:class:`GraphedEnsembleStep`): the host launches three graphs a step
instead of about a thousand kernels.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.device_store import DeviceResidentCompressedStore
from repro_torch.data.loader import PrefetchLoader, ShardAwareLoader, ShardedLoader
from repro_torch.data.store import ArrayStore, on_device, upload
from repro_torch.device import same_device
from repro_torch.kernels import zfp_codec
from repro_torch.models.folded import folded_forward
from repro_torch.models.surrogate import (Surrogate, SurrogateConfig,
                                          functional_l1_loss, l1_loss)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.torchprof import named_scope
from repro_torch.obs.trace import device_range
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
        # spans land on whichever thread runs the fetch -- the PrefetchLoader
        # worker when prefetch > 0 -- so host read/decode shows up on its own
        # Perfetto track, overlapping the main thread's train.step spans
        lstate, idx = item
        with obs_trace.span("train.fetch", cat="train"):
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
        with named_scope("gather_decode"):
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
    dev = next(model.parameters()).device

    def update(opt_state: AdamState, cond, target):
        model.zero_grad(set_to_none=True)
        with device_range("train.forward", dev):
            loss = l1_loss(model, cond, target)
        with device_range("train.backward", dev):
            loss.backward()
        with device_range("train.optimizer", dev):
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
        with device_range("train.gather_decode", source.device):
            cond, target = source.gather(idx)
        with named_scope("train_update"):
            return update(opt_state, cond, target)

    return step


def make_host_step(model: Surrogate, opt_cfg: AdamConfig) -> Callable:
    """One train step on a fetched batch: ``step(opt_state, (cond,
    target)) -> (opt_state, loss)``.  On the card the batch was built on
    another stream (possibly another thread's): recording it on this
    thread's stream keeps its memory from reuse until the step is done."""
    update = make_update(model, opt_cfg)

    def step(opt_state: AdamState, item):
        cond, target = item
        _record_on_current_stream(cond, target)
        return update(opt_state, cond, target)

    return step


def _record_on_current_stream(*ts: torch.Tensor) -> None:
    """A batch built on another stream (possibly another thread's): keep
    its memory from reuse until this thread's stream is done with it."""
    for t in ts:
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))


# ---------------------------------------------------------------------------
# ensemble sources
# ---------------------------------------------------------------------------

def _common_device(stores) -> torch.device:
    dev = stores[0].device
    if not all(same_device(s.device, dev) for s in stores):
        raise ValueError("ensemble stores must live on one device; got "
                         f"{sorted({str(s.device) for s in stores})}")
    return dev


class HostEnsembleSource:
    """Union fetch (one shared store) or per-member fetch, on the host.

    For a shared store each step fetches the union of the members' index
    batches once (``np.unique``: one read and one decode) and scatters it
    back per member, so the data path stays one ``get_batch`` a step
    whatever the member count.  Per-member stores (one lossy store per
    tolerance candidate) are read once per member.  ``fetch`` returns
    ``(cond (N, B, cond_dim), target (N, B, ...))`` on the stores' device.
    """
    kind = "host"

    def __init__(self, sources: Sequence, conditions, target_transform=None,
                 per_member: bool = False):
        self.device = _common_device(list(sources))
        self.conditions = np.asarray(conditions, np.float32)
        self.per_member = per_member
        self._getters = [make_getter(s, target_transform) for s in sources]

    def fetch(self, idx_stack: np.ndarray):
        idx_stack = np.asarray(idx_stack)
        cond, _ = on_device(self.device, lambda: upload(
            self.device, self.conditions[idx_stack])[0])
        if self.per_member:
            parts = [g(idx_stack[m]) for m, g in enumerate(self._getters)]
            target, _ = on_device(self.device, lambda: torch.stack(parts))
            return cond, target
        uniq, inv = np.unique(idx_stack, return_inverse=True)
        batch = self._getters[0](uniq)
        target, _ = on_device(self.device, lambda: batch[upload(
            self.device, inv.reshape(idx_stack.shape))[0]])
        return cond, target


class DeviceEnsembleSource:
    """All members' batches from resident payloads, in one gathered decode.

    Shared store: every member gathers its own indices from the same
    resident arrays, flattened to one ``(N * B,)`` index vector.  Per-member
    stores (one lossy store per tolerance candidate): their payloads are
    padded to a common width and stacked ``(M, S, nb, W)`` once, viewed as
    one store of ``M * S`` samples, and member ``m``'s indices are offset by
    ``m * S``.  Either way one launch decodes the whole step's data.
    """
    kind = "device"

    def __init__(self, stores, conditions, target_transform=None,
                 per_member: bool = False):
        stores = list(stores) if per_member else [stores]
        self.device = _common_device(stores)
        geometry = {(s.shape, s.padded_shape, s.nb, s.num_samples) for s in stores}
        if len(geometry) != 1:
            raise ValueError("per-member device stores must agree on sample "
                             f"geometry; got {sorted(map(str, geometry))}")
        self.transform = target_transform
        self.conditions = torch.as_tensor(np.asarray(conditions, np.float32)
                                          ).to(self.device)
        if per_member:
            wmax = max(int(s.payload.shape[-1]) for s in stores)
            m, n, nb = len(stores), stores[0].num_samples, stores[0].nb
            payload = torch.stack([torch.nn.functional.pad(
                s.payload, (0, wmax - s.payload.shape[-1])) for s in stores])
            self.store = DeviceResidentCompressedStore(
                payload.reshape(m * n, nb, wmax),
                torch.stack([s.emax for s in stores]).reshape(m * n, nb),
                torch.stack([s.nplanes for s in stores]).reshape(m * n, nb),
                stores[0].shape, stores[0].padded_shape,
                np.concatenate([s.tolerances for s in stores]),
                np.concatenate([s.logical_bytes_per for s in stores]))
            self.offsets = torch.arange(m, device=self.device)[:, None] * n
        else:
            self.store = stores[0]
            self.offsets = None

    def fetch(self, idx_stack: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idx_stack), dtype=torch.int64
                               ).to(self.device)

    def gather(self, idx: torch.Tensor):
        """(conditions (N, B, cond_dim), decoded targets (N, B, ...)) of one
        step's (N, B) device indices; one decode launch for all members."""
        flat = idx if self.offsets is None else idx + self.offsets
        with named_scope("gather_decode"):
            tgt = self.store.decode_indices(flat.reshape(-1))
            if self.transform is not None:
                tgt = self.transform(tgt)
            return self.conditions[idx], tgt.reshape(idx.shape + tgt.shape[1:])


def make_ensemble_source(data, conditions, target_transform=None):
    """Ensemble source of one shared store or a per-member sequence of
    stores; device-resident when every store is, and mixing the two
    raises."""
    per_member = isinstance(data, (list, tuple))
    stores = list(data) if per_member else [data]
    if all(isinstance(s, DeviceResidentCompressedStore) for s in stores):
        return DeviceEnsembleSource(data, conditions, target_transform,
                                    per_member=per_member)
    if any(isinstance(s, DeviceResidentCompressedStore) for s in stores):
        raise ValueError("cannot mix device-resident and host-streaming "
                         "stores in one ensemble")
    for s in stores:
        if not isinstance(s, ArrayStore):
            raise TypeError(f"{type(s).__name__} is not an ArrayStore of the port")
    return HostEnsembleSource(stores, conditions, target_transform,
                              per_member=per_member)


# ---------------------------------------------------------------------------
# ensemble steps
# ---------------------------------------------------------------------------

# identity readout of one member's prediction, the model of its loss
_READOUT = torch.nn.Identity()


def ensemble_grad(cfg: SurrogateConfig) -> Callable:
    """``grad(params, cond, target) -> (grads, (N,) loss)`` for stacked
    parameters ``{name: (N, ...)}`` of ``cfg``, cond (N, B, cond_dim),
    target (N, B, H, W, F).

    One member-folded forward runs every member
    (:func:`repro_torch.models.folded.folded_forward`: grouped convolutions
    on channels-last activations); each member's L1 mean is
    ``functional_l1_loss`` of an identity readout of its (B, H, W, F)
    prediction; autograd of their sum gives each member its own gradient,
    returned as contiguous stacks."""
    def grad(params, cond, target):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            pred = folded_forward(cfg, leaves, cond)
            loss = torch.stack([functional_l1_loss(_READOUT, {}, p, t)
                                for p, t in zip(pred, target)])
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return ({k: g.contiguous() for k, g in zip(leaves, grads)},
                loss.detach())

    return grad


def make_ensemble_update(cfg: SurrogateConfig, opt_cfg: AdamConfig) -> Callable:
    """``update(params, opt_state, cond, target) -> (params, opt_state,
    loss)``: :func:`ensemble_grad`, then one Adam update of the stacks.
    Returns the (N,) losses."""
    grad_and_loss = ensemble_grad(cfg)

    def update(params, opt_state: AdamState, cond, target):
        with device_range("ensemble.grad", cond.device):
            grads, loss = grad_and_loss(params, cond, target)
        with device_range("ensemble.optimizer", cond.device):
            params, opt_state = adam_update(grads, opt_state, params, opt_cfg,
                                            stacked=True)
        return params, opt_state, loss.detach()

    return update


def make_fused_ensemble_step(source: DeviceEnsembleSource, cfg: SurrogateConfig,
                             opt_cfg: AdamConfig) -> Callable:
    """One step of every member on the device: the gathered decode of all
    members' batches, then the member-folded update.
    ``step(params, opt_state, idx (N, B)) -> (params, opt_state, loss)``.
    On the card the step replays CUDA graphs from its second call on
    (:class:`GraphedEnsembleStep`); elsewhere it runs eagerly."""
    if source.device.type == "cuda":
        return GraphedEnsembleStep(source, cfg, opt_cfg)
    return _eager_fused_ensemble_step(source, make_ensemble_update(cfg, opt_cfg))


def _eager_fused_ensemble_step(source: DeviceEnsembleSource,
                               update: Callable) -> Callable:
    def step(params, opt_state, idx: torch.Tensor):
        with device_range("ensemble.gather_decode", source.device):
            cond, target = source.gather(idx)
        return update(params, opt_state, cond, target)

    return step


class GraphedEnsembleStep:
    """The fused ensemble step replayed from CUDA graphs.

    The first call runs eagerly (cuDNN's plans and the kernel builds happen
    there), and its outputs become the step's static buffers: the stacked
    parameters, Adam's moments and step count, beside an (N, B) index
    buffer into which each later call's indices are copied on the device.
    The second call captures the step as three graphs in one memory pool,
    one a stage: the gathered decode (:meth:`gather`), the member-folded
    gradient (:meth:`grad`) and Adam on the stacks, written into
    the buffers in place (:meth:`optimize`); it and every later call replay
    them, each inside the device range its eager phase has.  The span
    ``ensemble.capture`` holds the capture and the graphs' instantiation,
    ``ensemble.replay`` a call's three replays; the registry counts
    ``ensemble.graph_captures`` and ``ensemble.graph_replays``.  A capture
    that fails raises.

    A call returns the buffers themselves: the caller's first tensors are
    never written, and any but the step's own last outputs are copied in.
    The returned loss is rewritten by the next call.
    """
    STAGES = (("ensemble.gather_decode", "gather"), ("ensemble.grad", "grad"),
              ("ensemble.optimizer", "optimize"))

    def __init__(self, source: DeviceEnsembleSource, cfg: SurrogateConfig,
                 opt_cfg: AdamConfig):
        self.source, self.opt_cfg = source, opt_cfg
        self._grad = ensemble_grad(cfg)
        self._eager = _eager_fused_ensemble_step(source,
                                                 make_ensemble_update(cfg, opt_cfg))
        self.idx = self.params = self.opt_state = None
        self.cond = self.target = self.grads = self.loss = None
        self.graphs = None
        self._launches: dict = {}
        reg = obs_metrics.get_registry()
        self._captures = reg.counter("ensemble.graph_captures")
        self._replays = reg.counter("ensemble.graph_replays")

    # -- the stages, on the buffers: what each graph captures ---------------

    def gather(self) -> None:
        self.cond, self.target = self.source.gather(self.idx)

    def grad(self) -> None:
        self.grads, self.loss = self._grad(self.params, self.cond, self.target)

    def optimize(self) -> None:
        adam_update(self.grads, self.opt_state, self.params, self.opt_cfg,
                    stacked=True, inplace=True)

    # -- the step -------------------------------------------------------------

    def load(self, params, opt_state: AdamState, idx: torch.Tensor) -> None:
        """Copy a call's indices, and any state that is not the buffers
        themselves, into the buffers."""
        if tuple(idx.shape) != tuple(self.idx.shape):
            raise ValueError(f"indices of shape {tuple(idx.shape)}; the step's "
                             f"buffer holds {tuple(self.idx.shape)}")
        self.idx.copy_(idx)
        s = self.opt_state
        pairs = [(s.step, opt_state.step)]
        for k, buf in self.params.items():
            pairs += [(buf, params[k]), (s.m[k], opt_state.m[k]), (s.v[k], opt_state.v[k])]
        for buf, t in pairs:
            if t is not buf:
                buf.copy_(t)

    def __call__(self, params, opt_state: AdamState, idx: torch.Tensor):
        if self.params is None:
            params, opt_state, loss = self._eager(params, opt_state, idx)
            self.params, self.opt_state = params, opt_state
            self.idx = torch.empty_like(idx)
            return params, opt_state, loss
        self.load(params, opt_state, idx)
        if self.graphs is None:
            self._capture()
        dev = self.source.device
        with obs_trace.span("ensemble.replay", cat="ensemble"):
            for (name, _), graph in zip(self.STAGES, self.graphs):
                with device_range(name, dev):
                    graph.replay()
        zfp_codec.add_launches(self._launches)
        self._replays.add(1)
        return self.params, self.opt_state, self.loss

    def _capture(self) -> None:
        before = zfp_codec.launch_counts()
        try:
            with obs_trace.span("ensemble.capture", cat="ensemble"):
                pool = torch.cuda.graph_pool_handle()
                graphs = []
                for _, stage in self.STAGES:
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool,
                                          capture_error_mode="thread_local"):
                        getattr(self, stage)()
                    graphs.append(graph)
        finally:
            after = zfp_codec.launch_counts()
            self._launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
            zfp_codec.add_launches(self._launches, -1)
        self.graphs = graphs
        self._captures.add(1)


def make_host_ensemble_step(cfg: SurrogateConfig, opt_cfg: AdamConfig) -> Callable:
    """One step of every member on a fetched ``(cond, target)`` stack."""
    update = make_ensemble_update(cfg, opt_cfg)

    def step(params, opt_state, item):
        cond, target = item
        _record_on_current_stream(cond, target)
        return update(params, opt_state, cond, target)

    return step
