"""Surrogate serving: continuous batching over a device-resident model fleet.

Counterpart of ``repro/serving/surrogate_engine.py``.  The paper's
deliverable is the *served* surrogate, and §III makes the seed-ensemble
variability band the trust signal -- so the band IS the product: every
query is answered by ALL N ensemble members in one call and returns
the per-timestep member mean plus the +/-sigma band width (``hi - lo`` of
``core.variability.VariabilityBand`` over members).

A query is a conditioning->rollout: a simulation parameter vector plus the
normalized times to roll the surrogate over (``models.surrogate`` maps
``[params, t]`` to the six output fields).  The engine packs the CURRENT
timestep of every active slot into one ``(B, cond_dim)`` batch and runs the
stacked ``(M, ...)`` member parameters on it through one member-folded
forward (``models.folded.folded_forward``, as the ensemble's training and
evaluation), under ``torch.inference_mode()``.  The stacked parameters stay resident on the
engine's device for its lifetime; only the condition batch is uploaded per
step, and mean and width are read back per step, as the JAX engine does.

Continuous batching comes from the shared ``SlotScheduler``: rollouts of
mixed lengths retire independently and freed slots are refilled mid-flight,
vs the ``run_lockstep`` baseline that drains ``max(T)`` steps per chunk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.folded import folded_forward
from repro_torch.models.surrogate import Surrogate, SurrogateConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.scheduler import SlotScheduler


@dataclasses.dataclass
class SurrogateQuery:
    params_vec: np.ndarray      # (PARAM_DIM,) simulation input parameters
    times: np.ndarray           # (T,) normalized rollout times in [0, 1]
    arrival: float = 0.0        # open-loop arrival time (s, run-relative)
    mean: Optional[np.ndarray] = None    # (T, H, W, F) member mean
    width: Optional[np.ndarray] = None   # (T, H, W, F) band width (hi - lo)
    latency: Optional[float] = None

    @property
    def steps(self) -> int:
        return int(np.asarray(self.times).shape[0])


class SurrogateServeEngine:
    """Fixed-slot ensemble serving of a trained (or freshly stacked) fleet.

    ``member_params``: a stacked state dict ``{name: (M, ...)}`` -- e.g.
    ``core.ensemble.EnsembleResult.params`` straight from the ensemble
    trainer, or ``init_ensemble`` output.  Kept resident on ``device`` (the
    card unless ``device="cpu"``) for the engine's lifetime.
    """

    def __init__(self, member_params: Mapping[str, torch.Tensor],
                 cfg: SurrogateConfig, batch_slots: int = 8,
                 sigmas: float = 2.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        with torch.device("meta"):          # the parameters' shapes, no storage
            shapes = {n: tuple(p.shape) for n, p in
                      Surrogate(cfg, torch.Generator()).named_parameters()}
        if set(member_params) != set(shapes):
            raise ValueError("member_params must hold the surrogate's parameters "
                             f"{sorted(shapes)}; got {sorted(member_params)}")
        self.members: Dict[str, torch.Tensor] = {
            n: torch.as_tensor(v, dtype=torch.float32).to(self.device)
            for n, v in member_params.items()}
        unstacked = [n for n, v in self.members.items()
                     if v.dim() != len(shapes[n]) + 1 or tuple(v.shape[1:]) != shapes[n]]
        leads = {int(v.shape[0]) for v in self.members.values()}
        if unstacked or len(leads) != 1:
            raise ValueError("member_params must be a stacked (M, ...) state dict; "
                             f"{len(unstacked)} of {len(shapes)} tensors are not, "
                             f"member counts {sorted(leads)}")
        (self.num_members,) = leads
        self.cfg = cfg
        self.batch = batch_slots
        self.sigmas = float(sigmas)
        self.stats = {"queries": 0, "field_evals": 0, "steps": 0,
                      "seconds": 0.0}
        self._t_run_start: Optional[float] = None   # perf stamp of run start

    # -- internals ----------------------------------------------------------

    def fleet_step(self, cond: torch.Tensor):
        """ONE call: every member predicts every row of ``cond`` (B,
        cond_dim), on the engine's device.  Returns (mean (B, H, W, F),
        band width = hi - lo = 2 * sigmas * std) with the population std
        over members, as ``jnp.std`` and ``compute_band`` take it."""
        with torch.inference_mode():
            preds = folded_forward(self.cfg, self.members,
                                   cond.expand(self.num_members, -1, -1))
            mean = preds.mean(dim=0)
            width = 2.0 * self.sigmas * preds.std(dim=0, correction=0)
        return mean, width

    def _step(self, cond_np: np.ndarray):
        mean, width = self.fleet_step(torch.from_numpy(cond_np).to(self.device))
        return mean.cpu().numpy(), width.cpu().numpy()

    def _finish(self, q: SurrogateQuery, means: list, widths: list,
                now: float, done: list) -> None:
        shape = (0, self.cfg.height, self.cfg.width, self.cfg.fields)
        q.mean = (np.stack(means) if means
                  else np.zeros(shape, np.float32))
        q.width = (np.stack(widths) if widths
                   else np.zeros(shape, np.float32))
        q.latency = now - q.arrival
        self.stats["queries"] += 1
        done.append(q)
        reg = obs_metrics.get_registry()
        reg.counter("surrogate_serve.queries").add(1)
        reg.histogram("surrogate_serve.query_latency_seconds").observe(
            q.latency)
        tracer = obs_trace.get_tracer()
        if tracer is not None and self._t_run_start is not None:
            seated = getattr(q, "_seated", None)
            tracer.complete(
                "surrogate_serve.query",
                tracer.rel(self._t_run_start + q.arrival), q.latency,
                cat="serve", steps=q.steps,
                queue_wait_s=None if seated is None
                else round(seated - q.arrival, 6))

    def _cond_row(self, q: SurrogateQuery, k: int) -> np.ndarray:
        return np.concatenate([np.asarray(q.params_vec, np.float32),
                               np.float32(q.times[k])[None]])

    # -- continuous batching ------------------------------------------------

    def run(self, queries: List[SurrogateQuery]):
        """Serve rollouts with mid-flight slot refill; returns every query,
        completed, in completion order."""
        sched = SlotScheduler(self.batch)
        sched.submit_all(queries)
        b = self.batch
        cond_dim = self.cfg.cond_dim
        cond = np.zeros((b, cond_dim), np.float32)
        step_idx = np.zeros(b, np.int64)
        means: List[list] = [[] for _ in range(b)]
        widths: List[list] = [[] for _ in range(b)]
        done: List[SurrogateQuery] = []
        t_start = time.perf_counter()
        clock = lambda: time.perf_counter() - t_start
        self._t_run_start = t_start
        reg = obs_metrics.get_registry()
        occ_hist = reg.histogram("surrogate_serve.slot_occupancy")
        tracer = obs_trace.get_tracer()
        # no recompile watch: the fleet step launches no kernel of the port,
        # so it has no build cache that could grow

        while not sched.done:
            now = clock()
            while True:
                adm = sched.admit(now)
                if not adm:
                    break
                recycled = False
                for slot, q in adm:
                    q._seated = now
                    if q.steps == 0:         # empty rollout: return as-is
                        self._finish(q, [], [], clock(), done)
                        sched.complete(slot)
                        recycled = True
                    else:
                        step_idx[slot] = 0
                        means[slot], widths[slot] = [], []
                        cond[slot] = self._cond_row(q, 0)
                if not recycled:
                    break

            active = sched.active_items()
            if not active:
                nxt_arr = sched.next_arrival()
                if nxt_arr is not None and nxt_arr > clock():
                    time.sleep(min(nxt_arr - clock(), 0.005))
                continue

            t0 = time.perf_counter()
            mean_b, width_b = self._step(cond)
            step_s = time.perf_counter() - t0
            self.stats["seconds"] += step_s
            self.stats["steps"] += 1
            self.stats["field_evals"] += len(active)
            occ_hist.observe(len(active) / b)
            if tracer is not None:
                tracer.complete("surrogate_serve.fleet_step", tracer.rel(t0),
                                step_s, cat="serve", active=len(active),
                                members=self.num_members)
                tracer.counter("surrogate_serve.slots", active=len(active),
                               total=b)
            now = clock()
            for slot, q in active:
                means[slot].append(mean_b[slot])
                widths[slot].append(width_b[slot])
                k = int(step_idx[slot]) + 1
                if k >= q.steps:
                    self._finish(q, means[slot], widths[slot], now, done)
                    sched.complete(slot)
                else:
                    step_idx[slot] = k
                    cond[slot] = self._cond_row(q, k)
        return done

    # -- lockstep baseline --------------------------------------------------

    def run_lockstep(self, queries: List[SurrogateQuery]):
        """Chunked baseline: slot batches of ``self.batch`` queries, each
        chunk rolled for ``max(T)`` steps; short rollouts idle (their slot
        re-evaluates the last timestep and the result is dropped)."""
        done: List[SurrogateQuery] = []
        t_start = time.perf_counter()
        self._t_run_start = t_start
        for i in range(0, len(queries), self.batch):
            chunk = queries[i:i + self.batch]
            steps = max((q.steps for q in chunk), default=0)
            cond = np.zeros((self.batch, self.cfg.cond_dim), np.float32)
            acc = [([], []) for _ in chunk]
            for s in range(steps):
                for j, q in enumerate(chunk):
                    if q.steps:             # zero-step queries have no times
                        cond[j] = self._cond_row(q, min(s, q.steps - 1))
                t0 = time.perf_counter()
                mean_b, width_b = self._step(cond)
                self.stats["seconds"] += time.perf_counter() - t0
                self.stats["steps"] += 1
                for j, q in enumerate(chunk):
                    if s < q.steps:
                        acc[j][0].append(mean_b[j])
                        acc[j][1].append(width_b[j])
                        self.stats["field_evals"] += 1
            now = time.perf_counter() - t_start
            for j, q in enumerate(chunk):
                self._finish(q, acc[j][0], acc[j][1], now, done)
        return done

    # -- derived stats ------------------------------------------------------

    @property
    def queries_per_second(self) -> float:
        return self.stats["queries"] / max(self.stats["seconds"], 1e-9)

    @property
    def slot_utilization(self) -> float:
        total = self.stats["steps"] * self.batch
        return self.stats["field_evals"] / max(total, 1)
