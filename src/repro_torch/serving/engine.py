"""Continuous-batching LM serving engine (``repro/serving/engine.py``).

The loop of the JAX engine on the port's ``lm_prefill`` / ``serve_step``
pair, on the shared ``SlotScheduler``:

  * **continuous batching** (``run``): a fixed slot table decodes every
    step at full width while each slot sits at its OWN depth (vector
    ``pos`` in ``serve_step``); the moment a request delivers its last
    token the slot is refilled from the queue mid-flight.  New requests are
    admitted in equal-prompt-length groups, prefilled in one call, and
    their caches copied into the live batch cache in place;
  * **lockstep baseline** (``run_lockstep``): slot batches right-padded with
    per-slot ``prompt_lens``, decoded for ``max(max_new_tokens)`` steps.

Both paths hold the JAX engine's contracts: a request's output is the same
served alone or batched; every real request is returned, including
``max_new_tokens=0`` (empty output); ``stats`` splits ``prefill_seconds``
from ``decode_seconds`` and counts delivered tokens only.  The greedy token
is read back to the host after every step, as the JAX engine does.  Its
``serve.*`` spans, counters and histograms are the JAX engine's, and so is
the recompile watch of ``run``: the attention kernel's library
(``kernels.flash_attention.build``) must not be built after the first
decode step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.scheduler import SlotScheduler


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int = 16
    arrival: float = 0.0        # open-loop arrival time (s, run-relative)
    output: Optional[np.ndarray] = None
    latency: Optional[float] = None     # completion - arrival (s)


def _insert_slots(cache: lm.Cache, new_cache: lm.Cache, dest: torch.Tensor) -> None:
    """Copy a freshly prefilled group's cache (batch g) into the live batch
    cache at slot indices ``dest`` (g,), in place; leaf layout (L, B, ...)."""
    for name, c in cache.items():
        c.index_copy_(1, dest, new_cache[name].to(c.dtype))


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens on the host (first maximum, as ``jnp.argmax``)."""
    return torch.argmax(logits, -1).to(torch.int32).cpu().numpy()


class ServeEngine:
    def __init__(self, params: lm.Params, cfg: ArchConfig, batch_slots: int = 4,
                 max_seq: int = 128, device: DeviceLike = None,
                 cache_dtype: torch.dtype = torch.float32):
        if cfg.encoder_layers:
            raise ValueError("encoder-decoder serving goes through the "
                             "decode dry-run, not ServeEngine")
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.cfg = cfg
        self.batch, self.max_seq = batch_slots, max_seq
        self.cache_dtype = cache_dtype
        self.stats = {"tokens": 0, "prefill_tokens": 0, "seconds": 0.0,
                      "prefill_seconds": 0.0, "decode_seconds": 0.0,
                      "decode_steps": 0, "delivered_slot_steps": 0}
        self._t_run_start: Optional[float] = None   # perf stamp of run start

    # -- shared helpers -----------------------------------------------------

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _prefill(self, toks: np.ndarray, lens: np.ndarray):
        return lm.lm_prefill(self.params, self.cfg, {"tokens": self._tensor(toks)},
                             self.max_seq, cache_dtype=self.cache_dtype,
                             prompt_lens=self._tensor(lens))

    def _decode_step(self, cache: lm.Cache, cur: np.ndarray, pos: np.ndarray):
        return lm.serve_step(self.params, self.cfg, cache, self._tensor(cur),
                             self._tensor(pos))

    def _validate(self, requests: List[Request]) -> None:
        for r in requests:
            if len(r.prompt) + r.max_new_tokens > self.max_seq:
                raise ValueError(
                    f"prompt ({len(r.prompt)}) + max_new_tokens "
                    f"({r.max_new_tokens}) exceeds max_seq={self.max_seq}")
            if len(r.prompt) == 0:
                raise ValueError("empty prompt")

    def _account(self, prefill_s: float = 0.0, decode_s: float = 0.0) -> None:
        self.stats["prefill_seconds"] += prefill_s
        self.stats["decode_seconds"] += decode_s
        self.stats["seconds"] += prefill_s + decode_s

    def _finish(self, req: Request, tokens, now: float, done: list) -> None:
        req.output = np.asarray(tokens, np.int32)[: req.max_new_tokens]
        req.latency = now - req.arrival
        self.stats["tokens"] += int(req.output.shape[0])
        done.append(req)
        reg = obs_metrics.get_registry()
        reg.counter("serve.requests").add(1)
        reg.histogram("serve.request_latency_seconds").observe(req.latency)
        seated = getattr(req, "_seated", None)
        if seated is not None:
            reg.histogram("serve.queue_wait_seconds").observe(
                seated - req.arrival)
        tracer = obs_trace.get_tracer()
        if tracer is not None and self._t_run_start is not None:
            # request lifetime span: arrival (queued) through completion
            tracer.complete(
                "serve.request", tracer.rel(self._t_run_start + req.arrival),
                req.latency, cat="serve", tokens=int(req.output.shape[0]),
                prompt=int(len(req.prompt)),
                queue_wait_s=None if seated is None
                else round(seated - req.arrival, 6))

    # -- continuous batching ------------------------------------------------

    def run(self, requests: List[Request], greedy: bool = True):
        """Serve with continuous batching; returns every request, completed,
        in completion order.  Requests with ``arrival > 0`` queue until the
        run clock (seconds since ``run`` started) passes their arrival."""
        if not greedy:
            raise NotImplementedError("ServeEngine decodes greedily")
        self._validate(requests)
        sched = SlotScheduler(self.batch)
        sched.submit_all(requests)
        b = self.batch
        cache = lm.init_cache(self.cfg, b, self.max_seq, self.cache_dtype,
                              device=self.device)
        pos = np.zeros(b, np.int32)          # per-slot decode depth
        cur = np.zeros(b, np.int32)          # per-slot last emitted token
        outs: List[list] = [[] for _ in range(b)]
        remaining = np.zeros(b, np.int64)
        done: List[Request] = []
        t_start = time.perf_counter()
        clock = lambda: time.perf_counter() - t_start
        self._t_run_start = t_start
        reg = obs_metrics.get_registry()
        occ_hist = reg.histogram("serve.slot_occupancy")
        tracer = obs_trace.get_tracer()
        # the first decode step may build the attention kernel (absorbed by
        # rebase below); a build after it is a stall worth flagging
        watcher = torchprof.get_watcher()
        watcher.watch("serve.decode_step", flash_attention.build)
        first_decode = True

        while not sched.done:
            now = clock()
            # admit until no free slot / no ripe request; zero-token requests
            # complete immediately (returned with an empty output) and their
            # slot is refilled in the same round
            seated = []
            while True:
                adm = sched.admit(now)
                if not adm:
                    break
                recycled = False
                for slot, req in adm:
                    req._seated = now
                    if req.max_new_tokens <= 0:
                        self._finish(req, [], clock(), done)
                        sched.complete(slot)
                        recycled = True
                    else:
                        seated.append((slot, req))
                if not recycled:
                    break

            if seated:
                # prefill in equal-length groups: no padding inside a call,
                # so the inserted caches match solo prefills
                t0 = time.perf_counter()
                by_len: dict = {}
                for slot, req in seated:
                    by_len.setdefault(len(req.prompt), []).append((slot, req))
                for plen, group in sorted(by_len.items()):
                    toks = np.stack([r.prompt for _, r in group])
                    logits, newc = self._prefill(toks, np.full(len(group), plen))
                    _insert_slots(cache, newc, self._tensor([s for s, _ in group]).long())
                    del newc
                    first = _argmax(logits)
                    for row, (slot, req) in enumerate(group):
                        outs[slot] = [int(first[row])]
                        pos[slot], cur[slot] = plen, first[row]
                        remaining[slot] = req.max_new_tokens - 1
                        self.stats["prefill_tokens"] += plen
                prefill_s = time.perf_counter() - t0
                self._account(prefill_s=prefill_s)
                if tracer is not None:
                    tracer.complete("serve.prefill", tracer.rel(t0), prefill_s,
                                    cat="serve", requests=len(seated),
                                    groups=len(by_len))
                for slot, req in seated:        # max_new_tokens == 1
                    if remaining[slot] == 0:
                        self._finish(req, outs[slot], clock(), done)
                        sched.complete(slot)

            active = sched.active_items()
            if not active:
                nxt_arr = sched.next_arrival()
                if nxt_arr is not None and nxt_arr > clock():
                    time.sleep(min(nxt_arr - clock(), 0.005))
                continue

            # ONE full-width decode step; every slot advances at its own pos
            t0 = time.perf_counter()
            logits, cache = self._decode_step(cache, cur, pos)
            nxt = _argmax(logits)
            decode_s = time.perf_counter() - t0
            self._account(decode_s=decode_s)
            self.stats["decode_steps"] += 1
            self.stats["delivered_slot_steps"] += len(active)
            occ_hist.observe(len(active) / b)
            if first_decode:
                first_decode = False
                watcher.rebase()        # a first-step build is expected
            if tracer is not None:
                tracer.complete("serve.decode_step", tracer.rel(t0), decode_s,
                                cat="serve", active=len(active))
                tracer.counter("serve.slots", active=len(active), total=b)
            now = clock()
            cur = nxt
            for slot, req in active:
                pos[slot] += 1
                outs[slot].append(int(nxt[slot]))
                remaining[slot] -= 1
                if remaining[slot] == 0:
                    self._finish(req, outs[slot], now, done)
                    sched.complete(slot)
        watcher.check()         # flags mid-run attention-kernel builds
        return done

    # -- lockstep baseline --------------------------------------------------

    def run_lockstep(self, requests: List[Request], greedy: bool = True):
        """Slot batches of ``self.batch`` requests, each chunk right-pad-
        prefilled in one call and decoded for ``max(max_new_tokens)`` lockstep
        steps; freed slots idle until the chunk drains.  Outputs match
        ``run``."""
        if not greedy:
            raise NotImplementedError("ServeEngine decodes greedily")
        self._validate(requests)
        done: List[Request] = []
        t_start = time.perf_counter()
        self._t_run_start = t_start
        for i in range(0, len(requests), self.batch):
            chunk = requests[i:i + self.batch]
            nreal = len(chunk)
            plen = max(len(r.prompt) for r in chunk)
            toks = np.zeros((self.batch, plen), np.int32)
            lens = np.zeros(self.batch, np.int32)
            for j in range(self.batch):
                r = chunk[min(j, nreal - 1)]     # pad SLOTS clone a real row;
                toks[j, :len(r.prompt)] = r.prompt   # active flags mark them
                lens[j] = len(r.prompt)
            active = [j for j in range(nreal) if chunk[j].max_new_tokens > 0]

            t0 = time.perf_counter()
            logits, cache = self._prefill(toks, lens)
            cur = _argmax(logits)
            self._account(prefill_s=time.perf_counter() - t0)
            self.stats["prefill_tokens"] += int(lens[:nreal].sum())

            outs = [[] for _ in range(self.batch)]
            for j in active:
                outs[j].append(int(cur[j]))
            pos = lens.copy()
            steps = max((chunk[j].max_new_tokens for j in active), default=0)
            t0 = time.perf_counter()
            for _ in range(max(steps - 1, 0)):
                logits, cache = self._decode_step(cache, cur,
                                                  np.minimum(pos, self.max_seq - 1))
                cur = _argmax(logits)
                pos += 1
                self.stats["decode_steps"] += 1
                for j in active:
                    if len(outs[j]) < chunk[j].max_new_tokens:
                        outs[j].append(int(cur[j]))
                        self.stats["delivered_slot_steps"] += 1
            self._account(decode_s=time.perf_counter() - t0)
            del cache
            now = time.perf_counter() - t_start
            # EVERY real request is returned -- zero-token ones with an
            # empty output; padding slots are never requests at all
            for j, r in enumerate(chunk):
                self._finish(r, outs[j], now, done)
        return done

    # -- derived stats ------------------------------------------------------

    @property
    def tokens_per_second(self) -> float:
        """Delivered decode tokens per DECODE second (prefill excluded)."""
        return self.stats["tokens"] / max(self.stats["decode_seconds"], 1e-9)

    @property
    def prefill_tokens_per_second(self) -> float:
        return (self.stats["prefill_tokens"]
                / max(self.stats["prefill_seconds"], 1e-9))

    @property
    def slot_utilization(self) -> float:
        """Fraction of decode slot-steps that delivered a requested token."""
        total = self.stats["decode_steps"] * self.batch
        return self.stats["delivered_slot_steps"] / max(total, 1)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
