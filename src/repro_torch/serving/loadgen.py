"""Synthetic open-loop load generation for serving (``repro/serving/loadgen.py``).

Open-loop means arrivals are generated by an external clock (Poisson
process at a target rate), NOT by the server finishing previous work -- the
standard way to measure latency under load without coordinated omission:
a request's latency runs from its scheduled arrival, so server-side
queueing delay is counted even while the engine is busy.

The numpy ``default_rng`` stream is the JAX package's, so the same seed
gives the same requests and queries.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.serving.surrogate_engine import SurrogateQuery


def poisson_arrivals(n: int, rate_qps: Optional[float],
                     rng: np.random.Generator) -> np.ndarray:
    """(n,) cumulative arrival times.  ``rate_qps=None`` -> closed-loop
    (everything arrives at t=0, the pure-throughput workload)."""
    if rate_qps is None:
        return np.zeros(n, np.float64)
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def lm_workload(vocab_size: int, n: int, *,
                prompt_lens: Sequence[int] = (4, 7, 12),
                new_tokens: Sequence[int] = (1, 2, 4, 16),
                rate_qps: Optional[float] = None,
                seed: int = 0) -> list:
    """Mixed LM requests: random token prompts with lengths and
    ``max_new_tokens`` drawn uniformly from the given sets."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate_qps, rng)
    reqs = []
    for i in range(n):
        plen = int(rng.choice(list(prompt_lens)))
        prompt = rng.integers(0, vocab_size, plen).astype(np.int32)
        reqs.append(Request(prompt=prompt,
                            max_new_tokens=int(rng.choice(list(new_tokens))),
                            arrival=float(arrivals[i])))
    return reqs


def surrogate_workload(param_dim: int, n: int, *,
                       rollout_lens: Sequence[int] = (1, 2, 4, 16),
                       rate_qps: Optional[float] = None,
                       seed: int = 0) -> list:
    """Mixed surrogate rollout queries: random conditioning vectors in
    [0, 1), rollouts over ``T`` evenly spaced normalized times."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate_qps, rng)
    queries = []
    for i in range(n):
        t = int(rng.choice(list(rollout_lens)))
        queries.append(SurrogateQuery(
            params_vec=rng.random(param_dim).astype(np.float32),
            times=np.linspace(0.0, 1.0, max(t, 1),
                              dtype=np.float32)[:t],
            arrival=float(arrivals[i])))
    return queries


def latency_percentiles(done: list) -> dict:
    """p50/p99/mean over completed requests' latencies (seconds)."""
    lats = np.asarray([d.latency for d in done], np.float64)
    if lats.size == 0:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    return {"p50": float(np.percentile(lats, 50)),
            "p99": float(np.percentile(lats, 99)),
            "mean": float(lats.mean())}
