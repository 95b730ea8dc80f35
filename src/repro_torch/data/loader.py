"""Deterministic, resumable batch order.

A copy of ``ShardedLoader`` from ``repro/data/loader.py``: every epoch's
permutation comes from ``np.random.default_rng((seed, epoch))`` alone, so
the port draws the identical batches in the identical order.  The
shard-aware, prefetching and ensemble loaders wait for a later slice.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class ShardedLoader:
    def __init__(self, num_samples: int, batch_size: int, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 drop_remainder: bool = True):
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.n = num_samples
        self.bs = batch_size
        self.seed = seed
        self.host_id, self.num_hosts = host_id, num_hosts
        self.drop_remainder = drop_remainder
        self.epoch = 0
        self.step_in_epoch = 0

    # -- state ---------------------------------------------------------------
    def state(self) -> dict:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch,
                "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self.step_in_epoch = state["step_in_epoch"]
        self.seed = state["seed"]

    # -- iteration -----------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(self.n)
        return order[self.host_id::self.num_hosts]      # host sharding

    def iter_epochs(self, max_epochs: Optional[int] = None) -> Iterator[np.ndarray]:
        """Yield index batches until ``self.epoch`` reaches ``max_epochs``,
        picking up from the current ``(epoch, step_in_epoch)`` state."""
        while max_epochs is None or self.epoch < max_epochs:
            order = self._epoch_order(self.epoch)
            steps = len(order) // self.bs if self.drop_remainder else \
                -(-len(order) // self.bs)
            while self.step_in_epoch < steps:
                i = self.step_in_epoch * self.bs
                self.step_in_epoch += 1
                yield order[i:i + self.bs]
            self.epoch += 1
            self.step_in_epoch = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.iter_epochs(None)

    def take(self, k: int):
        it = iter(self)
        return [next(it) for _ in range(k)]

    @property
    def steps_per_epoch(self) -> int:
        owned = -(-(self.n - self.host_id) // self.num_hosts)
        return owned // self.bs if self.drop_remainder else -(-owned // self.bs)
