"""The batch order of a cell, drawn from its seed by the benchmark.

The order is an input, made here and handed to the program (the
``loader=`` of ``train_surrogate`` and ``train_ensemble``) and to the
reference alike.  Each epoch permutes the store's shards and the samples
within each shard from ``numpy.random.default_rng((seed, member, epoch))``
(the shard-aware order a sharded store is read in: a batch of 64 touches
three shards of 32 at most) and cuts it into batches, dropping the
remainder, so the rows of an epoch all differ.  Every batch drawn is
recorded, in order, for the reference and the roofline counts.

``on_draw``, when set, is called with the number of batches this call of
``iter_epochs`` has yielded before each new draw; it returns False to end
the stream (an ensemble's measured window ends there).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


class SeedBatches:
    def __init__(self, num_samples: int, batch_size: int, shard_size: int,
                 seed: int, members: Optional[int] = None):
        if num_samples < batch_size:
            raise ValueError(f"{num_samples} samples for a batch of {batch_size}")
        self.n, self.bs, self.shard = num_samples, batch_size, shard_size
        self.seed = int(seed)
        self.members = members
        self.epoch = 0
        self.step_in_epoch = 0
        self.drawn: List[np.ndarray] = []
        self.on_draw: Optional[Callable[[int], bool]] = None

    # the loader protocol of the program's train loops
    @property
    def num_members(self) -> int:
        return self.members or 1

    @property
    def seeds(self) -> list:
        return [self.seed + m for m in range(self.num_members)]

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.bs

    def state(self) -> dict:
        return {"epoch": self.epoch, "step_in_epoch": self.step_in_epoch,
                "seed": self.seed}

    def order(self, member: int, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, member, epoch))
        shards = [np.arange(lo, min(lo + self.shard, self.n))
                  for lo in range(0, self.n, self.shard)]
        out = []
        for k in rng.permutation(len(shards)):
            idx = shards[k].copy()
            rng.shuffle(idx)
            out.append(idx)
        return np.concatenate(out)

    def iter_epochs(self, max_epochs: Optional[int] = None):
        yielded = 0
        while max_epochs is None or self.epoch < max_epochs:
            orders = [self.order(m, self.epoch) for m in range(self.num_members)]
            while self.step_in_epoch < self.steps_per_epoch:
                if self.on_draw is not None and not self.on_draw(yielded):
                    return
                lo = self.step_in_epoch * self.bs
                batch = np.stack([o[lo:lo + self.bs] for o in orders])
                batch = batch if self.members else batch[0]
                self.step_in_epoch += 1
                self.drawn.append(batch)
                yielded += 1
                yield batch
            self.epoch += 1
            self.step_in_epoch = 0

    def __iter__(self):
        return self.iter_epochs(None)


def batches_of(drawn: Sequence[np.ndarray], member: Optional[int]) -> List[np.ndarray]:
    """One member's batches out of the recorded draws."""
    return [np.asarray(b if member is None else b[member]) for b in drawn]
