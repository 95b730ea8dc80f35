"""Deterministic, resumable batch order and a prefetching worker.

Copies of ``ShardedLoader``, ``ShardAwareLoader``, ``EnsembleLoader`` and
``PrefetchLoader`` from ``repro/data/loader.py``: every epoch's order comes
from ``np.random.default_rng((seed, epoch))`` alone, drawn in the same
order, so the port draws the identical batches in the identical order.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from repro_torch.distributed.sharding import owned_shards


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


class ShardAwareLoader(ShardedLoader):
    """ShardedLoader that shuffles at dataset-shard granularity.

    An epoch permutes the order of the shards this host owns (contiguous
    host-sliced ownership from :func:`owned_shards`) and the sample order
    within each shard, both from one ``default_rng((seed, epoch))``, so a
    batch touches at most ``ceil(batch_size / samples_per_shard) + 1``
    shard files.  Steps per epoch may differ across hosts by up to
    ``ceil(samples_per_shard / batch_size)``.
    """

    def __init__(self, num_samples: int, batch_size: int,
                 samples_per_shard: int, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1,
                 drop_remainder: bool = True):
        if samples_per_shard <= 0:
            raise ValueError(f"samples_per_shard must be > 0, got "
                             f"{samples_per_shard}")
        super().__init__(num_samples, batch_size, seed=seed, host_id=host_id,
                         num_hosts=num_hosts, drop_remainder=drop_remainder)
        self.samples_per_shard = samples_per_shard
        self.num_shards = -(-num_samples // samples_per_shard)
        # an epoch that yields zero batches would make __iter__ spin
        # forever: fail loudly at construction instead
        owned = self._owned_samples()
        needed = batch_size if drop_remainder else 1
        if owned < needed:
            raise ValueError(
                f"host {host_id}/{num_hosts} owns {owned} samples "
                f"({self.num_shards} shards of ~{samples_per_shard}); needs "
                f">= {needed} per epoch (batch_size={batch_size}, "
                f"drop_remainder={drop_remainder}) -- use fewer hosts or "
                f"smaller shards")

    def _owned_samples(self) -> int:
        shards = owned_shards(self.num_shards, self.host_id, self.num_hosts)
        return int(sum(
            min((int(s) + 1) * self.samples_per_shard, self.n)
            - int(s) * self.samples_per_shard for s in shards))

    @property
    def steps_per_epoch(self) -> int:
        owned = self._owned_samples()
        return owned // self.bs if self.drop_remainder else -(-owned // self.bs)

    @classmethod
    def for_store(cls, store, batch_size: int, **kw) -> "ShardAwareLoader":
        """Loader matched to a store's shard layout (``store.shard_size``)."""
        return cls(store.num_samples, batch_size, store.shard_size, **kw)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        shards = owned_shards(self.num_shards, self.host_id, self.num_hosts)
        chunks = []
        for s in rng.permutation(shards):
            lo = int(s) * self.samples_per_shard
            idx = np.arange(lo, min(lo + self.samples_per_shard, self.n))
            rng.shuffle(idx)
            chunks.append(idx)
        return np.concatenate(chunks) if chunks else np.empty(0, np.int64)


class EnsembleLoader:
    """N per-seed loaders advanced in lockstep: one draw yields (N, B) indices.

    Member m's index stream is the one its own loader feeds an independent
    ``train_surrogate`` run (``loader=``), which is what the ensemble
    trainer is held to.  All members must agree on steps per epoch:
    ``zip`` would otherwise cut every member's epoch to the shortest.
    """

    def __init__(self, loaders: Sequence):
        if not loaders:
            raise ValueError("EnsembleLoader needs at least one member loader")
        spes = {ld.steps_per_epoch for ld in loaders}
        if len(spes) != 1:
            raise ValueError(f"members disagree on steps/epoch: {sorted(spes)}")
        self.loaders = list(loaders)

    @property
    def num_members(self) -> int:
        return len(self.loaders)

    @property
    def seeds(self) -> list:
        return [ld.seed for ld in self.loaders]

    @property
    def steps_per_epoch(self) -> int:
        return self.loaders[0].steps_per_epoch

    # -- state: members run in lockstep, so (epoch, step) are shared ---------
    def state(self) -> dict:
        lead = self.loaders[0].state()
        return {"epoch": lead["epoch"], "step_in_epoch": lead["step_in_epoch"],
                "seeds": list(self.seeds)}

    def restore(self, state: dict) -> None:
        if len(state["seeds"]) != len(self.loaders):
            raise ValueError(f"state carries {len(state['seeds'])} seeds for "
                             f"{len(self.loaders)} members")
        for ld, seed in zip(self.loaders, state["seeds"]):
            ld.restore({"epoch": state["epoch"],
                        "step_in_epoch": state["step_in_epoch"], "seed": seed})

    def iter_epochs(self, max_epochs: Optional[int] = None) -> Iterator[np.ndarray]:
        its = [ld.iter_epochs(max_epochs) for ld in self.loaders]
        for batches in zip(*its):
            yield np.stack(batches)

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.iter_epochs(None)


class PrefetchLoader:
    """Wraps (indices iterator, fetch fn) with a bounded background queue.

    Termination contract:
      * a finite upstream iterator ends cleanly -- the worker enqueues an
        end-of-stream sentinel and ``__next__`` raises StopIteration;
      * worker exceptions (from the iterator or the fetch) re-raise on the
        consumer side, then subsequent ``__next__`` calls raise StopIteration;
      * ``close()`` unblocks a worker stuck on a full-queue put, drains, and
        joins it, so abandoning iteration mid-stream never leaks the thread.
    """

    _DONE = object()

    def __init__(self, index_iter: Iterator[np.ndarray],
                 fetch: Callable[[np.ndarray], object], depth: int = 2):
        self._iter = index_iter
        self._fetch = fetch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts (returns False) once close() is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for idx in self._iter:
                if self._stop.is_set():
                    return
                if not self._put(self._fetch(idx)):
                    return
        except BaseException as e:      # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            try:                        # keep repeated __next__ non-blocking
                self._q.put_nowait(self._DONE)
            except queue.Full:
                pass
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker (even mid-put), drain the queue, join the thread."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        try:                            # drop items raced in by the worker
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        try:                            # iterating after close(): StopIteration
            self._q.put_nowait(self._DONE)
        except queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
