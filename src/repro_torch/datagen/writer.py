"""Bounded-queue async shard writer: overlap device->host + disk with compute.

Counterpart of ``repro/datagen/writer.py``, with the same contract and the
same shard bytes.  The producer (simulate + encode on the card) enqueues
*device-resident* encoded chunks, each with a CUDA event recorded on the
producer's stream after its encode; the writer's worker thread waits for
that event on a side stream of its own, copies the chunk to the host there
(``pack_sample_records``, span ``datagen.transfer``), assembles complete
shards, and commits each shard file atomically (temp + ``os.replace``).
The side stream lets the copy run while the producer's next simulation
occupies the card's main stream; ``record_stream`` keeps the chunk's
memory from being reused before the copy has read it, and the queue holds
each chunk until then, so the producer never overwrites a chunk the worker
has not copied.  With the default queue depth of 2 the pipeline is
double-buffered: while the worker transfers and writes shard ``k``, the
producer is already dispatching the simulation and encode for shard
``k+1``.  ``overlap=False`` runs the identical ingest inline.  The
producer's waits on the worker are ``datagen.writer_wait`` spans: a
``put`` that found the queue full (``op="put"``) and ``close`` joining
the worker (``op="close"``).

Crash safety contract:
  * shard files appear atomically (never truncated);
  * after every committed shard the ``on_shard`` callback fires (the
    producer persists progress there, atomically);
  * a worker failure re-raises on the producer thread at the next ``put``
    or at ``close``; ``close`` always joins the worker.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.shards import _shard_filename, pack_sample_records
from repro_torch.data.store import throttle
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class WriterStats:
    bytes_written: int = 0
    write_seconds: float = 0.0       # shard assembly + (throttled) disk IO
    transfer_seconds: float = 0.0    # device->host materialization
    shards_written: int = 0


class ShardWriter:
    """Assemble per-sample records into shard files for one scenario store.

    ``target_shards`` is the set of shard ids this writer owns (unfinished
    shards of this host's slice): samples landing in other shards are
    dropped -- a resumed simulation that straddles a finished shard re-feeds
    it, but the finished bytes are never rewritten.
    """

    _DONE = object()

    def __init__(self, root: str, shard_size: int, num_samples: int,
                 target_shards: Sequence[int],
                 on_shard: Optional[Callable[[int, dict], None]] = None,
                 bandwidth_mbs: Optional[float] = None,
                 overlap: bool = True, depth: int = 2):
        self.root = root
        self.shard_size = int(shard_size)
        self.num_samples = int(num_samples)
        self.targets = set(int(k) for k in target_shards)
        self.on_shard = on_shard
        self.bandwidth_mbs = bandwidth_mbs
        self.stats = WriterStats()
        self._pending: Dict[int, tuple] = {}   # abs sample idx -> (rec, w, lb)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._side = None                      # the copies' CUDA stream
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if overlap:
            self._q = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- producer side -------------------------------------------------------

    def put(self, start_index: int, cf) -> None:
        """Enqueue an encoded chunk whose samples start at ``start_index``.

        ``cf`` is a batched ``CompressedField`` whose tensors may still be
        being computed on the card: an event recorded here on the current
        stream marks the end of its encode, and the worker waits for it,
        not the producer.  Chunks may arrive in any order; shards commit as
        soon as their full sample range is present.
        """
        self._check()
        ready = None
        if cf.payload.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cf.payload.device))
        if self._q is None:
            self._ingest(start_index, cf, ready)
            return
        item = (start_index, cf, ready)
        try:
            self._q.put_nowait(item)
        except queue.Full:              # the worker is behind: wait for it
            with obs_trace.span("datagen.writer_wait", cat="datagen", op="put"):
                self._q.put(item)

    def close(self) -> None:
        """Flush, join the worker, and re-raise any worker failure."""
        if self._closed:
            return
        self._closed = True
        if self._q is not None:
            with obs_trace.span("datagen.writer_wait", cat="datagen", op="close"):
                self._q.put(self._DONE)
                self._thread.join()
        self._check()
        if self._pending:
            missing = sorted({i // self.shard_size for i in self._pending})
            raise RuntimeError(
                f"writer closed with incomplete shards {missing}: "
                f"{len(self._pending)} samples never completed a shard")

    def abort(self) -> None:
        """Shut the worker down after a producer-side failure.

        Unlike ``close`` this never raises: it exists for ``except`` paths
        where an exception is already propagating and the only job left is
        not leaking the worker thread or the queued device buffers.
        Idempotent; a no-op after a successful ``close``.
        """
        self._closed = True
        if self._q is not None and self._thread.is_alive():
            self._q.put(self._DONE)
            self._thread.join()
        self._pending.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False

    def _check(self) -> None:
        # sticky: the original worker failure re-raises on every call, so a
        # caller that swallows one put() error still sees the real cause at
        # close() instead of a misleading incomplete-shards report
        if self._err is not None:
            raise self._err

    # -- worker side ---------------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            try:
                self._ingest(*item)
            except BaseException as e:
                self._err = e
                # keep draining so the producer's put() never deadlocks
                while True:
                    if self._q.get() is self._DONE:
                        return

    def _shard_range(self, k: int) -> range:
        return range(k * self.shard_size,
                     min((k + 1) * self.shard_size, self.num_samples))

    def _to_host(self, cf, ready):
        """``pack_sample_records`` of ``cf``; on the card its copies run on
        this writer's side stream once ``ready`` (the encode) has passed."""
        if ready is None:
            return pack_sample_records(cf)
        dev = cf.payload.device
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._side):
            self._side.wait_event(ready)
            for t in (cf.payload, cf.emax, cf.nplanes):
                t.record_stream(self._side)
            return pack_sample_records(cf)       # .cpu() waits for the copies

    def _ingest(self, start: int, cf, ready) -> None:
        # runs on the worker thread when overlap=True, so these spans land on
        # their own Perfetto track and the sim/encode <-> transfer/IO overlap
        # is visible directly in the timeline
        t0 = time.perf_counter()
        with obs_trace.span("datagen.transfer", cat="datagen", start=start):
            records, widths, logical = self._to_host(cf, ready)
        self.stats.transfer_seconds += time.perf_counter() - t0
        self._block_count = int(cf.emax.shape[-1])
        self._padded_shape = tuple(cf.padded_shape)
        touched = set()
        for j, rec in enumerate(records):
            i = start + j
            k = i // self.shard_size
            if k in self.targets:
                self._pending[i] = (rec, int(widths[j]), int(logical[j]))
                touched.add(k)
        for k in sorted(touched):
            rng = self._shard_range(k)
            if all(i in self._pending for i in rng):
                self._commit(k, rng)

    def _commit(self, k: int, rng: range) -> None:
        t0 = time.perf_counter()
        with obs_trace.span("datagen.write", cat="datagen", shard=k) as sp:
            recs = [self._pending.pop(i) for i in rng]
            words = np.concatenate([r[0] for r in recs]).astype("<i4")
            path = os.path.join(self.root, _shard_filename(k))
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                words.tofile(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)                  # atomic shard commit
            throttle(words.nbytes, t0, self.bandwidth_mbs)
            sp.set(bytes=int(words.nbytes))
        self.targets.discard(k)
        self.stats.bytes_written += words.nbytes
        self.stats.write_seconds += time.perf_counter() - t0
        self.stats.shards_written += 1
        if self.on_shard is not None:
            self.on_shard(k, {
                "start": rng.start, "count": len(recs),
                "widths": [r[1] for r in recs],
                "logical_bytes": [r[2] for r in recs],
                "block_count": self._block_count,
                "padded_shape": list(self._padded_shape),
            })
