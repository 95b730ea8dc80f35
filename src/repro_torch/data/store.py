"""Training-data stores: raw vs ZFP-compressed, decoded per batch.

Counterpart of ``repro/data/store.py``, the paper's two workflows (Fig. 2):

  workflow 1: RawArrayStore        -- one raw ``.npy`` per sample
  workflow 2: CompressedArrayStore -- per-sample ZFP streams; each batch
              reads the compressed words on the host and decodes them with
              one kernel call on the store's device.

Every store takes ``device=`` (the card unless ``device="cpu"``) and returns
batches as tensors there.  All stores count bytes moved, read time and
decode time in an :class:`IoStats`, and the optional bandwidth throttle
emulates the paper's file systems on one local disk.

Batches are built on the card by :func:`on_device`: host-to-device copies
and the decode run on a side stream of the calling thread, timed with CUDA
events, and the host waits for that stream alone.  A prefetch worker thread
therefore never waits for the train step that the main thread has queued
on its own stream (``torch.cuda.synchronize()`` would).
"""
from __future__ import annotations

import os
import threading
import time
from typing import (Callable, Optional, Protocol, Sequence, Tuple, TypeVar,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.compression import decode_stacked_payloads, get_codec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import IoStats

ENCODE_CHUNK = 256     # samples per encode call when a store is built

R = TypeVar("R")


@runtime_checkable
class ArrayStore(Protocol):
    """Indexed batch access to a dataset, IO accounting and its logical
    footprint; batches come back as tensors on ``device``."""
    stats: IoStats
    shape: Tuple[int, ...]
    num_samples: int
    sample_nbytes: int
    device: torch.device

    def get_batch(self, idx: np.ndarray) -> torch.Tensor: ...

    @property
    def stored_bytes(self) -> int: ...


def throttle(nbytes: int, started: float, bandwidth_mbs: Optional[float]):
    """Sleep until ``nbytes`` would have moved at ``bandwidth_mbs`` MB/s."""
    if bandwidth_mbs is None:
        return
    needed = nbytes / (bandwidth_mbs * 1e6)
    elapsed = time.perf_counter() - started
    if needed > elapsed:
        time.sleep(needed - elapsed)


def channels_last(batch: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) store batch -> (B, H, W, C) model layout."""
    return batch.permute(0, 2, 3, 1)


_side = threading.local()


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    streams = getattr(_side, "streams", None)
    if streams is None:
        streams = _side.streams = {}
    if dev not in streams:
        streams[dev] = torch.cuda.Stream(dev)
    return streams[dev]


def on_device(dev: torch.device, work: Callable[[], R],
              side_stream: bool = True) -> Tuple[R, float]:
    """Run ``work`` (the copies and launches that build one batch on
    ``dev``) and return ``(its tensor, its seconds)``.

    On the CPU the seconds are host time.  On the card ``work`` runs on a
    side stream of the calling thread (``side_stream=False``: on the
    current stream, for work that reads tensors queued there), between two
    CUDA events; the host then waits for the end event only, so the result
    is complete when this returns, and the seconds are the device time
    between the events.  ``record_stream`` tells the caching allocator
    that the calling thread's current stream reads the result, so its
    memory is not reused before that stream is done with it.
    """
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = work()
        return out, time.perf_counter() - t0
    current = torch.cuda.current_stream(dev)
    stream = _side_stream(dev) if side_stream else current
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        start.record(stream)
        out = work()
        end.record(stream)
    end.synchronize()
    if stream is not current:
        out.record_stream(current)
    return out, start.elapsed_time(end) / 1e3


def upload(dev: torch.device, *arrays: np.ndarray):
    """Host arrays -> tensors on ``dev`` (a synchronous copy on the current
    stream; inside :func:`on_device` that is the side stream)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


class RawArrayStore:
    """One raw .npy per sample (paper: one HDF5 per sample), or in-memory."""

    def __init__(self, samples: Sequence[np.ndarray] | np.ndarray,
                 root: Optional[str] = None,
                 bandwidth_mbs: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.bandwidth_mbs = bandwidth_mbs
        self.stats = IoStats()
        self._mem = None
        self.root = root
        n = len(samples)
        self.shape = tuple(np.asarray(samples[0]).shape)
        if root is None:
            # same float32 cast as the on-disk path
            self._mem = np.stack([np.asarray(s, np.float32) for s in samples])
        else:
            os.makedirs(root, exist_ok=True)
            for i in range(n):
                np.save(os.path.join(root, f"sample_{i:06d}.npy"),
                        np.asarray(samples[i], np.float32))
        self.num_samples = n
        self.sample_nbytes = int(np.prod(self.shape)) * 4

    @property
    def stored_bytes(self) -> int:
        return self.sample_nbytes * self.num_samples

    def get_batch(self, idx: np.ndarray) -> torch.Tensor:
        with obs_trace.span("data.get_batch", cat="data", store="raw",
                            batch=len(idx)):
            t0 = time.perf_counter()
            if self._mem is not None:
                batch = self._mem[np.asarray(idx)]
            else:
                batch = np.stack([np.load(os.path.join(self.root,
                                                       f"sample_{i:06d}.npy"))
                                  for i in np.asarray(idx)])
            nbytes = batch.nbytes
            throttle(nbytes, t0, self.bandwidth_mbs)
            self.stats.account(nbytes, read_seconds=time.perf_counter() - t0)
            out, _ = on_device(self.device, lambda: upload(self.device, batch)[0])
            return out


class CompressedArrayStore:
    """Per-sample ZFP streams with per-sample tolerances (fixed-accuracy) or
    a uniform ``bits_per_value`` (fixed-rate).

    Samples are (C, H, W) or (H, W) float arrays; compression runs over the
    trailing two dims, on the store's device, ``ENCODE_CHUNK`` samples per
    encode call (each sample's stream is the same as a one-sample encode
    would give).  Per-sample payload widths vary with the adaptive rate;
    batches pad to the in-batch max width (padded words decode as zero
    planes, so decoding stays exact) and run one fixed-rate kernel decode
    per batch.
    """

    def __init__(self, samples: Sequence[np.ndarray],
                 tolerances: Optional[Sequence[float]] = None,
                 bits_per_value: Optional[int] = None,
                 root: Optional[str] = None,
                 bandwidth_mbs: Optional[float] = None,
                 device: DeviceLike = None):
        if (tolerances is None) == (bits_per_value is None):
            raise ValueError("give either tolerances (fixed-accuracy) or "
                             "bits_per_value (fixed-rate)")
        self.device = resolve_device(device)
        self.bandwidth_mbs = bandwidth_mbs
        self.stats = IoStats()
        self.root = root
        self.shape = tuple(np.asarray(samples[0]).shape)
        self.num_samples = len(samples)
        self.sample_nbytes = int(np.prod(self.shape)) * 4
        self._payload, self._emax, self._widths = [], [], []
        self.logical_bytes = 0
        if root is not None:
            os.makedirs(root, exist_ok=True)
        if tolerances is not None:
            codec = get_codec("fixed_accuracy")
            tols = np.asarray([float(t) for t in tolerances], np.float32)
        else:
            codec = get_codec("fixed_rate", bits_per_value=bits_per_value)
        for lo in range(0, self.num_samples, ENCODE_CHUNK):
            hi = min(lo + ENCODE_CHUNK, self.num_samples)
            xs, = upload(self.device, np.stack(
                [np.asarray(samples[i], np.float32) for i in range(lo, hi)]))
            cf = codec.encode_batch(
                xs, None if tolerances is None else
                upload(self.device, tols[lo:hi])[0])
            self._padded_shape = cf.padded_shape
            payloads = cf.payload.cpu().numpy()
            emaxs = cf.emax.cpu().numpy().astype(np.int32)
            if tolerances is not None:
                nplanes = cf.nplanes.cpu().numpy()
                nbytes = codec.nbytes(cf).cpu().numpy()
            for j in range(hi - lo):
                if tolerances is not None:
                    w = int(np.ceil(int(nplanes[j].max()) / 2)) or 1
                    payload = np.ascontiguousarray(payloads[j, :, :w])
                    self.logical_bytes += int(nbytes[j])
                else:
                    payload = payloads[j]
                    w = payload.shape[1]
                    self.logical_bytes += payload.nbytes + cf.emax.shape[1]
                if root is None:
                    self._payload.append(payload)
                    self._emax.append(emaxs[j])
                else:
                    np.savez(os.path.join(root, f"sample_{lo + j:06d}.npz"),
                             payload=payload, emax=emaxs[j])
                self._widths.append(w)

    @property
    def stored_bytes(self) -> int:
        return self.logical_bytes

    @property
    def ratio(self) -> float:
        return self.sample_nbytes * self.num_samples / max(self.logical_bytes, 1)

    def get_batch(self, idx: np.ndarray) -> torch.Tensor:
        with obs_trace.span("data.get_batch", cat="data", store="zfp",
                            batch=len(idx)):
            idx = np.asarray(idx)
            t0 = time.perf_counter()
            payloads, emaxs, nbytes = [], [], 0
            for i in idx:
                if self.root is None:
                    p, e = self._payload[i], self._emax[i]
                else:
                    z = np.load(os.path.join(self.root, f"sample_{i:06d}.npz"))
                    p, e = z["payload"], z["emax"]
                nbytes += p.nbytes + e.nbytes
                payloads.append(p)
                emaxs.append(e)
            wmax = max(p.shape[1] for p in payloads)
            payload = np.stack([np.pad(p, ((0, 0), (0, wmax - p.shape[1])))
                                for p in payloads])
            emax = np.stack(emaxs)
            throttle(nbytes, t0, self.bandwidth_mbs)
            t1 = time.perf_counter()
            batch, decode_s = on_device(self.device, lambda: decode_stacked_payloads(
                *upload(self.device, payload, emax), self._padded_shape,
                self.shape))
            self.stats.account(nbytes, read_seconds=t1 - t0,
                               decode_seconds=decode_s)
            return batch
