"""Sharded compressed dataset container: many samples per file, one decode.

Counterpart of ``repro/data/shards.py``, with the same ``repro-shards-v1``
format, so either package opens a store the other wrote, and a store built
from the same samples and tolerances is byte-identical in both.

On-disk layout (``root/``):
  manifest.json          -- format tag, sample/padded shapes, block count,
                            shard size, per-sample tolerances / payload
                            widths / logical byte counts, shard table
  shard_00000.bin, ...   -- flat little-endian int32 words; each sample
                            record is ``nb * width`` payload words (packed
                            bit planes) followed by ``nb`` emax words

Shard files are memory-mapped on open, so a batch fetch is a handful of
contiguous record reads; the assembled batch pads payloads to the in-batch
max width (padded words decode as zero planes) and runs ONE fixed-rate
kernel decode on the store's device.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.compression import (compressed_nbytes_batch,
                                     decode_stacked_payloads, get_codec)
from repro_torch.data.store import on_device, throttle, upload
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import IoStats

MANIFEST_NAME = "manifest.json"
FORMAT_TAG = "repro-shards-v1"


def _shard_filename(k: int) -> str:
    return f"shard_{k:05d}.bin"


def atomic_write_json(path: str, obj: dict) -> None:
    """Write JSON via unique temp file + ``os.replace`` so a kill mid-write
    can never leave a torn file at ``path`` (the reader sees either the old
    content or the new, never a partial stream)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def pack_sample_records(cf) -> tuple:
    """Per-sample shard records from a batched fixed-accuracy
    ``CompressedField``.

    Returns ``(records, widths, logical_bytes)``: ``records[j]`` is the flat
    little-endian int32 word array (``nb * w`` payload words followed by
    ``nb`` emax words) that shard files store for sample ``j``; ``widths[j]``
    is the per-sample payload width ``w = ceil(max(nplanes) / 2) or 1``.
    """
    pay = cf.payload.cpu().numpy()                        # (c, nb, MAXW)
    ema = cf.emax.cpu().numpy().astype(np.int32)
    npl = cf.nplanes.cpu().numpy()
    logical = compressed_nbytes_batch(cf, mode="fixed_accuracy").cpu().numpy() \
        .astype(np.int64)
    records, widths = [], []
    for j in range(pay.shape[0]):
        w = int(np.ceil(npl[j].max() / 2)) or 1
        records.append(np.concatenate(
            [pay[j, :, :w].ravel(), ema[j]]).astype("<i4"))
        widths.append(w)
    return records, np.asarray(widths, np.int64), logical


def build_manifest(shape, padded_shape, block_count: int, shard_size: int,
                   num_samples: int, tolerances, widths,
                   logical_bytes) -> dict:
    """Assemble the store manifest dict (the one source of its schema)."""
    num_shards = -(-num_samples // shard_size)
    return {
        "format": FORMAT_TAG,
        "shape": list(shape),
        "padded_shape": list(padded_shape),
        "block_count": int(block_count),
        "shard_size": int(shard_size),
        "num_samples": int(num_samples),
        "tolerances": [float(t) for t in tolerances],
        "widths": [int(w) for w in widths],
        "logical_bytes": [int(b) for b in logical_bytes],
        "shards": [{"file": _shard_filename(k),
                    "start": k * shard_size,
                    "count": (min((k + 1) * shard_size, num_samples)
                              - k * shard_size)}
                   for k in range(num_shards)],
    }


class ShardedCompressedStore:
    """Error-bounded ZFP store packing ``shard_size`` samples per shard.

    Build from samples + per-sample tolerances (``__init__``; one encode
    call per shard-sized chunk on ``device``) or reattach to an existing
    directory (``open``).  ``root=None`` keeps the identical record layout
    in memory.  Batches are decoded on ``device`` (the card unless
    ``device="cpu"``).
    """

    def __init__(self, samples: Optional[Sequence[np.ndarray]] = None,
                 tolerances: Optional[Sequence[float]] = None,
                 root: Optional[str] = None,
                 shard_size: int = 32,
                 bandwidth_mbs: Optional[float] = None,
                 device: DeviceLike = None,
                 _manifest: Optional[dict] = None):
        self.device = resolve_device(device)
        self.root = root
        self.bandwidth_mbs = bandwidth_mbs
        self.stats = IoStats()
        self._shards: Dict[int, np.ndarray] = {}    # shard id -> int32 words
        if _manifest is not None:
            self._init_from_manifest(_manifest)
            return
        if samples is None or tolerances is None:
            raise ValueError("build from (samples, tolerances) or use "
                             "ShardedCompressedStore.open")
        if len(samples) != len(tolerances) or shard_size <= 0:
            raise ValueError(f"{len(samples)} samples, {len(tolerances)} "
                             f"tolerances, shard_size {shard_size}")
        self.shard_size = int(shard_size)
        self._build(samples, np.asarray(tolerances, np.float32))

    # -- construction --------------------------------------------------------

    def _build(self, samples, tolerances: np.ndarray) -> None:
        xs = np.stack([np.asarray(s, np.float32) for s in samples])
        self.num_samples = xs.shape[0]
        self.shape = tuple(xs.shape[1:])
        self.sample_nbytes = int(np.prod(self.shape)) * 4
        self.tolerances = tolerances

        codec = get_codec("fixed_accuracy")
        records, widths, logical = [], [], []
        for lo in range(0, self.num_samples, self.shard_size):
            hi = lo + self.shard_size
            chunk, tols = upload(self.device, xs[lo:hi], tolerances[lo:hi])
            cf = codec.encode_batch(chunk, tols)
            self._padded_shape = cf.padded_shape
            recs, ws, lb = pack_sample_records(cf)
            records += recs
            widths.append(ws)
            logical.append(lb)
        self.nb = int(cf.emax.shape[-1])
        self.widths = np.concatenate(widths)
        self.logical_bytes_per = np.concatenate(logical)
        self.logical_bytes = int(self.logical_bytes_per.sum())
        self._compute_offsets()

        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
        for k in range(self.num_shards):
            lo = k * self.shard_size
            hi = min(lo + self.shard_size, self.num_samples)
            words = np.concatenate(records[lo:hi]).astype("<i4")
            if self.root is None:
                self._shards[k] = words
            else:
                words.tofile(os.path.join(self.root, _shard_filename(k)))
        if self.root is not None:
            atomic_write_json(os.path.join(self.root, MANIFEST_NAME),
                              self.manifest())

    def _compute_offsets(self) -> None:
        """Word offset of each sample's record within its shard."""
        rec_words = self.nb * self.widths + self.nb
        self._offsets = np.zeros(self.num_samples, np.int64)
        for k in range(self.num_shards):
            lo = k * self.shard_size
            hi = min(lo + self.shard_size, self.num_samples)
            self._offsets[lo:hi] = (np.cumsum(rec_words[lo:hi])
                                    - rec_words[lo:hi])

    # -- manifest / reopen ---------------------------------------------------

    def manifest(self) -> dict:
        return build_manifest(self.shape, self._padded_shape, self.nb,
                              self.shard_size, self.num_samples,
                              self.tolerances, self.widths,
                              self.logical_bytes_per)

    def _init_from_manifest(self, m: dict) -> None:
        if m.get("format") != FORMAT_TAG:
            raise ValueError(f"unknown format {m.get('format')!r}")
        self.shape = tuple(m["shape"])
        self._padded_shape = tuple(m["padded_shape"])
        self.nb = int(m["block_count"])
        self.shard_size = int(m["shard_size"])
        self.num_samples = int(m["num_samples"])
        self.sample_nbytes = int(np.prod(self.shape)) * 4
        self.tolerances = np.asarray(m["tolerances"], np.float32)
        self.widths = np.asarray(m["widths"], np.int64)
        self.logical_bytes_per = np.asarray(m["logical_bytes"], np.int64)
        self.logical_bytes = int(self.logical_bytes_per.sum())
        self._compute_offsets()

    @classmethod
    def open(cls, root: str, bandwidth_mbs: Optional[float] = None,
             device: DeviceLike = None) -> "ShardedCompressedStore":
        """Reattach to an on-disk store; shards memory-map lazily."""
        with open(os.path.join(root, MANIFEST_NAME)) as f:
            m = json.load(f)
        return cls(root=root, bandwidth_mbs=bandwidth_mbs, device=device,
                   _manifest=m)

    # -- store protocol ------------------------------------------------------

    @property
    def padded_shape(self):
        return self._padded_shape

    @property
    def num_shards(self) -> int:
        return -(-self.num_samples // self.shard_size)

    @property
    def stored_bytes(self) -> int:
        return self.logical_bytes

    @property
    def ratio(self) -> float:
        return self.sample_nbytes * self.num_samples / max(self.logical_bytes, 1)

    def shard_of(self, i: int) -> int:
        return i // self.shard_size

    def _shard_words(self, k: int) -> np.ndarray:
        words = self._shards.get(k)
        if words is None:
            words = np.memmap(os.path.join(self.root, _shard_filename(k)),
                              dtype="<i4", mode="r")
            self._shards[k] = words
        return words

    def read_records(self, idx: np.ndarray):
        """Read the records of samples ``idx`` -> ((B, nb, wmax) payload
        zero-padded to the widest record, (B, nb) emax, bytes read).

        Records are gathered shard by shard (a stable sort by shard, so each
        touched shard's reads are contiguous) into request order.
        """
        idx = np.asarray(idx)
        wmax = int(self.widths[idx].max())
        payload = np.zeros((len(idx), self.nb, wmax), np.int32)
        emax = np.empty((len(idx), self.nb), np.int32)
        nbytes = 0
        for pos in np.argsort(idx // self.shard_size, kind="stable"):
            i = int(idx[pos])
            words = self._shard_words(self.shard_of(i))
            off, w = int(self._offsets[i]), int(self.widths[i])
            rec = np.asarray(words[off:off + self.nb * (w + 1)])
            payload[pos, :, :w] = rec[:self.nb * w].reshape(self.nb, w)
            emax[pos] = rec[self.nb * w:]
            nbytes += rec.nbytes
        return payload, emax, nbytes

    def get_batch(self, idx: np.ndarray):
        """Fetch + decode a batch with one kernel call on the store's
        device: the records padded to the in-batch max width, the whole
        (B * nb, wmax) stack decoded at once."""
        with obs_trace.span("data.get_batch", cat="data", store="sharded",
                            batch=len(idx)):
            t0 = time.perf_counter()
            payload, emax, nbytes = self.read_records(idx)
            throttle(nbytes, t0, self.bandwidth_mbs)
            t1 = time.perf_counter()
            batch, decode_s = on_device(
                self.device, lambda: decode_stacked_payloads(
                    *upload(self.device, payload, emax), self._padded_shape,
                    self.shape))
            self.stats.account(nbytes, read_seconds=t1 - t0,
                               decode_seconds=decode_s)
            return batch

    def as_device_resident(self, device: DeviceLike = None):
        """Upload the whole store to device memory once
        (:meth:`DeviceResidentCompressedStore.from_store`)."""
        from repro_torch.data.device_store import DeviceResidentCompressedStore
        return DeviceResidentCompressedStore.from_store(self, device=device)
