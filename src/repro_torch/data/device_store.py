"""Device-resident compressed training data: upload once, decode in-step.

Counterpart of ``repro/data/device_store.py``.  The packed payload, emax
and nplanes of the whole dataset live in device memory; a batch is one
launch of the gathered fixed-accuracy decode, which reads the samples'
blocks where they lie and writes the batch in field layout, so no host
bytes move per batch and no gathered copy is made.  Device footprint is ``N * nb * (wmax + 2) * 4``
bytes; ``stored_bytes`` reports the logical two-level layout so ratios
match the host stores.  ``from_store`` uploads a sharded store (one the
port or the JAX package wrote) and carries its ``shard_size``, so
``make_loader`` draws the same shard-aware batch order as from the
host-streaming store.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compression import (TOTAL_PLANES, CompressedField,
                                     FixedAccuracyCodec,
                                     compressed_nbytes_batch, get_codec,
                                     trim_to_nplanes)
from repro_torch.data.store import on_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import IoStats


class DeviceResidentCompressedStore:
    """ArrayStore whose compressed payload lives on one device.

    ``get_batch`` accepts host indices and returns decoded (B, ...) float32;
    ``decode_indices`` is the same on device indices, the call the fused
    train step makes.  ``shard_size`` (set when built from a sharded store)
    makes the loader shard-aware.
    """

    def __init__(self, payload: torch.Tensor, emax: torch.Tensor,
                 nplanes: torch.Tensor, shape, padded_shape,
                 tolerances: np.ndarray, logical_bytes_per: np.ndarray,
                 shard_size: Optional[int] = None):
        if payload.dtype != torch.int32 or emax.dtype != torch.int32 \
                or nplanes.dtype != torch.int32:
            raise TypeError("resident arrays must be int32")
        if payload.ndim != 3 or emax.shape != payload.shape[:2] \
                or nplanes.shape != emax.shape:
            raise ValueError(
                f"inconsistent resident arrays: payload {tuple(payload.shape)}, "
                f"emax {tuple(emax.shape)}, nplanes {tuple(nplanes.shape)}")
        if not (payload.device == emax.device == nplanes.device):
            raise ValueError("resident arrays must share one device")
        self.payload = payload.contiguous()                 # (N, nb, W)
        self.emax = emax.contiguous()                       # (N, nb)
        self.nplanes = nplanes.contiguous()                 # (N, nb)
        self.device = payload.device
        self.shape = tuple(shape)
        self.padded_shape = tuple(padded_shape)
        self.num_samples = int(payload.shape[0])
        self.nb = int(payload.shape[1])
        self.sample_nbytes = int(np.prod(self.shape)) * 4
        self.tolerances = np.asarray(tolerances, np.float32)
        self.logical_bytes_per = np.asarray(logical_bytes_per, np.int64)
        self.logical_bytes = int(self.logical_bytes_per.sum())
        self.shard_size = shard_size        # None: flat (non-shard-aware) order
        self.stats = IoStats()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_store(cls, store, device: DeviceLike = None
                   ) -> "DeviceResidentCompressedStore":
        """One-time upload of a ``ShardedCompressedStore`` (disk or memory)
        to ``device`` (the card unless ``device="cpu"``).

        Shard records carry no per-block plane counts (planes beyond each
        block's count are zero by construction), so the resident
        ``nplanes`` is ``min(2 * width, 30)`` per sample: masking with it is
        a no-op on the stored zeros, which keeps decodes bit-exact.
        """
        dev = resolve_device(device)
        payload, emax, _ = store.read_records(np.arange(store.num_samples))
        nplanes = np.minimum(2 * store.widths, TOTAL_PLANES)[:, None] \
            .astype(np.int32) * np.ones((1, store.nb), np.int32)
        return cls(torch.from_numpy(payload).to(dev),
                   torch.from_numpy(emax).to(dev),
                   torch.from_numpy(nplanes).to(dev), store.shape,
                   store.padded_shape, store.tolerances,
                   store.logical_bytes_per, shard_size=store.shard_size)

    @classmethod
    def from_samples(cls, samples: Sequence[np.ndarray] | np.ndarray,
                     tolerances: Sequence[float] | np.ndarray,
                     shard_size: Optional[int] = None, codec=None,
                     device: DeviceLike = None
                     ) -> "DeviceResidentCompressedStore":
        """Encode channels-first samples (N, C, H, W) on ``device`` (the card
        unless ``device="cpu"``) at per-sample L-inf ``tolerances``, keeping
        true per-block plane counts.  ``codec`` defaults to the
        fixed-accuracy codec and must be one: the store's per-sample
        tolerances and plane counts mean nothing under another.
        ``shard_size`` makes the loader shard-aware, so batches come in the
        order a sharded store of that shard size gives."""
        if codec is None:
            codec = get_codec("fixed_accuracy")
        if not isinstance(codec, FixedAccuracyCodec):
            raise ValueError("a device-resident store holds fixed-accuracy "
                             f"payloads; got {type(codec).__name__}")
        dev = resolve_device(device)
        xs = torch.from_numpy(np.stack([np.asarray(s, np.float32)
                                        for s in samples])).to(dev)
        tols = np.asarray(tolerances, np.float32)
        cf = codec.encode_batch(xs, torch.from_numpy(tols).to(dev))
        del xs
        return cls.from_compressed(cf, tols, nbytes=codec.nbytes(cf),
                                   shard_size=shard_size)

    @classmethod
    def from_compressed(cls, cf: CompressedField, tolerances, nbytes=None,
                        shard_size: Optional[int] = None
                        ) -> "DeviceResidentCompressedStore":
        """Wrap a batched ``CompressedField`` where its tensors already live;
        nothing is re-encoded.  Payload words beyond the deepest kept plane
        are dropped (they are zero by construction)."""
        if nbytes is None:
            nbytes = compressed_nbytes_batch(cf, mode="fixed_accuracy")
        cf = trim_to_nplanes(cf)
        return cls(cf.payload, cf.emax, cf.nplanes, cf.shape, cf.padded_shape,
                   np.asarray(tolerances, np.float32),
                   np.asarray(torch.as_tensor(nbytes).cpu(), np.int64),
                   shard_size=shard_size)

    # -- store protocol ------------------------------------------------------

    @property
    def stored_bytes(self) -> int:
        return self.logical_bytes

    @property
    def resident_bytes(self) -> int:
        """Actual device footprint of the resident arrays."""
        return (self.payload.numel() + self.emax.numel()
                + self.nplanes.numel()) * 4

    @property
    def ratio(self) -> float:
        return self.sample_nbytes * self.num_samples / max(self.logical_bytes, 1)

    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """Gather + decode a batch of sample indices already on the store's
        device -> (B, ...) float32: one kernel launch on the card.  An index
        outside [0, num_samples) raises (on the card: a device-side fault)."""
        return ops.zfp_decode_blocks_fa_gather(
            self.payload, self.emax, self.nplanes, idx.to(torch.int64),
            self.padded_shape, self.shape)

    def get_batch(self, idx: np.ndarray) -> torch.Tensor:
        """ArrayStore-compatible batch access from host indices.  No host
        bytes are read; only the decode time is accounted (on the current
        stream, after the work queued there)."""
        with obs_trace.span("data.get_batch", cat="data",
                            store="device_resident", batch=len(idx)):
            idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
            batch, decode_s = on_device(
                self.device, lambda: self.decode_indices(idx_t.to(self.device)),
                side_stream=False)
            self.stats.account(decode_seconds=decode_s)
            return batch
