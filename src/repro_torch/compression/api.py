"""Codec seam: one interface over the compression paths the port has.

Counterpart of ``repro/compression/api.py``, with the port's own registry:

  get_codec("fixed_accuracy", tolerance=1e-3)

There is no backend switch.  The device of the tensors decides: a tensor on
the card goes through the CUDA kernels, a tensor on the CPU through their
plain versions (:mod:`repro_torch.kernels.ops`).  Codecs the port does not
have yet raise ``KeyError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.compression import transform as T
from repro_torch.compression.zfp import (CompressedField,
                                         compressed_nbytes_batch, crop,
                                         encode_fixed_accuracy_batch)


def decode_stacked_payloads(payload, emax, padded_shape, shape,
                            nplanes) -> torch.Tensor:
    """One-kernel decode of a stacked batch of fixed-accuracy streams.

    payload (B, nb, wmax) int32, emax and nplanes (B, nb) int32 ->
    (B, *shape) float32.  Each block's planes beyond its count are masked,
    so payloads padded to a common width decode exactly.
    """
    from repro_torch.kernels import ops
    b, nb, wmax = payload.shape
    blocks = ops.zfp_decode_blocks_fa(payload.reshape(b * nb, wmax).contiguous(),
                                      emax.reshape(b * nb).contiguous(),
                                      nplanes.reshape(b * nb).contiguous())
    return crop(T.deblockify(blocks, (b,) + tuple(padded_shape)), shape)


@dataclasses.dataclass(frozen=True)
class FixedAccuracyCodec:
    """Error-bounded mode: per-sample L-inf tolerances, per-block plane counts.

    ``tolerance`` is the default when ``encode_batch`` gets no per-sample
    tolerances.
    """
    tolerance: Optional[float] = None

    @property
    def name(self) -> str:
        return "fixed_accuracy"

    def encode_batch(self, xs: torch.Tensor, tolerances=None) -> CompressedField:
        if tolerances is None:
            if self.tolerance is None:
                raise ValueError("fixed_accuracy encode needs per-sample "
                                 "tolerances or a codec-level default")
            tolerances = torch.full((xs.shape[0],), self.tolerance,
                                    dtype=torch.float32)
        return encode_fixed_accuracy_batch(xs, torch.as_tensor(
            tolerances, dtype=torch.float32, device=xs.device))

    def decode_batch(self, cf: CompressedField) -> torch.Tensor:
        return decode_stacked_payloads(cf.payload, cf.emax, cf.padded_shape,
                                       cf.shape, cf.nplanes)

    def nbytes(self, cf: CompressedField) -> torch.Tensor:
        return compressed_nbytes_batch(cf)


_REGISTRY = {"fixed_accuracy": FixedAccuracyCodec}
_NOT_PORTED = {
    "fixed_rate": "ROADMAP Queue 1 item 1 and Queue 2 items 3-4 "
                  "(fixed-rate codec and its two kernels)",
    "fixed_accuracy+residual": "ROADMAP Queue 1 item 8 "
                               "(ResidualCorrectedCodec)",
}


def codec_names() -> list:
    return sorted(_REGISTRY)


def get_codec(name: str, **params):
    """Instantiate a codec of the port: ``get_codec("fixed_accuracy",
    tolerance=1e-3)``."""
    if name in _NOT_PORTED:
        raise KeyError(f"codec {name!r} is not ported yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; registered: {codec_names()}")
    return _REGISTRY[name](**params)
