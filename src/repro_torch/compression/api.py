"""Codec seam: one interface over the compression paths the port has.

Counterpart of ``repro/compression/api.py``, with the port's own registry:

  get_codec("fixed_accuracy", tolerance=1e-3)
  get_codec("fixed_rate", bits_per_value=12)

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
                                         encode_fixed_accuracy_batch,
                                         encode_fixed_rate_batch,
                                         fa_precompute_batch, fa_stats_batch)


def decode_stacked_payloads(payload, emax, padded_shape, shape,
                            nplanes=None) -> torch.Tensor:
    """One-kernel decode of a stacked batch of packed ZFP streams.

    payload (B, nb, wmax) int32, emax (B, nb) int32 -> (B, *shape) float32.
    Samples narrower than wmax are zero-padded (zero words decode as zero
    planes), so the result is exact per sample.  Without ``nplanes`` the
    batch goes through the fixed-rate decode at ``2 * wmax`` planes, as the
    host-streaming stores decode; with ``nplanes`` (B, nb) the
    fixed-accuracy decode masks each block's dropped planes.
    """
    from repro_torch.kernels import ops
    b, nb, wmax = payload.shape
    flat_p = payload.reshape(b * nb, wmax).contiguous()
    flat_e = emax.reshape(b * nb).contiguous()
    if nplanes is None:
        blocks = ops.zfp_decode_blocks(flat_p, flat_e, 2 * wmax)
    else:
        blocks = ops.zfp_decode_blocks_fa(flat_p, flat_e,
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
        return compressed_nbytes_batch(cf, mode="fixed_accuracy")

    # stats-only roundtrip for Algorithm 1's search: the tolerance-
    # independent encode state once, then (L1, nbytes) per candidate
    # tolerance with no packing (plain PyTorch on either device)
    precompute = staticmethod(fa_precompute_batch)
    stats = staticmethod(fa_stats_batch)


@dataclasses.dataclass(frozen=True)
class FixedRateCodec:
    """Uniform bits-per-value mode (dense payload, 1-byte block headers)."""
    bits_per_value: int = 12

    @property
    def name(self) -> str:
        return "fixed_rate"

    def encode_batch(self, xs: torch.Tensor, tolerances=None) -> CompressedField:
        del tolerances                   # rate is fixed; no error bound
        return encode_fixed_rate_batch(xs, self.bits_per_value)

    def decode_batch(self, cf: CompressedField) -> torch.Tensor:
        return decode_stacked_payloads(cf.payload, cf.emax, cf.padded_shape,
                                       cf.shape, cf.nplanes)

    def nbytes(self, cf: CompressedField) -> torch.Tensor:
        return compressed_nbytes_batch(cf, mode="fixed_rate")


_REGISTRY = {"fixed_accuracy": FixedAccuracyCodec,
             "fixed_rate": FixedRateCodec}
_NOT_PORTED = {
    "fixed_accuracy+residual": "ROADMAP Queue 1 item 8 "
                               "(ResidualCorrectedCodec)",
}


def codec_names() -> list:
    return sorted(_REGISTRY)


def get_codec(name: str, **params):
    """Instantiate a codec of the port: ``get_codec("fixed_accuracy",
    tolerance=1e-3)`` or ``get_codec("fixed_rate", bits_per_value=12)``."""
    if name in _NOT_PORTED:
        raise KeyError(f"codec {name!r} is not ported yet: {_NOT_PORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; registered: {codec_names()}")
    return _REGISTRY[name](**params)


def codec_from_plan(codec_plan):
    """Codec for a datagen ``CodecPlan``-shaped object (duck-typed: ``mode``
    plus the mode's parameters).  The plan's ``use_pallas`` selects nothing
    here: the device of the tensors decides, as for every codec of the
    port."""
    if codec_plan.mode == "fixed_accuracy":
        return get_codec("fixed_accuracy", tolerance=codec_plan.tolerance)
    if codec_plan.mode == "fixed_rate":
        return get_codec("fixed_rate", bits_per_value=codec_plan.bits_per_value)
    raise ValueError(f"unknown codec mode {codec_plan.mode!r}")
