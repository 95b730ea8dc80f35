"""Plain PyTorch versions of the fixed-accuracy codec kernels.

Counterparts of ``zfp_encode_blocks_fa_ref`` / ``zfp_decode_blocks_fa_ref``
in ``repro/kernels/ref.py``, built on :mod:`repro_torch.compression.transform`.
The CPU tests hold them against the JAX package bit for bit, and the CUDA
kernels in ``repro_torch/csrc`` are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.compression import transform as T


def zfp_encode_blocks_fa_ref(blocks_f: torch.Tensor, tols: torch.Tensor,
                             log2tols: torch.Tensor):
    """Fixed-accuracy encode with per-block L-inf tolerances.

    (nb, 16) f32 blocks, (nb,) f32 tols, (nb,) int32 ``floor(log2(tols))``
    -> ((nb, MAX_WORDS) int32 payload, (nb,) int32 emax, (nb,) int32
    nplanes).  Plane guess ``emax - log2tol + GUARD_BITS``, zero-block
    short-circuit, then ``MAX_FIX_ITERS`` bound-verification passes that add
    two planes wherever the realized L-inf error exceeds the tolerance.
    """
    from repro_torch.compression.zfp import GUARD_BITS, MAX_FIX_ITERS
    x = T.flush_denormals(blocks_f)
    tols = T.flush_denormals(tols.to(torch.float32))
    emax = T.block_emax(x)
    u_full = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(x, emax)))
    npl = torch.clamp(emax - log2tols.to(torch.int32) + GUARD_BITS, 0,
                      T.TOTAL_PLANES).to(torch.int32)
    npl = torch.where((u_full == 0).all(dim=-1), torch.zeros_like(npl), npl)

    def block_err(npl):
        u = T.truncate_planes(u_full, npl)
        dec = T.dequantize_blocks(T.inv_transform_2d(T.nb2int(u)), emax)
        return T.flush_denormals(dec - x).abs().amax(dim=-1)

    for _ in range(MAX_FIX_ITERS):
        bad = block_err(npl) > tols
        npl = torch.where(bad, torch.clamp(npl + 2, max=T.TOTAL_PLANES), npl)
    payload = T.pack_planes(T.truncate_planes(u_full, npl), T.MAX_WORDS)
    return payload, emax, npl


def zfp_decode_blocks_fa_ref(payload: torch.Tensor, emax: torch.Tensor,
                             nplanes: torch.Tensor) -> torch.Tensor:
    """Fixed-accuracy decode: per-block plane counts mask the unpacked stream.

    payload (nb, W) int32, emax/nplanes (nb,) int32 -> (nb, 16) f32.
    """
    u = T.truncate_planes(T.unpack_planes(payload), nplanes.to(torch.int32))
    return T.dequantize_blocks(T.inv_transform_2d(T.nb2int(u)), emax)
