"""Plain PyTorch versions of the codec kernels.

Counterparts of ``zfp_{encode,decode}_blocks{,_fa}_ref`` in
``repro/kernels/ref.py``, built on :mod:`repro_torch.compression.transform`.
The CPU tests hold them against the JAX package bit for bit, and the CUDA
kernels in ``repro_torch/csrc`` are held against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.compression import transform as T


def zfp_encode_blocks_ref(blocks_f: torch.Tensor, bits_per_value: int):
    """Fixed-rate encode: (nb, 16) f32 -> ((nb, W) int32 payload, (nb,)
    int32 emax), W = (bits_per_value + 1) // 2.  Inputs are flushed as XLA
    flushes them."""
    if not 1 <= bits_per_value <= T.TOTAL_PLANES:
        raise ValueError(f"bits_per_value must be in [1, {T.TOTAL_PLANES}], "
                         f"got {bits_per_value}")
    x = T.flush_denormals(blocks_f)
    emax = T.block_emax(x)
    u = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(x, emax)))
    nplanes = torch.full((x.shape[0],), bits_per_value, dtype=torch.int32,
                         device=x.device)
    u = T.truncate_planes(u, nplanes)
    return T.pack_planes(u, (bits_per_value + 1) // 2), emax


def zfp_decode_blocks_ref(payload: torch.Tensor, emax: torch.Tensor,
                          bits_per_value: int) -> torch.Tensor:
    """Fixed-rate decode: ((nb, W) int32, (nb,) int32) -> (nb, 16) f32.
    Planes beyond the stored words are simply absent, so no mask."""
    del bits_per_value
    u = T.unpack_planes(payload)
    return T.dequantize_blocks(T.inv_transform_2d(T.nb2int(u)), emax)


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
