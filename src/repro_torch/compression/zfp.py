"""Fixed-accuracy (error-bounded) and fixed-rate ZFP codec on tensors.

Counterpart of ``repro/compression/zfp.py``: a deterministic
two-planes-per-int32-word layout, with per-block plane counts and the L-inf
bound verified per block in fixed-accuracy mode, and a uniform plane count
in fixed-rate mode.  The batch functions route the per-block work through
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernel for tensors
on the card and runs the plain version for tensors on the CPU; both give
the same bits.

The stats-only roundtrip of Algorithm 1's search (``FAEncodeState``,
``fa_precompute_batch``, ``fa_plane_counts``, ``fa_stats_batch``) is plain
PyTorch on either device, as it is plain jnp in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.compression import transform as T

GUARD_BITS = 2          # optimistic initial guess; correction passes enforce bound
MAX_FIX_ITERS = 6


@dataclasses.dataclass
class CompressedField:
    """Tensors of one (batched) compressed array.

    payload : (N, nb, W) int32 -- packed bit planes; planes beyond
                                  nplanes[b] are zero
    emax    : (N, nb) int32    -- per-block shared exponent
    nplanes : (N, nb) int32    -- per-block kept planes
    shape   : one sample's original shape
    padded_shape : one sample's shape after padding the trailing dims to 4
    """
    payload: torch.Tensor
    emax: torch.Tensor
    nplanes: torch.Tensor
    shape: Tuple[int, ...]
    padded_shape: Tuple[int, ...]


def floor_log2(tols: torch.Tensor) -> torch.Tensor:
    """Exact ``floor(log2(tol))`` for positive normal f32 tolerances.

    Taken from the binary exponent (``tol = m 2^e``, m in [0.5, 1)), so it is
    exact at every power of two.  XLA's CPU ``log2`` lands just under ``k``
    at a dozen powers of two >= 2^13, where the JAX package therefore guesses
    one plane more; the error bound holds either way (ROADMAP Queue 3, F2).
    """
    _, e = torch.frexp(tols.to(torch.float32))
    return (e - 1).to(torch.int32)


def fixed_accuracy_planes(x: torch.Tensor, u_full: torch.Tensor,
                          emax: torch.Tensor, tols: torch.Tensor,
                          log2tols: torch.Tensor) -> torch.Tensor:
    """Per-block plane counts of the fixed-accuracy encode, (nb,) int32.

    ``x`` (nb, 16) flushed block values, ``u_full`` their full-precision
    negabinary coefficients, ``emax`` (nb,), ``tols`` (nb,) flushed
    tolerances and ``log2tols`` (nb,) ``floor(log2(tol))``.  The guess
    ``emax - log2tol + GUARD_BITS`` (zero for an all-zero block), then up to
    ``MAX_FIX_ITERS`` bound-verification passes that add two planes wherever
    the realized L-inf error exceeds the tolerance.  A pass where no block
    fails changes nothing, and neither would the passes after it, so the
    loop stops there.  The error is
    :func:`~repro_torch.compression.transform.dequantize_minus`, one fused
    multiply-add as XLA forms it.
    """
    npl = torch.clamp(emax - log2tols.to(torch.int32) + GUARD_BITS, 0,
                      T.TOTAL_PLANES).to(torch.int32)
    npl = torch.where((u_full == 0).all(dim=-1), torch.zeros_like(npl), npl)
    for _ in range(MAX_FIX_ITERS):
        u = T.truncate_planes(u_full, npl)
        err = T.dequantize_minus(T.inv_transform_2d(T.nb2int(u)), emax,
                                 x).abs().amax(dim=-1)
        bad = err > tols
        if not bool(bad.any()):
            break
        npl = torch.where(bad, torch.clamp(npl + 2, max=T.TOTAL_PLANES), npl)
    return npl


def encode_fixed_rate_batch(xs: torch.Tensor,
                            bits_per_value: int) -> CompressedField:
    """Batched fixed-rate encode: the top ``bits_per_value`` planes of every
    block, ``(bits_per_value + 1) // 2`` words per block.

    All N samples' blocks are flattened into one (N*nb, 16) grid and go
    through one encode call; the payload is (N, nb, W), emax and the
    uniform nplanes (N, nb).
    """
    from repro_torch.kernels import ops
    n = xs.shape[0]
    xp = T.pad_to_blocks(xs.to(torch.float32))
    blocks = T.blockify(xp).contiguous()               # (N * nb, 16)
    payload, emax = ops.zfp_encode_blocks(blocks, bits_per_value)
    nb = blocks.shape[0] // n
    nplanes = torch.full((n, nb), bits_per_value, dtype=torch.int32,
                         device=xs.device)
    return CompressedField(payload.reshape(n, nb, -1), emax.reshape(n, nb),
                           nplanes, tuple(xs.shape[1:]), tuple(xp.shape[1:]))


def encode_fixed_accuracy_batch(xs: torch.Tensor,
                                tols: torch.Tensor) -> CompressedField:
    """Batched error-bounded encode: max |x - decode| <= tol per sample.

    xs   : (N, ...) float tensor, compressed over the trailing two dims
    tols : (N,) per-sample L-inf tolerances (positive, normal f32)

    All N samples' blocks go through one encode call on one (N*nb, 16) grid.
    """
    from repro_torch.kernels import ops
    n = xs.shape[0]
    xp = T.pad_to_blocks(xs.to(torch.float32))
    blocks = T.blockify(xp).contiguous()               # (N * nb, 16)
    nb = blocks.shape[0] // n
    tols_b = torch.as_tensor(tols, dtype=torch.float32,
                             device=xs.device).repeat_interleave(nb)
    payload, emax, nplanes = ops.zfp_encode_blocks_fa(blocks, tols_b)
    return CompressedField(payload.reshape(n, nb, -1), emax.reshape(n, nb),
                           nplanes.reshape(n, nb), tuple(xs.shape[1:]),
                           tuple(xp.shape[1:]))


def decode_batch(cf: CompressedField) -> torch.Tensor:
    """Decode a batched CompressedField -> (N, ...) float32."""
    from repro_torch.compression.api import decode_stacked_payloads
    return decode_stacked_payloads(cf.payload, cf.emax, cf.padded_shape,
                                   cf.shape, cf.nplanes)


# ---------------------------------------------------------------------------
# single-sample forms: one unbatched field (payload (nb, W), emax and
# nplanes (nb,)), through the batch forms above on a batch of one
# ---------------------------------------------------------------------------

def _batched(cf: CompressedField) -> CompressedField:
    return CompressedField(cf.payload[None], cf.emax[None], cf.nplanes[None],
                           cf.shape, cf.padded_shape)


def _unbatched(cf: CompressedField) -> CompressedField:
    return CompressedField(cf.payload[0], cf.emax[0], cf.nplanes[0], cf.shape,
                           cf.padded_shape)


def encode_fixed_rate(x: torch.Tensor, bits_per_value: int) -> CompressedField:
    """Fixed-rate encode of one array, its trailing two dims blocked."""
    return _unbatched(encode_fixed_rate_batch(x[None], bits_per_value))


def decode_fixed_rate(cf: CompressedField) -> torch.Tensor:
    """Fixed-rate decode of one field at ``2 * W`` planes, no plane mask."""
    from repro_torch.compression.api import decode_stacked_payloads
    return decode_stacked_payloads(cf.payload[None], cf.emax[None],
                                   cf.padded_shape, cf.shape)[0]


def encode_fixed_accuracy(x: torch.Tensor, tol: float) -> CompressedField:
    """Error-bounded encode of one array: max |x - decode| <= tol."""
    tols = torch.full((1,), float(tol), dtype=torch.float32, device=x.device)
    return _unbatched(encode_fixed_accuracy_batch(x[None], tols))


def decode(cf: CompressedField) -> torch.Tensor:
    """Decode one field of either mode (its per-block plane counts)."""
    return decode_batch(_batched(cf))[0]


# ---------------------------------------------------------------------------
# stats-only fixed-accuracy roundtrip (Algorithm 1's inner loop)
# ---------------------------------------------------------------------------
# The tolerance search (core/tolerance.py) evaluates many tolerances on the
# SAME sample stack.  What does not depend on the tolerance -- flush,
# quantize, forward lift, negabinary -- is computed once into FAEncodeState;
# each search round then only re-derives the per-block plane counts and
# reduces the truncated decode to per-sample L1 and logical bytes.  No
# payload is packed or unpacked: the numbers equal the encode -> decode
# roundtrip's bit for bit (packing at full width is exact).


@dataclasses.dataclass
class FAEncodeState:
    """Tolerance-independent encode state of an (N, ...) sample stack.

    xs     : (N, ...) float32 samples (unpadded)
    blocks : (N*nb, 16) float32 padded block values, flushed as the
             encoder flushes them
    u_full : (N*nb, 16) int32 full-precision negabinary coefficients
    emax   : (N*nb,) int32 per-block exponents
    padded_shape : one sample's shape after padding
    """
    xs: torch.Tensor
    blocks: torch.Tensor
    u_full: torch.Tensor
    emax: torch.Tensor
    padded_shape: Tuple[int, ...]


def fa_precompute_batch(xs: torch.Tensor) -> FAEncodeState:
    """The tolerance-independent half of the fixed-accuracy encode."""
    xs = xs.to(torch.float32)
    xp = T.pad_to_blocks(xs)
    blocks = T.flush_denormals(T.blockify(xp))           # (N * nb, 16)
    emax = T.block_emax(blocks)
    u_full = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(blocks, emax)))
    return FAEncodeState(xs, blocks, u_full, emax, tuple(xp.shape[1:]))


def fa_plane_counts(state: FAEncodeState, tols: torch.Tensor) -> torch.Tensor:
    """(N,) tolerances -> (N, nb) per-block plane counts, the encoder's
    (:func:`fixed_accuracy_planes` on the same blocks)."""
    n = state.xs.shape[0]
    nb = state.emax.shape[0] // n
    tols_b = torch.as_tensor(tols, dtype=torch.float32,
                             device=state.xs.device).repeat_interleave(nb)
    npl = fixed_accuracy_planes(state.blocks, state.u_full, state.emax,
                                T.flush_denormals(tols_b), floor_log2(tols_b))
    return npl.reshape(n, nb)


def sample_l1(xd: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Per-sample mean |xd - xs| over every axis but the first, (N,) f32.

    The f32 terms are summed in f64 and the mean rounded once to f32, so
    the result does not depend on the order a device reduces in: the card
    and the CPU give the same bits.  The fused and unfused searches both
    reduce through this function."""
    return (xd - xs).abs().double().mean(dim=tuple(range(1, xs.dim()))).float()


def fa_stats_batch(state: FAEncodeState, tols: torch.Tensor):
    """Stats-only roundtrip: per-sample ``(l1, nbytes)`` at tolerances
    ``tols``, equal bit for bit to ``sample_l1(decode(encode(xs, tols)),
    xs)`` and ``nbytes(encode(xs, tols))``."""
    n = state.xs.shape[0]
    npl = fa_plane_counts(state, tols)                   # (N, nb)
    u = T.truncate_planes(state.u_full, npl.reshape(-1))
    dec = T.dequantize_blocks(T.inv_transform_2d(T.nb2int(u)), state.emax)
    xd = crop(T.deblockify(dec, (n,) + tuple(state.padded_shape)),
              state.xs.shape[1:])
    nbytes = (_header_bytes_per_block("fixed_accuracy") * npl.shape[1]
              + 2 * npl.to(torch.int64).sum(dim=-1))
    return sample_l1(xd, state.xs), nbytes


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------

def _header_bytes_per_block(mode: str) -> int:
    """Per-block stream header: 1 byte emax always; fixed-accuracy adds a
    1-byte plane count.  ``mode`` is explicit, never inferred from the data:
    a fixed-accuracy stream whose counts happen to be uniform still ships
    them."""
    if mode == "fixed_accuracy":
        return 2
    if mode == "fixed_rate":
        return 1
    raise ValueError(f"unknown codec mode {mode!r}")


def compressed_nbytes_batch(cf: CompressedField,
                            mode: str = "fixed_accuracy") -> torch.Tensor:
    """Per-sample logical bytes of the two-level layout: the ``mode``'s
    header per block plus 2 bytes per kept plane of 16 lanes.  (N,) int64."""
    nb = cf.nplanes.shape[-1]
    return (_header_bytes_per_block(mode) * nb
            + 2 * cf.nplanes.to(torch.int64).sum(dim=-1))


def compressed_nbytes(cf: CompressedField,
                      mode: str = "fixed_accuracy") -> torch.Tensor:
    """Logical bytes of one field, 0-d int64 (see
    :func:`compressed_nbytes_batch`)."""
    return compressed_nbytes_batch(_batched(cf), mode)[0]


def compression_ratio(cf: CompressedField,
                      mode: str = "fixed_accuracy") -> torch.Tensor:
    """Raw f32 bytes of one field over its logical compressed bytes, one
    f32 division as JAX divides (``int / tensor`` would multiply by a
    rounded reciprocal)."""
    nbytes = compressed_nbytes(cf, mode)
    raw = torch.tensor(int(np.prod(cf.shape)) * 4, dtype=torch.float32,
                       device=nbytes.device)
    return raw / nbytes.to(torch.float32)


def trim_to_nplanes(cf: CompressedField) -> CompressedField:
    """Drop payload words beyond ``ceil(max(nplanes) / 2)``.

    Words past a block's kept planes are zero by construction and the decode
    accepts any width covering the deepest kept plane, so trimming is
    bit-exact.  Reads ``nplanes`` on the host: call at store build time.
    """
    npl = int(cf.nplanes.max()) if cf.nplanes.numel() else 0
    w = max(int(np.ceil(npl / 2)), 1)
    return CompressedField(cf.payload[..., :w].contiguous(), cf.emax,
                           cf.nplanes, cf.shape, cf.padded_shape)


def crop(xp: torch.Tensor, shape) -> torch.Tensor:
    """Crop the trailing dims of a padded (B, ...) batch to ``shape``."""
    if tuple(xp.shape[1:]) == tuple(shape):
        return xp
    return xp[(slice(None),) + tuple(slice(0, s) for s in shape)]
