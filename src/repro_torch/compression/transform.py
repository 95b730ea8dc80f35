"""ZFP block transform primitives on int32 tensors, vectorized over blocks.

Counterpart of ``repro/compression/transform.py``: the same 4x4 block
layout, integer lifts, negabinary mapping and two-planes-per-word packing,
bit for bit.  Every function takes and returns tensors with a leading block
axis and runs on whatever device its inputs live on; these are the plain
versions the CUDA kernels (``repro_torch/csrc``) are held against.

Two runtime differences from XLA are handled here explicitly:

* XLA flushes f32 subnormals to zero on every input and output; PyTorch on
  the CPU does not.  :func:`flush_denormals` is applied to the inputs of
  :func:`quantize_blocks` and :func:`block_emax` and to the result of
  :func:`scale_by_pow2`, so the plain versions agree with the reference (and
  with the kernels, which are built with ``--ftz=true``).  The process-global
  ``torch.set_flush_denormal`` is deliberately not used.
* Powers of two are built in the exponent field (:func:`pow2_factors`),
  never with ``exp2``/``ldexp``, so every scale multiply is exact.

Non-finite inputs follow the TPU kernels the CUDA kernels replace: a NaN
propagates through each block maximum, the float-to-int conversion
saturates as XLA's does (NaN to 0, +inf to INT_MAX, -inf to INT_MIN), and
the block exponent comes from the exponent field (129 for an inf block).
"""
from __future__ import annotations

import torch

# Fixed-point scale: |x| / 2^emax < 1 maps to |i| <= 2^Q.
Q_FIXED_POINT = 28
# Bit planes stored, MSB-first: planes TOTAL_PLANES-1 .. 0.
TOTAL_PLANES = 30
# int32 words per block at full precision (2 planes of 16 lanes per word).
MAX_WORDS = (TOTAL_PLANES + 1) // 2

NEG_MASK = -1431655766          # 0xAAAAAAAA as an int32 bit pattern
FLT_MIN = 2.0 ** -126           # smallest normal f32
FLUSH_EMAX_BELOW = 2.0 ** -120  # blocks whose max |x| is smaller code as zero


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values -> sign-preserving zero, as XLA and ``--ftz`` do."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


# ---------------------------------------------------------------------------
# blockify / deblockify
# ---------------------------------------------------------------------------

def pad_to_blocks(x: torch.Tensor) -> torch.Tensor:
    """Edge-pad the trailing two dims of ``x`` up to multiples of 4."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % 4, (-w) % 4
    if ph or pw:
        lead = x.shape[:-2]
        x2 = x.reshape(-1, 1, h, w)
        x2 = torch.nn.functional.pad(x2, (0, pw, 0, ph), mode="replicate")
        x = x2.reshape(*lead, h + ph, w + pw)
    return x


def blockify(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (nb, 16) row-major 4x4 blocks. H, W divisible by 4."""
    *lead, h, w = x.shape
    x = x.reshape(*lead, h // 4, 4, w // 4, 4)
    x = x.movedim(-3, -2)                  # (..., h//4, w//4, 4, 4)
    return x.reshape(-1, 16)


def deblockify(blocks: torch.Tensor, shape) -> torch.Tensor:
    """(nb, 16) -> (..., H, W), inverse of :func:`blockify`."""
    *lead, h, w = shape
    x = blocks.reshape(*lead, h // 4, w // 4, 4, 4)
    x = x.movedim(-2, -3)
    return x.reshape(*shape)


# ---------------------------------------------------------------------------
# lifted decorrelation transform (int32; >> is arithmetic, + wraps)
# ---------------------------------------------------------------------------

def _fwd_lift4(x, y, z, w):
    x = x + w
    x = x >> 1
    w = w - x
    z = z + y
    z = z >> 1
    y = y - z
    x = x + z
    x = x >> 1
    z = z - x
    w = w + y
    w = w >> 1
    y = y - w
    w = w + (y >> 1)
    y = y - (w >> 1)
    return x, y, z, w


def _inv_lift4(x, y, z, w):
    y = y + (w >> 1)
    w = w - (y >> 1)
    y = y + w
    w = (w << 1) - y
    z = z + x
    x = (x << 1) - z
    y = y + z
    z = (z << 1) - y
    w = w + x
    x = (x << 1) - w
    return x, y, z, w


def fwd_transform_2d(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2D lift on (nb, 16) int32 blocks (rows then columns)."""
    b = blocks
    x, y, z, w = _fwd_lift4(b[:, 0::4], b[:, 1::4], b[:, 2::4], b[:, 3::4])
    b = torch.stack([x, y, z, w], dim=-1).reshape(b.shape[0], 16)
    x, y, z, w = _fwd_lift4(b[:, 0:4], b[:, 4:8], b[:, 8:12], b[:, 12:16])
    return torch.cat([x, y, z, w], dim=-1)


def inv_transform_2d(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse 2D lift on (nb, 16) int32 blocks (columns then rows)."""
    b = blocks
    x, y, z, w = _inv_lift4(b[:, 0:4], b[:, 4:8], b[:, 8:12], b[:, 12:16])
    b = torch.cat([x, y, z, w], dim=-1)
    x, y, z, w = _inv_lift4(b[:, 0::4], b[:, 1::4], b[:, 2::4], b[:, 3::4])
    return torch.stack([x, y, z, w], dim=-1).reshape(b.shape[0], 16)


# ---------------------------------------------------------------------------
# negabinary
# ---------------------------------------------------------------------------

def int2nb(i: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 -> negabinary bit pattern (int32 container)."""
    return (i + NEG_MASK) ^ NEG_MASK


def nb2int(u: torch.Tensor) -> torch.Tensor:
    """Negabinary bit pattern -> two's-complement int32."""
    return (u ^ NEG_MASK) - NEG_MASK


# ---------------------------------------------------------------------------
# bit-plane packing (MSB-first, 2 planes / word)
# ---------------------------------------------------------------------------

def _lanes(device) -> torch.Tensor:
    return torch.arange(16, dtype=torch.int32, device=device)[None, :]


def pack_planes(u: torch.Tensor, num_words: int) -> torch.Tensor:
    """Pack (nb, 16) negabinary patterns into (nb, num_words) int32 words.

    Word k holds plane TOTAL_PLANES-1-2k in bits 0..15 and plane
    TOTAL_PLANES-2-2k in bits 16..31 (``plane_lo << 16`` sets the sign bit).
    """
    lanes = _lanes(u.device)
    words = []
    for k in range(num_words):
        p_hi = TOTAL_PLANES - 1 - 2 * k
        p_lo = TOTAL_PLANES - 2 - 2 * k
        plane_hi = (((u >> p_hi) & 1) << lanes).sum(-1, dtype=torch.int32)
        if p_lo >= 0:
            plane_lo = (((u >> p_lo) & 1) << lanes).sum(-1, dtype=torch.int32)
        else:
            plane_lo = torch.zeros_like(plane_hi)
        words.append(plane_hi | (plane_lo << 16))
    return torch.stack(words, dim=-1)


def unpack_planes(payload: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_planes`: (nb, W) int32 -> (nb, 16) negabinary."""
    nb, num_words = payload.shape
    lanes = _lanes(payload.device)
    u = torch.zeros((nb, 16), dtype=torch.int32, device=payload.device)
    for k in range(num_words):
        word = payload[:, k:k + 1]                       # (nb, 1)
        p_hi = TOTAL_PLANES - 1 - 2 * k
        p_lo = TOTAL_PLANES - 2 - 2 * k
        u = u | (((word >> lanes) & 1) << p_hi)
        if p_lo >= 0:
            u = u | (((word >> (lanes + 16)) & 1) << p_lo)
    return u


# ---------------------------------------------------------------------------
# exponent / quantization helpers
# ---------------------------------------------------------------------------

def block_emax(blocks_f: torch.Tensor) -> torch.Tensor:
    """frexp-style exponent of max |value| per block: max|x| = m 2^emax.

    Read from the exponent field, as the Pallas and CUDA kernels read it:
    equal to ``frexp`` for finite values, 129 for a block holding +-inf
    (``jnp.frexp`` gives 0 there).  Blocks whose max magnitude is below
    2^-120, or NaN, flush to zero (emax = 0).
    """
    maxabs = flush_denormals(blocks_f).abs().amax(dim=-1)
    e = ((maxabs.view(torch.int32) >> 23) & 0xFF) - 126
    return torch.where(maxabs >= FLUSH_EMAX_BELOW, e, torch.zeros_like(e))


def pow2_factors(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split 2^e (int32 e) into two exact f32 power-of-two factors.

    Built in the exponent field, so ``x * f1 * f2`` is exact; the halves keep
    each factor in the normal f32 range for e in [-147, 147].
    """
    e = e.to(torch.int32)
    e1 = e >> 1                      # floor(e/2)
    f1 = ((e1 + 127) << 23).view(torch.float32)
    f2 = ((e - e1 + 127) << 23).view(torch.float32)
    return f1, f2


def scale_by_pow2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2^e`` via two exact power-of-two multiplies, flushed like XLA."""
    f1, f2 = pow2_factors(e)
    return flush_denormals((x * f1) * f2)


def to_int32_saturating(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA's convert and CUDA's ``cvt`` do it: NaN to 0,
    values at or above 2^31 to INT_MAX, below -2^31 to INT_MIN.  A plain
    ``.to(torch.int32)`` leaves those cases undefined (INT_MIN on the CPU)."""
    high, low = x >= 2.0 ** 31, x < -2.0 ** 31
    safe = torch.where(high | low | torch.isnan(x), 0.0, x).to(torch.int32)
    safe = torch.where(high, torch.iinfo(torch.int32).max, safe)
    return torch.where(low, torch.iinfo(torch.int32).min, safe)


def quantize_blocks(blocks_f: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """float (nb,16) -> fixed-point int32 with per-block scale 2^(Q-emax).

    ``torch.round`` rounds half to even, as ``jnp.round`` does; the
    conversion saturates (:func:`to_int32_saturating`).
    """
    scaled = scale_by_pow2(flush_denormals(blocks_f),
                           (Q_FIXED_POINT - emax)[:, None])
    return to_int32_saturating(torch.round(scaled))


def dequantize_blocks(blocks_i: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    return scale_by_pow2(blocks_i.to(torch.float32),
                         (emax - Q_FIXED_POINT)[:, None])


_F32_OVERFLOW_TIE = 2.0 ** 128 - 2.0 ** 103   # rounds to inf, anything below to max


def dequantize_minus(blocks_i: torch.Tensor, emax: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """``flush(deci * 2^(emax - 28) - x)`` rounded once, as a fused
    multiply-add: XLA contracts the dequantize's last multiply with the
    encoder's error subtraction, so the scaled value is neither flushed
    below 2^-126 nor overflowed above the f32 range before the difference.

    The product is exact in f64; the f64 difference and Knuth's two-sum
    error term give the exact difference, and a tie of the f32 rounding that
    the f64 rounding created is broken by the error term's sign.
    """
    f1, f2 = pow2_factors((emax - Q_FIXED_POINT)[:, None])
    p = (blocks_i.to(torch.float32) * f1).double() * f2.double()     # exact
    mx = -x.double()
    s = p + mx
    bp = s - p
    err = (p - (s - bp)) + (mx - bp)                   # p + mx == s + err exactly
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf).float())
    tie = (s != rd) & ((s - rd).abs() == (other.double() - s).abs()) & (err != 0)
    r = torch.where(tie & ((err > 0) == (other.double() > rd)), other, r)
    # the tie at the overflow threshold: below it the result is the largest f32
    below = (s.abs() == _F32_OVERFLOW_TIE) & (err * s < 0)
    r = torch.where(below, torch.sign(s).float() * torch.finfo(torch.float32).max, r)
    return flush_denormals(r)


def truncate_planes(u: torch.Tensor, nplanes: torch.Tensor) -> torch.Tensor:
    """Zero all bit planes below the top ``nplanes`` (ZFP-style truncation)."""
    shift = torch.clamp(TOTAL_PLANES - nplanes, 0, 31).to(torch.int32)
    if shift.ndim == 1:
        shift = shift[:, None]
    return u & (torch.full_like(shift, -1) << shift)
