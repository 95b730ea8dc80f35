"""Plain encode and decode of a produced store (format ``repro-shards-v1``).

A frozen copy of the plain fixed-accuracy encode (``encode_records``: the
plane guess, the bound-verification passes with the fused
dequantize-and-subtract, the packing) and decode (negabinary bit planes,
two planes a word MSB first, the inverse 4-point lifts, the exact
power-of-two dequantisation with denormals flushed) and its own reader of
the shard files.  A sample's record is ``nb * width`` little-endian int32
payload words (``(nb, width)`` row-major) followed by ``nb`` emax words;
planes past a block's stored words are zero, so no plane mask is needed.
"""
from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np
import torch

TOTAL_PLANES = 30
Q_FIXED_POINT = 28
NEG_MASK = -1431655766          # 0xAAAAAAAA as an int32
FLT_MIN = 2.0 ** -126


def flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def unpack_planes(payload: torch.Tensor) -> torch.Tensor:
    """(nb, W) int32 words -> (nb, 16) negabinary lanes."""
    nb, num_words = payload.shape
    lanes = torch.arange(16, dtype=torch.int32, device=payload.device)[None, :]
    u = torch.zeros((nb, 16), dtype=torch.int32, device=payload.device)
    for k in range(num_words):
        word = payload[:, k:k + 1]
        u = u | (((word >> lanes) & 1) << (TOTAL_PLANES - 1 - 2 * k))
        if TOTAL_PLANES - 2 - 2 * k >= 0:
            u = u | (((word >> (lanes + 16)) & 1) << (TOTAL_PLANES - 2 - 2 * k))
    return u


def _inv_lift(x, y, z, w):
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


def inverse_transform(b: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D lift on (nb, 16) int32 blocks: columns, then rows."""
    x, y, z, w = _inv_lift(b[:, 0:4], b[:, 4:8], b[:, 8:12], b[:, 12:16])
    b = torch.cat([x, y, z, w], dim=-1)
    x, y, z, w = _inv_lift(b[:, 0::4], b[:, 1::4], b[:, 2::4], b[:, 3::4])
    return torch.stack([x, y, z, w], dim=-1).reshape(b.shape[0], 16)


def dequantize(ints: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """ints * 2^(emax - 28), as two exact power-of-two multiplies."""
    e = (emax - Q_FIXED_POINT).to(torch.int32)[:, None]
    e1 = e >> 1
    f1 = ((e1 + 127) << 23).view(torch.float32)
    f2 = ((e - e1 + 127) << 23).view(torch.float32)
    return flush((flush(ints.to(torch.float32)) * f1) * f2)


def decode_blocks(payload: torch.Tensor, emax: torch.Tensor) -> torch.Tensor:
    """(nb, W) payload words, (nb,) emax -> (nb, 16) float32 blocks."""
    u = unpack_planes(payload)
    return dequantize(inverse_transform((u ^ NEG_MASK) - NEG_MASK), emax)


class ShardStore:
    """Read-only view of a produced store's manifest and shard files."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.json")) as f:
            m = json.load(f)
        if m.get("format") != "repro-shards-v1":
            raise ValueError(f"unknown store format {m.get('format')!r}")
        self.shape = tuple(m["shape"])
        self.padded_shape = tuple(m["padded_shape"])
        self.nb = int(m["block_count"])
        self.shard_size = int(m["shard_size"])
        self.num_samples = int(m["num_samples"])
        self.widths = np.asarray(m["widths"], np.int64)
        self.shards = [np.fromfile(os.path.join(root, s["file"]), dtype="<i4")
                       for s in m["shards"]]
        rec = self.nb * (self.widths + 1)
        self.offsets = np.zeros(self.num_samples, np.int64)
        for k in range(len(self.shards)):
            lo, hi = k * self.shard_size, min((k + 1) * self.shard_size, self.num_samples)
            self.offsets[lo:hi] = np.cumsum(rec[lo:hi]) - rec[lo:hi]

    def record(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        w = int(self.widths[i])
        words = self.shards[i // self.shard_size]
        rec = words[self.offsets[i]:self.offsets[i] + self.nb * (w + 1)]
        return rec[:self.nb * w].reshape(self.nb, w), rec[self.nb * w:]

    def decode(self, idx: Sequence[int], device) -> torch.Tensor:
        """Samples ``idx`` -> (B, C, H, W) float32 on ``device``."""
        recs = [self.record(int(i)) for i in idx]
        wmax = max(p.shape[1] for p, _ in recs)
        payload = np.zeros((len(recs), self.nb, wmax), np.int32)
        for j, (p, _) in enumerate(recs):
            payload[j, :, :p.shape[1]] = p
        emax = np.stack([e for _, e in recs]).astype(np.int32)
        blocks = decode_blocks(torch.from_numpy(payload.reshape(-1, wmax)).to(device),
                               torch.from_numpy(emax.reshape(-1)).to(device))
        shape = (len(recs),) + self.padded_shape
        *lead, h, w = shape
        x = blocks.reshape(*lead, h // 4, w // 4, 4, 4).movedim(-2, -3).reshape(shape)
        return x[..., :self.shape[-2], :self.shape[-1]].contiguous()


# -- the fixed-accuracy encode (a frozen copy of the plain encode) ------------------

FLUSH_EMAX_BELOW = 2.0 ** -120
GUARD_BITS = 2
MAX_FIX_ITERS = 6
MAX_WORDS = (TOTAL_PLANES + 1) // 2
_F32_OVERFLOW_TIE = 2.0 ** 128 - 2.0 ** 103


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    return flush(x)


def _lanes(device) -> torch.Tensor:
    return torch.arange(16, dtype=torch.int32, device=device)[None, :]


def nb2int(u: torch.Tensor) -> torch.Tensor:
    return (u ^ NEG_MASK) - NEG_MASK


def inv_transform_2d(b: torch.Tensor) -> torch.Tensor:
    return inverse_transform(b)


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


def fwd_transform_2d(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2D lift on (nb, 16) int32 blocks (rows then columns)."""
    b = blocks
    x, y, z, w = _fwd_lift4(b[:, 0::4], b[:, 1::4], b[:, 2::4], b[:, 3::4])
    b = torch.stack([x, y, z, w], dim=-1).reshape(b.shape[0], 16)
    x, y, z, w = _fwd_lift4(b[:, 0:4], b[:, 4:8], b[:, 8:12], b[:, 12:16])
    return torch.cat([x, y, z, w], dim=-1)


def int2nb(i: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 -> negabinary bit pattern (int32 container)."""
    return (i + NEG_MASK) ^ NEG_MASK


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
                      TOTAL_PLANES).to(torch.int32)
    npl = torch.where((u_full == 0).all(dim=-1), torch.zeros_like(npl), npl)
    for _ in range(MAX_FIX_ITERS):
        u = truncate_planes(u_full, npl)
        err = dequantize_minus(inv_transform_2d(nb2int(u)), emax,
                                 x).abs().amax(dim=-1)
        bad = err > tols
        if not bool(bad.any()):
            break
        npl = torch.where(bad, torch.clamp(npl + 2, max=TOTAL_PLANES), npl)
    return npl


def blockify(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (nb, 16) row-major 4x4 blocks (H, W multiples of 4)."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // 4, 4, w // 4, 4).movedim(-3, -2).reshape(-1, 16)


def encode_records(samples: torch.Tensor, tol: float) -> list:
    """The shard records of channels-first samples (N, C, H, W) at the
    L-inf tolerance ``tol``: per sample, its ``nb * width`` payload words
    and its ``nb`` emax words (int32), ``width = ceil(max planes / 2) or 1``."""
    n = samples.shape[0]
    x = flush(blockify(samples.to(torch.float32)).contiguous())
    tols = flush(torch.full((x.shape[0],), tol, dtype=torch.float32, device=x.device))
    log2tols = (torch.frexp(tols)[1] - 1).to(torch.int32)
    emax = block_emax(x)
    u_full = int2nb(fwd_transform_2d(quantize_blocks(x, emax)))
    npl = fixed_accuracy_planes(x, u_full, emax, tols, log2tols)
    payload = pack_planes(truncate_planes(u_full, npl), MAX_WORDS).reshape(n, -1, MAX_WORDS)
    emax, npl = emax.reshape(n, -1), npl.reshape(n, -1)
    out = []
    for j in range(n):
        w = (int(npl[j].max()) + 1) // 2 or 1
        out.append(torch.cat([payload[j, :, :w].reshape(-1), emax[j]]).to(torch.int32).cpu().numpy())
    return out
