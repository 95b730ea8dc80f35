"""Plain PyTorch versions of the kernels.

Counterparts of ``zfp_{encode,decode}_blocks{,_fa}_ref`` and
``flash_attention_ref`` in ``repro/kernels/ref.py``; the codec ones are
built on :mod:`repro_torch.compression.transform`.  The CPU tests hold them
against the JAX package (the codec bit for bit, attention to a tolerance),
and the CUDA kernels in ``repro_torch/csrc`` are held against them on the
card.  ``ln_lrelu_forward`` / ``ln_lrelu_backward`` (the surrogate's layer
norm + LeakyReLU pair, which has no TPU kernel) are held to autograd of
the layers in ``models/nn.py`` on the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

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

    The error is ``flush(deci * 2^(emax - 28) - x)`` rounded once
    (:func:`~repro_torch.compression.transform.dequantize_minus`): XLA
    contracts the dequantize's last multiply and the subtraction into one
    fused multiply-add, so the scaled value is neither flushed nor
    overflowed before the difference.
    """
    from repro_torch.compression.zfp import fixed_accuracy_planes
    x = T.flush_denormals(blocks_f)
    tols = T.flush_denormals(tols.to(torch.float32))
    emax = T.block_emax(x)
    u_full = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(x, emax)))
    npl = fixed_accuracy_planes(x, u_full, emax, tols, log2tols)
    payload = T.pack_planes(T.truncate_planes(u_full, npl), T.MAX_WORDS)
    return payload, emax, npl


def zfp_decode_blocks_fa_ref(payload: torch.Tensor, emax: torch.Tensor,
                             nplanes: torch.Tensor) -> torch.Tensor:
    """Fixed-accuracy decode: per-block plane counts mask the unpacked stream.

    payload (nb, W) int32, emax/nplanes (nb,) int32 -> (nb, 16) f32.
    """
    u = T.truncate_planes(T.unpack_planes(payload), nplanes.to(torch.int32))
    return T.dequantize_blocks(T.inv_transform_2d(T.nb2int(u)), emax)


def zfp_decode_blocks_fa_gather_ref(payload: torch.Tensor, emax: torch.Tensor,
                                    nplanes: torch.Tensor, idx: torch.Tensor,
                                    padded_shape, shape) -> torch.Tensor:
    """Gathered fixed-accuracy decode of a device-resident store's batch:
    payload (N, nb, W), emax and nplanes (N, nb) int32, idx (B,) int ->
    (B, *shape) f32 (contiguous).  The gathers, the flat decode, deblockify
    and the crop, as the JAX package's ``_gather_decode`` composes them.
    Raises ``IndexError`` for an index outside [0, N)."""
    from repro_torch.compression.zfp import crop
    n, nb, num_words = payload.shape
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"sample index out of range [0, {n}): "
                         f"{idx.min().item()}..{idx.max().item()}")
    b = idx.shape[0]
    blocks = zfp_decode_blocks_fa_ref(payload[idx].reshape(b * nb, num_words),
                                      emax[idx].reshape(b * nb),
                                      nplanes[idx].reshape(b * nb))
    return crop(T.deblockify(blocks, (b,) + tuple(padded_shape)), shape).contiguous()


# ---------------------------------------------------------------------------
# Flash-attention oracle (GQA, causal or full, per-row key lengths)
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, sm_scale: Optional[float] = None,
                        window: Optional[int] = None,
                        kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Naive reference attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0 (GQA).
    ``window``: optional sliding-window size (tokens attend to the previous
    ``window`` positions, inclusive of self).  ``kv_lens`` (B,) int: row b
    has ``kv_lens[b]`` keys; its queries are end-aligned to that length and
    keys at or past it are masked (``None``: every row has Sk keys).
    k and v are rounded to q's dtype first, as the serving path's
    ``cache.astype(q.dtype)`` does.  Returns (B, Hq, Sq, D) in q.dtype;
    accumulation in f32.
    """
    logits, mask, vf = _masked_logits(q, k, v, causal, sm_scale, window, kv_lens, 0)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
    return out.reshape(q.shape).to(q.dtype)


def flash_attention_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                causal: bool = True, sm_scale: Optional[float] = None,
                                window: Optional[int] = None,
                                kv_lens: Optional[torch.Tensor] = None,
                                q_shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref` over one shard of a sequence-sharded
    cache: every query position moves ``q_shift`` further on, and it
    returns (out (B, Hq, Sq, D) f32, normalised over this shard's keys; lse
    (B, Hq, Sq) f32, each row's log-sum-exp, -1e30 and out 0 for a row that
    sees no key), which the kernel's partial entry returns too."""
    logits, mask, vf = _masked_logits(q, k, v, causal, sm_scale, window, kv_lens, q_shift)
    seen = mask.any(-1)[:, None, None]                          # (B, 1, 1, Sq)
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    m = torch.where(seen, logits.amax(-1), 0.0)
    probs = torch.exp(logits - m[..., None])
    l = probs.sum(-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf) / l.clamp_min(1e-30)[..., None]
    lse = torch.where(seen, torch.log(l) + m, -1e30)
    b, hq, sq, _ = q.shape
    return out.reshape(q.shape), lse.reshape(b, hq, sq)


def _masked_logits(q, k, v, causal, sm_scale, window, kv_lens, q_shift):
    """Scaled f32 logits (B, Hkv, group, Sq, Sk), the key mask (B, Sq, Sk)
    and v in f32, queries end-aligned with each row's keys and then moved
    ``q_shift`` on."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, group, sq, d)
    kf = k.to(q.dtype).float()
    vf = v.to(q.dtype).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * sm_scale
    lens = (torch.full((b,), sk, dtype=torch.int64, device=q.device)
            if kv_lens is None else kv_lens.to(device=q.device, dtype=torch.int64))
    # queries end-aligned with each row's keys (decode: sq << sk)
    qpos = (torch.arange(sq, device=q.device)[None, :, None] + (lens[:, None, None] - sq)
            + q_shift)
    kpos = torch.arange(sk, device=q.device)[None, None, :]
    mask = kpos < lens[:, None, None]                       # (B, Sq, Sk)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return logits, mask, vf


def ln_lrelu_forward(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-5, slope: float = 0.2):
    """``leaky_relu(layernorm(x))`` over dim 1 of (B, C, H, W) x, in the
    kernel's order -> (y, mean, rstd), mean and rstd (B, H, W): mean, the
    population variance from it, ``rstd = rsqrt(var + eps)``, ``pre = (x -
    mean) * rstd * g + b``, ``y = pre >= 0 ? pre : slope * pre``."""
    mean = x.mean(dim=1)
    d = x - mean[:, None]
    rstd = torch.rsqrt(d.square().mean(dim=1) + eps)
    pre = d * rstd[:, None] * g[:, None, None] + b[:, None, None]
    return torch.where(pre >= 0, pre, slope * pre), mean, rstd


def ln_lrelu_backward(dy: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                      b: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                      slope: float = 0.2):
    """Gradients of :func:`ln_lrelu_forward`'s y for the cotangent ``dy``
    -> (dx, dg, db), from x and the forward's mean and rstd: ``xhat`` and
    ``pre`` recomputed as the forward computed them (so the mask is its
    mask, 1 at exactly 0), ``dpre = pre >= 0 ? dy : slope * dy``, ``dxhat =
    dpre * g``, ``dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat *
    xhat))`` over C, ``dg = sum(dpre * xhat)`` and ``db = sum(dpre)`` over
    the batch's pixels."""
    c = x.shape[1]
    xhat = (x - mean[:, None]) * rstd[:, None]
    pre = xhat * g[:, None, None] + b[:, None, None]
    dpre = torch.where(pre >= 0, dy, slope * dy)
    dxhat = dpre * g[:, None, None]
    m1 = dxhat.sum(dim=1, keepdim=True) / c
    m2 = (dxhat * xhat).sum(dim=1, keepdim=True) / c
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return dx, (dpre * xhat).sum(dim=(0, 2, 3)), dpre.sum(dim=(0, 2, 3))
