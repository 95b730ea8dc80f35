"""Public kernels, dispatched on the device of their inputs.

A tensor on the CPU goes to the plain version (:mod:`.ref`); a tensor on
the card goes to the CUDA kernel (:mod:`.zfp_codec`, :mod:`.flash_attention`),
which launches or raises.  There is no fallback and no switch that sends
card tensors through plain code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compression import transform as T
from repro_torch.compression.zfp import CompressedField, floor_log2
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, zfp_codec


def _on_cpu(*ts: torch.Tensor, kind: str = "ZFP") -> bool:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no {kind} kernel for device {dev}")


def zfp_decode_blocks_fa(payload: torch.Tensor, emax: torch.Tensor,
                         nplanes: torch.Tensor) -> torch.Tensor:
    """Fixed-accuracy decode: ((nb, W), (nb,), (nb,)) int32 -> (nb, 16) f32."""
    if _on_cpu(payload, emax, nplanes):
        return ref.zfp_decode_blocks_fa_ref(payload, emax, nplanes)
    return zfp_codec.zfp_decode_blocks_fa(payload, emax, nplanes)


def zfp_decode_blocks_fa_gather(payload: torch.Tensor, emax: torch.Tensor,
                                nplanes: torch.Tensor, idx: torch.Tensor,
                                padded_shape, shape) -> torch.Tensor:
    """Gathered fixed-accuracy decode: the samples ``idx`` (B,) int64 of a
    resident store (payload (N, nb, W), emax and nplanes (N, nb) int32) ->
    (B, *shape) f32, deblockified from ``padded_shape`` and cropped; on
    the card one kernel launch."""
    zfp_codec.check_field(payload.shape[1], padded_shape, shape)
    if _on_cpu(payload, emax, nplanes, idx):
        return ref.zfp_decode_blocks_fa_gather_ref(payload, emax, nplanes, idx,
                                                   padded_shape, shape)
    return zfp_codec.zfp_decode_blocks_fa_gather(payload, emax, nplanes, idx,
                                                 padded_shape, shape)


def zfp_encode_blocks_fa(blocks: torch.Tensor, tols: torch.Tensor):
    """Fixed-accuracy encode with per-block L-inf tolerances.

    (nb, 16) f32, (nb,) f32 -> ((nb, 15) int32 payload, (nb,) int32 emax,
    (nb,) int32 nplanes).  ``floor(log2(tol))`` is computed here, outside
    the kernel, exactly (:func:`repro_torch.compression.zfp.floor_log2`).
    """
    log2tols = floor_log2(tols)
    if _on_cpu(blocks, tols):
        return ref.zfp_encode_blocks_fa_ref(blocks, tols, log2tols)
    return zfp_codec.zfp_encode_blocks_fa(blocks, tols, log2tols)


def zfp_decode_blocks(payload: torch.Tensor, emax: torch.Tensor,
                      bits_per_value: int) -> torch.Tensor:
    """Fixed-rate decode: ((nb, W), (nb,)) int32 -> (nb, 16) f32, with
    ``W == (bits_per_value + 1) // 2``; no per-block plane mask."""
    zfp_codec.check_rate(payload.shape[-1], bits_per_value)
    if _on_cpu(payload, emax):
        return ref.zfp_decode_blocks_ref(payload, emax, bits_per_value)
    return zfp_codec.zfp_decode_blocks(payload, emax, bits_per_value)


def zfp_encode_blocks(blocks: torch.Tensor, bits_per_value: int):
    """Fixed-rate encode: (nb, 16) f32 -> ((nb, W) int32 payload, (nb,)
    int32 emax), keeping the top ``bits_per_value`` planes."""
    if _on_cpu(blocks):
        return ref.zfp_encode_blocks_ref(blocks, bits_per_value)
    return zfp_codec.zfp_encode_blocks(blocks, bits_per_value)


def decode_field(cf: CompressedField) -> torch.Tensor:
    """Fixed-rate decode of one unbatched field (payload (nb, W), emax
    (nb,)) at ``2 * W`` planes -> ``cf.shape`` float32."""
    bits = int(cf.payload.shape[1]) * 2
    blocks = zfp_decode_blocks(cf.payload, cf.emax, bits)
    xp = T.deblockify(blocks, cf.padded_shape)
    return xp[tuple(slice(0, s) for s in cf.shape)]


def encode_field(x: torch.Tensor, bits_per_value: int) -> CompressedField:
    """Fixed-rate encode of one array (its trailing two dims blocked) into
    an unbatched field: payload (nb, W), emax and nplanes (nb,)."""
    xp = T.pad_to_blocks(x.to(torch.float32))
    blocks = T.blockify(xp).contiguous()
    payload, emax = zfp_encode_blocks(blocks, bits_per_value)
    nplanes = torch.full((blocks.shape[0],), bits_per_value, dtype=torch.int32,
                         device=x.device)
    return CompressedField(payload, emax, nplanes, tuple(x.shape), tuple(xp.shape))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA attention: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> (B, Hq, Sq, D)
    in q's dtype.  Queries are end-aligned with the keys; ``kv_lens`` (B,)
    int32 gives row b its own key length (keys at or past it masked)."""
    ts = (q, k, v) + ((kv_lens,) if kv_lens is not None else ())
    if _on_cpu(*ts, kind="attention"):
        fa.check_args(q, k, v, window, kv_lens, causal)  # the kernel's wrapper checks its own
        return ref.flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                       window=window, kv_lens=kv_lens)
    return fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, window=window,
                              kv_lens=kv_lens)


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, sm_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            kv_lens: Optional[torch.Tensor] = None,
                            q_shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` over one shard of a sequence-sharded cache,
    every query position moved ``q_shift`` on: -> (out (B, Hq, Sq, D) f32
    over this shard's keys, lse (B, Hq, Sq) f32, -1e30 for a row that sees
    no key).  On the card only the split-KV decode's inputs are taken;
    meta tensors (the dry run) take the plain version."""
    ts = (q, k, v) + ((kv_lens,) if kv_lens is not None else ())
    if q.device.type == "meta" or _on_cpu(*ts, kind="attention"):
        fa.check_args(q, k, v, window, kv_lens, causal)
        return ref.flash_attention_partial_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                               window=window, kv_lens=kv_lens,
                                               q_shift=q_shift)
    return fa.flash_attention_partial(q, k, v, causal=causal, sm_scale=sm_scale,
                                      window=window, kv_lens=kv_lens, q_shift=q_shift)
