"""LMs, serving and training: the dense, MoE, SSM (Mamba2 SSD), hybrid
(Hymba), VLM and encoder-decoder families of ``repro/models/lm.py``.

Parameters are a plain dictionary in the JAX package's layout: ``embed``
(V, D), ``final_norm`` (D,), ``lm_head`` (D, V) unless embeddings are tied,
and ``layers``, a dictionary of stacked (L, ...) tensors (``ln1``, ``ln2``,
``wq`` (D, H, Dh), ``wk``/``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D), optional
``bq``/``bk``/``bv``, ``w_gate``/``w_up`` (D, F), ``w_down`` (F, D); the
Mamba2 block's ``ssm_in`` (D, 2 di + 2 N + nh), ``ssm_conv_w`` (K, di + 2
N), ``ssm_norm`` (di,), ``ssm_out`` (di, D), and ``ssm_A``, ``ssm_D``,
``ssm_dt_bias`` (nh,), which are f32 whatever the config's dtype; an MoE
layer's ``router`` (D, E), ``e_gate``/``e_up`` (E, D, F), ``e_down`` (E,
F, D) in place of the MLP, with Arctic's dense residual MLP ``w_gate``/
``w_up``/``w_down`` at ``moe_dense_ff`` beside them).  A pure SSM layer has
no attention and no MLP; a hybrid layer has both branches.  An
encoder-decoder model's decoder layers add the cross-attention leaves
``ln_x`` (D,), ``xwq`` (D, H, Dh), ``xwk``/``xwv`` (D, Hkv, Dh), ``xwo``
(H, Dh, D), and the model ``enc_layers`` (stacked encoder layers, without
them) and ``enc_norm`` (D,).  A model with a frontend (vision or audio) has
``frontend_proj`` (frontend_dim, D): the VLM's image embeddings go through
it and are prepended to the tokens, the encoder-decoder's input frames go
through it into the encoder.  The layer scans become Python loops.

Which attention each call takes:

* :func:`lm_prefill` and :func:`serve_step` (serving) attend through
  :func:`repro_torch.kernels.ops.flash_attention`, the CUDA kernel on the
  card and its plain version on the CPU, every call: the decoder's
  self-attention (causal, end-aligned with the KV cache), the encoder's
  self-attention (``causal=False``) and the decoder's cross-attention
  (``causal=False``, over every encoder position, the fresh keys in the
  prefill and the cross cache in decode).
* :func:`lm_forward` and :func:`lm_loss` (training) attend through
  :func:`attention_train`, plain PyTorch that autograd differentiates, as
  the JAX package's training runs its jnp ``attention``: the kernel has no
  backward.

The hybrid's local layers attend in a sliding window of ``attn_window``
keys, its ``global_attn_layers`` without one.  The cache is a dictionary
of stacked tensors written in place (the JAX functions return updated
copies): ``k``/``v`` (L, B, max_seq, Hkv, Dh), read through strided views
with per-row key lengths ``pos + 1`` where slots sit at their own depths;
for the SSM and hybrid families ``conv`` (L, B, K - 1, di + 2 N), the last
K - 1 inputs of the causal convolution, and ``ssm`` (L, B, nh, P, N), the
recurrent state, always f32; for the encoder-decoder ``xk``/``xv`` (L, B,
enc_seq, Hkv, Dh), the cross-attention's keys and values, written by the
prefill and read by every decode step.

The SSD scan is plain PyTorch in both packages.  The layer loops
checkpoint per layer as the config's ``remat`` asks (the encoder's too);
the loss is chunked over the sequence with each chunk checkpointed.

The MoE block (:func:`moe_block`) is the reference's grouped dense
dispatch in plain PyTorch, as the JAX package computes it in plain jnp:
tokens in groups of ``moe_group``, router scores snapped to the bf16 grid,
top-k in ``jax.lax.top_k``'s order, queue positions per expert, and the
dispatch, expert and combine products over every expert's ``capacity``
rows.  Its load-balance loss reaches :func:`lm_loss` through the layer
loop.

Left out, because they are identities without a mesh: ``_constrain``,
``_reduce_barrier``, ``_gather_weights`` and the constraint-mesh setters.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


# ===========================================================================
# parameters
# ===========================================================================

# f32 whatever the config's dtype (lm.py:90-95)
_F32_LEAVES = ("ssm_A", "ssm_D", "ssm_dt_bias")
_EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
# init_lm draws a leaf in f32 in slabs of at most this many values (512 MB)
# and casts each into the leaf: qwen3-moe-30b-a3b's e_gate is 9.66e9
# values, 38.6 GB in f32
_DRAW_SLAB = 1 << 27


def _layer_param_shapes(cfg: ArchConfig, cross_attn: bool = False
                        ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of one layer's leaves (lm.py:47): attention unless the family
    is "ssm"; with ``cross_attn`` (an encoder-decoder's decoder layers) the
    cross-attention's ``ln_x``, ``xwq``, ``xwk``, ``xwv``, ``xwo``; the
    router and experts (and Arctic's dense residual MLP at
    ``moe_dense_ff``) for MoE, else the SwiGLU MLP unless the family is
    "ssm"; the Mamba2 block for "ssm" and the hybrid."""
    d, hd = cfg.d_model, cfg.hdim
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {"ln1": (d,), "ln2": (d,)}
    if cfg.family != "ssm":
        shapes.update(wq=(d, h, hd), wk=(d, hkv, hd), wv=(d, hkv, hd), wo=(h, hd, d))
        if cfg.qkv_bias:
            shapes.update(bq=(h, hd), bk=(hkv, hd), bv=(hkv, hd))
    if cross_attn:
        shapes.update(ln_x=(d,), xwq=(d, h, hd), xwk=(d, hkv, hd), xwv=(d, hkv, hd),
                      xwo=(h, hd, d))
    if cfg.num_experts:
        e = cfg.num_experts
        shapes.update(router=(d, e), e_gate=(e, d, f), e_up=(e, d, f), e_down=(e, f, d))
        if cfg.moe_dense_ff:
            fd = cfg.moe_dense_ff
            shapes.update(w_gate=(d, fd), w_up=(d, fd), w_down=(fd, d))
    elif cfg.family != "ssm":
        shapes.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    if cfg.family == "ssm" or cfg.hybrid:
        nh, p, n, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
        di = nh * p
        shapes.update(ssm_in=(d, 2 * di + 2 * n + nh), ssm_conv_w=(k, di + 2 * n),
                      ssm_A=(nh,), ssm_D=(nh,), ssm_dt_bias=(nh,), ssm_norm=(di,),
                      ssm_out=(di, d))
    return shapes


def init_lm(gen: Union[torch.Generator, int], cfg: ArchConfig,
            device: DeviceLike = None) -> Params:
    """Random parameters with the JAX package's shapes, scales and stacked
    (L, ...) layout: N(0, 1/fan_in) matrices (fan_in = H*Dh for ``wo`` and
    ``xwo``, K for ``ssm_conv_w``, E for the expert leaves: each leaf's
    first axis), N(0, 0.02^2) embeddings, ones for norms, zeros for biases,
    drawn in f32 from ``gen`` in slabs of at most ``_DRAW_SLAB`` values,
    each cast into a leaf of the config's dtype (so a bf16 leaf never exists
    in f32); the SSM's ``ssm_A`` = log(linspace(1, 16, nh)), ``ssm_D`` = 1
    and ``ssm_dt_bias`` = -4 in f32 (lm.py:90-95).  An encoder-decoder
    config adds the decoder's cross-attention leaves, ``enc_layers`` and
    ``enc_norm``; a frontend adds ``frontend_proj`` (fan_in frontend_dim)
    (lm.py:105-125).  ``gen`` is a seeded ``torch.Generator`` (its device
    is used) or a seed, for a generator on ``device`` (the card unless
    ``device="cpu"``)."""
    if isinstance(gen, torch.Generator):
        dev = gen.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"generator on {dev}, device {device} asked")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    dt = _dtype(cfg)
    d, v = cfg.d_model, cfg.vocab_size

    def normal(shape, std):
        out = torch.empty(shape, dtype=dt, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _DRAW_SLAB):
            n = min(_DRAW_SLAB, flat.numel() - i)
            flat[i:i + n] = torch.randn(n, generator=gen, device=dev,
                                        dtype=torch.float32).mul_(std)
        return out

    def stack(n_l, cross):
        layers = {}
        for name, shape in sorted(_layer_param_shapes(cfg, cross).items()):
            full = (n_l,) + shape
            if name.startswith("ln") or name == "ssm_norm":
                layers[name] = torch.ones(full, dtype=dt, device=dev)
            elif name == "ssm_A":
                a = torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32,
                                             device=dev))
                layers[name] = a.expand(full).clone()
            elif name in _F32_LEAVES:
                layers[name] = torch.full(full, -4.0 if name == "ssm_dt_bias" else 1.0,
                                          dtype=torch.float32, device=dev)
            elif name.startswith("b"):
                layers[name] = torch.zeros(full, dtype=dt, device=dev)
            else:
                fan_in = shape[0] * shape[1] if name in ("wo", "xwo") else shape[0]
                layers[name] = normal(full, 1.0 / math.sqrt(fan_in))
        return layers

    params: Params = {"embed": normal((v, d), 0.02),
                      "final_norm": torch.ones((d,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v), 1.0 / math.sqrt(d))
    params["layers"] = stack(cfg.num_layers, cfg.encoder_layers > 0)
    if cfg.encoder_layers:
        params["enc_layers"] = stack(cfg.encoder_layers, False)
        params["enc_norm"] = torch.ones((d,), dtype=dt, device=dev)
    if cfg.frontend != "none":
        fd = cfg.frontend_dim
        params["frontend_proj"] = normal((fd, d), 1.0 / math.sqrt(fd))
    return params


def _tensor_from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, device: DeviceLike = None) -> Params:
    """A parameter tree of numpy (or JAX) arrays from the JAX package ->
    the port's dictionary of tensors on ``device`` (card unless "cpu")."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree).to(dev)


def param_count(cfg: ArchConfig) -> int:
    """Analytic parameter count (lm.py:879): the layers (with the
    cross-attention leaves for an encoder-decoder), ``final_norm``, the
    encoder's layers and ``enc_norm``, the embedding and head, and
    ``frontend_proj``."""
    def per_layer(cross):
        return sum(math.prod(s) for s in _layer_param_shapes(cfg, cross).values())

    n = per_layer(cfg.encoder_layers > 0) * cfg.num_layers + cfg.d_model
    if cfg.encoder_layers:
        n += per_layer(False) * cfg.encoder_layers + cfg.d_model
    n += cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.frontend != "none":
        n += cfg.frontend_dim * cfg.d_model
    return n


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters active per token (lm.py:894): :func:`param_count` without
    experts; with experts, each layer's expert leaves count ``k / E``
    (rounded down over the three leaves together), and the sum, as the
    reference's, leaves out ``final_norm``."""
    if not cfg.num_experts:
        return param_count(cfg)
    shapes = _layer_param_shapes(cfg)
    experts = sum(math.prod(shapes[n]) for n in _EXPERT_LEAVES)
    per_layer = (sum(math.prod(s) for s in shapes.values()) - experts
                 + experts * cfg.experts_per_token // cfg.num_experts)
    return (per_layer * cfg.num_layers
            + cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2))


# ===========================================================================
# primitives
# ===========================================================================

def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalised in f32, cast back to x's dtype, then scaled (lm.py:132)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int.  Frequencies in f32 as
    ``exp(-i * log(theta) / half)`` (lm.py:142), rotated in f32, cast back."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs                     # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh), any strides with a unit
    stride over Dh.  Queries are end-aligned with the keys (row b's with
    ``kv_lens[b]`` keys when given), which is the JAX function's position
    masking on every call this model makes.  Returns (B, Sq, H, Dh) in q's
    dtype; no copy of k or v is made."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, kv_lens=kv_lens)
    return out.transpose(1, 2)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, chunk: int = 1024) -> torch.Tensor:
    """Attention of the training forward, the JAX package's jnp
    ``attention`` (lm.py:263) in plain PyTorch.

    q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh); positions (B, Sq)/(B, Sk).
    GQA repeats each KV head ``H // Hkv`` times (``jnp.repeat`` on axis 2).
    Queries go in chunks of ``chunk``, the last padded with position -1;
    scores are f32 with ``scale = 1/sqrt(Dh)``, masked with
    ``where(m, s, -1e30)``, softmaxed in f32; the output is cast to q's
    dtype.

    It never calls :func:`repro_torch.kernels.ops.flash_attention`: that
    kernel has no backward, and neither has the Pallas kernel it ports, so
    the JAX package trains through its jnp attention too.  Autograd
    differentiates this function as written.
    """
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    scale = 1.0 / math.sqrt(dh)
    kf, vf = k.float(), v.float()

    def block(q_blk, qpos_blk):
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), kf) * scale
        m = (kpos[:, None, None, :] <= qpos_blk[:, None, :, None] if causal
             else torch.ones_like(s, dtype=torch.bool))
        if window is not None:
            m = m & (kpos[:, None, None, :] > qpos_blk[:, None, :, None] - window)
        p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf)

    if sq <= chunk:
        out = block(q, qpos)
    else:
        pad = (-sq) % chunk
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, pad))
            qpos = F.pad(qpos, (0, pad), value=-1)
        out = torch.cat([block(q[:, i:i + chunk], qpos[:, i:i + chunk])
                         for i in range(0, q.shape[1], chunk)], dim=1)[:, :sq]
    return out.to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


# ===========================================================================
# MoE (grouped dense dispatch)
# ===========================================================================

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the ``k`` largest values along the last axis in
    descending order and their indices, the lower index first among equal
    values.  A stable descending sort gives that order; ``torch.topk``
    leaves the order of ties unspecified, and the MoE router's scores tie
    often (they are snapped to the bf16 grid)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def moe_block(lp: Params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, the Switch load-balance
    loss, 0-d f32), the reference's grouped dense dispatch (lm.py:330).

    The B*S tokens go in ``ng`` groups of ``g = min(moe_group, B*S)``, as
    the reference reshapes them: B*S above ``moe_group`` must be a multiple
    of it.  Router scores (an f32 copy of ``x @ router``) are snapped to
    the bf16 grid, softmaxed in f32, and each token takes its top ``k``
    experts (:func:`top_k`), weights renormalised.  Each expert queues its
    tokens in (token, k) order within the group, exact integer positions;
    those at position ``cap = max(ceil(g k / E * capacity_factor), 4)`` or
    later are dropped.  The bf16 one-hot ``dispatch`` and ``combine`` (the
    latter weighted by the bf16 routing weights) carry the bf16 tokens to
    every expert's ``cap`` rows and back; the expert products run in the
    weights' dtype promoted with bf16 (f32 for an f32 model, as the
    reference's bf16 x f32 products give f32), with the casts where the
    reference rounds, so the backward rounds the same cotangents to bf16.
    Arctic adds a dense SwiGLU of ``x`` (``moe_dense_ff``).

    The router product has no batch dims (an ``mm``, which the "dots" remat
    keeps); dispatch, the experts and combine are batched (``bmm``) and
    recomputed, as under JAX's ``checkpoint_dots_with_no_batch_dims``."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    g = min(cfg.moe_group, n)
    if n % g:
        raise ValueError(f"moe_block: B*S = {n} tokens must be at most moe_group "
                         f"({cfg.moe_group}) or a multiple of it (the reference reshapes "
                         f"the tokens into groups of moe_group)")
    ng = n // g
    cap = max(int(math.ceil(g * k / e * cfg.capacity_factor)), 4)
    bf = torch.bfloat16
    xt = x.reshape(ng, g, d)

    logits = (x.reshape(n, d) @ lp["router"]).float()
    # the bf16 snap (lm.py:341-347): near-ties cannot flip on sub-bf16 noise
    logits = logits.to(bf).float()
    probs = torch.softmax(logits, -1).reshape(ng, g, e)
    top_p, top_ids = top_k(probs, k)                                # (G, N, K)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # exact integer queue positions: an exclusive count over (token, k)
    eoh_i = F.one_hot(top_ids, e)                                   # (G, N, K, E)
    pos_e = torch.cumsum(eoh_i.reshape(ng, g * k, e), 1).reshape(ng, g, k, e) - eoh_i
    pos_k = (pos_e * eoh_i).sum(-1)                                 # (G, N, K)
    keep = (pos_k < cap).to(bf)
    poh = (pos_k[..., None] == torch.arange(cap, device=x.device)).to(bf)  # (G, N, K, C)
    # "gnke,gnkc,gnk->gnec": an (E, K) @ (K, C) product a token, one term
    # of each sum nonzero (a token takes an expert once), exact in bf16
    eoh = eoh_i.to(bf).reshape(n, k, e).transpose(1, 2)             # (N', E, K)
    dispatch = (eoh @ (poh * keep[..., None]).reshape(n, k, cap)).reshape(ng, g, e * cap)
    combine = (eoh @ (poh * (keep * top_p.to(bf))[..., None]).reshape(n, k, cap)
               ).reshape(ng, g, e * cap)

    ct = torch.promote_types(bf, lp["e_gate"].dtype)
    xe = dispatch.transpose(1, 2) @ xt.to(bf)                       # (G, E*C, D)
    xe = xe.reshape(ng, e, cap, d).transpose(0, 1).reshape(e, ng * cap, d)
    # one cast a product: JAX's mixed bf16 x f32 products give each its own
    # bf16 cotangent for xe, summed in bf16
    h = F.silu(xe.to(ct) @ lp["e_gate"].to(ct)) * (xe.to(ct) @ lp["e_up"].to(ct))
    ye = h @ lp["e_down"].to(ct)                                    # (E, G*C, D)
    ye = ye.reshape(e, ng, cap, d).transpose(0, 1).reshape(ng, e * cap, d)
    y = (combine.to(ye.dtype) @ ye).reshape(b, s, d)

    # load-balance loss (Switch): E * sum_e f_e * p_e
    frac = eoh_i.float().sum(2).mean((0, 1))                        # (E,)
    aux = e * (frac * probs.mean((0, 1))).sum()
    if cfg.moe_dense_ff:                                            # Arctic's residual
        y = y + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return y.to(x.dtype), aux


# ===========================================================================
# Mamba2 SSD (chunked; the inter-chunk state carried by a Python loop)
# ===========================================================================

def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., L) -> (..., L, L) lower-triangular segment sums, -inf above
    the diagonal (lm.py:388).  The entries above are differences of finite
    cumulative sums replaced by -inf, so ``exp`` of the result is 0 there
    and its gradient too: no inf - inf, forward or backward."""
    n = dA.shape[-1]
    cs = torch.cumsum(dA, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=dA.device).tril()
    return torch.where(mask, seg, -math.inf)


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None):
    """Chunked SSD (lm.py:397).  xh: (B, S, H, P); dt: (B, S, H) f32, after
    softplus; A_log: (H,); Bm/Cm: (B, S, N).  Returns (y (B, S, H, P) in
    xh's dtype, final state (B, H, P, N) f32).

    Chunks of ``c = min(chunk, S)`` tokens, ``S // c`` of them, as the
    reference reshapes: S must be at most ``chunk`` or a multiple of it.
    What does not depend on the carried state (the within-chunk decays, the
    diagonal blocks, each chunk's own contribution to the state) is
    computed for every chunk at once; the state goes from chunk to chunk in
    a Python loop, the reference's ``lax.scan``, with the same update
    ``state * exp(total) + s_new``.  Every product is a two-operand batched
    matmul: the decays are folded into one operand first, so no
    (B, c, N, H, P) intermediate is made."""
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"ssd_scan: S = {s} must be at most the chunk ({chunk}) or a "
                         f"multiple of it (the reference reshapes S into S // chunk "
                         f"chunks)")
    nc = s // c
    a = -torch.exp(A_log.float())                                   # (H,) negative
    dA = (dt * a).reshape(b, nc, c, h)
    cum = torch.cumsum(dA, dim=2)                                   # (B, NC, c, H)
    L = torch.exp(_segsum(dA.transpose(2, 3)))                      # (B, NC, H, c, c)
    xw = (xh * dt[..., None]).float().reshape(b, nc, c, h, p)       # weighted by dt
    bc = Bm.reshape(b, nc, c, n)
    cc = Cm.reshape(b, nc, c, n)
    # diagonal (intra-chunk): y[i] = sum_j<=i C_i.B_j L_ij x_j
    cb = cc @ bc.transpose(-1, -2)                                  # (B, NC, c, c)
    m = cb[:, :, None].float() * L                                  # (B, NC, H, c, c)
    y = (m @ xw.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)      # (B, NC, c, H, P)
    # each chunk's own state: sum_i B_i (x_i decayed to the chunk's end)
    tot = cum[:, :, -1]                                             # (B, NC, H)
    decay_out = torch.exp(tot[:, :, None] - cum)                    # (B, NC, c, H)
    xd = (xw * decay_out[..., None]).reshape(b, nc, c, h * p)
    s_new = (xd.transpose(-1, -2) @ bc.float()).reshape(b, nc, h, p, n)
    # the carried state, chunk to chunk
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if init_state is None else init_state)
    decay_tot = torch.exp(tot)
    before = []
    for k in range(nc):
        before.append(state)
        state = state * decay_tot[:, k, :, None, None] + s_new[:, k]
    before = torch.stack(before, 1)                                 # (B, NC, H, P, N)
    # inter-chunk: the carried state seen through C, decayed into the chunk
    y_off = cc.float() @ before.reshape(b, nc, h * p, n).transpose(-1, -2)
    y = y + y_off.reshape(b, nc, c, h, p) * torch.exp(cum)[..., None]
    return y.reshape(b, s, h, p).to(xh.dtype), state


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution (lm.py:442).  x: (B, S, C); w: (K, C).
    Returns (y, new state (B, K-1, C)).  The reference's sum of K shifted
    products, starting from 0 and in x's dtype, in its order."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    return y, xp[:, -(k - 1):, :]


def ssm_block(lp: Params, x: torch.Tensor, cfg: ArchConfig,
              conv_state: Optional[torch.Tensor] = None,
              ssm_state: Optional[torch.Tensor] = None, chunk: int = 256,
              pad_mask: Optional[torch.Tensor] = None):
    """Mamba2 block (lm.py:455).  x: (B, S, D).  Returns (y, (conv state,
    ssm state)).

    ``pad_mask`` (B, S) bool, True at real tokens: pads contribute nothing
    to the recurrent state (the conv input and ``dt`` are zeroed there) and
    the conv window returned ends at each row's last real token, so every
    row's state equals a solo prefill of its prompt.  One token with a
    state is the decode step, a direct state update; otherwise
    :func:`ssd_scan`.  ``dt``'s softplus, the state and ``y`` are f32 until
    ``y`` is cast to x's dtype before the gated norm, as in the reference."""
    nh, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = nh * p
    bsz, s, d = x.shape
    zxbcdt = (x.reshape(bsz * s, d) @ lp["ssm_in"]).reshape(bsz, s, -1)
    z, xin, bm, cm, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xin, bm, cm], -1)
    if pad_mask is not None:
        xbc = torch.where(pad_mask[..., None], xbc, torch.zeros((), dtype=xbc.dtype,
                                                                  device=xbc.device))
    xbc_in = xbc
    xbc, new_conv = _causal_conv(xbc, lp["ssm_conv_w"], conv_state)
    if pad_mask is not None:
        # the window that ends at each row's last real token: columns
        # [len, len + K - 1) of the input extended on the left by the state
        kk = lp["ssm_conv_w"].shape[0]
        lens = pad_mask.sum(1)
        prefix = (torch.zeros_like(xbc_in[:, :kk - 1]) if conv_state is None
                  else conv_state.to(xbc_in.dtype))
        xp = torch.cat([prefix, xbc_in], 1)
        cols = lens[:, None] + torch.arange(kk - 1, device=x.device)[None]
        new_conv = torch.gather(xp, 1, cols[:, :, None].expand(-1, -1, xp.shape[2]))
    xbc = F.silu(xbc)
    xin, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt.float() + lp["ssm_dt_bias"])
    if pad_mask is not None:
        # dt = 0 freezes the state through pads: exp(0 * a) = 1, x * dt = 0
        dt = torch.where(pad_mask[..., None], dt, torch.zeros((), device=dt.device))
    xh = xin.reshape(bsz, s, nh, p)
    if s == 1 and ssm_state is not None:
        a = -torch.exp(lp["ssm_A"].float())
        dA = torch.exp(dt[:, 0] * a)                                  # (B, H)
        xw = (xh[:, 0] * dt[:, 0, :, None]).float()                   # (B, H, P)
        upd = xw[..., None] * bm[:, 0].float()[:, None, None, :]
        state = ssm_state * dA[:, :, None, None] + upd
        y = (state @ cm[:, 0].float()[:, None, :, None])[..., 0]      # (B, H, P)
        y = y[:, None]
        final_state = state
    else:
        y, final_state = ssd_scan(xh, dt, lp["ssm_A"], bm, cm, chunk,
                                  init_state=ssm_state)
    y = y + xh.float() * lp["ssm_D"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm(lp["ssm_norm"], y * F.silu(z), cfg.norm_eps)
    out = (y.reshape(bsz * s, di) @ lp["ssm_out"]).reshape(bsz, s, -1)
    return out, (new_conv, final_state)


# ===========================================================================
# transformer layers
# ===========================================================================

def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, H, Dh) -> (B, S, H, Dh), one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])


def _out_proj(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (B, S, H, Dh) @ w (H, Dh, D) -> (B, S, D)."""
    b, s, h, hd = y.shape
    return y.reshape(b, s, h * hd) @ w.reshape(h * hd, w.shape[2])


def _project_qkv(lp: Params, x: torch.Tensor, cfg: ArchConfig):
    q, k, v = (_proj_heads(x, lp[n]) for n in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return q, k, v


def _is_scalar(pos) -> bool:
    return pos.dim() == 0 if torch.is_tensor(pos) else np.ndim(pos) == 0


def _as_positions(pos, b: int, s: int, device) -> torch.Tensor:
    """A scalar or (B,) start position -> (B, S) int32 positions."""
    start = torch.as_tensor(pos, dtype=torch.int32, device=device)
    start = start.expand(b) if start.dim() == 0 else start
    return start[:, None] + torch.arange(s, dtype=torch.int32, device=device)[None]


def _global_flags(cfg: ArchConfig) -> Tuple[bool, ...]:
    """Per layer: does it attend globally (lm.py:674)?"""
    return tuple(i in cfg.global_attn_layers for i in range(cfg.num_layers))


def _window(cfg: ArchConfig, is_global: bool) -> Optional[int]:
    """The attention window of a layer (lm.py:582, 290): none on a hybrid's
    global layers (the reference's ``window_dyn`` of 2**30), else
    ``attn_window`` (0: none)."""
    if cfg.hybrid and cfg.attn_window and is_global:
        return None
    return cfg.attn_window or None


def attn_block(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
               causal: bool = True, kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]]
               = None, cache_pos=None, is_global: bool = False, serving: bool = False):
    """Self-attention sublayer.  Returns (y, (k, v)): the fresh k, v without a
    cache, else the cache tensors (B, max_seq, Hkv, Dh), written in place at
    ``cache_pos`` (a scalar, or (B,) per-slot positions).  With a cache, or
    with ``serving`` (the encoder under :func:`lm_prefill`, which keeps no
    cache), it attends through the serving kernel (:func:`attention`);
    otherwise this is the training forward and attends through
    :func:`attention_train`.  The window is :func:`_window`'s for
    ``is_global``."""
    q, k, v = _project_qkv(lp, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = _window(cfg, is_global)
    if kv_cache is not None:
        ck, cv = kv_cache
        b, s = x.shape[:2]
        if _is_scalar(cache_pos):
            p0 = int(cache_pos)
            ck[:, p0:p0 + s] = k.to(ck.dtype)
            cv[:, p0:p0 + s] = v.to(cv.dtype)
            # queries end-aligned with the p0 + s keys written so far.  From
            # p0 = 0 those keys are exactly the fresh k, v whenever the cache
            # holds k's dtype without loss (bf16 k in the f32 cache): attend
            # to them, the same values in k's own dtype and half the bytes.
            if p0 == 0 and torch.promote_types(k.dtype, ck.dtype) == ck.dtype:
                y = attention(q, k, v, causal=causal, window=window)
            else:
                y = attention(q, ck[:, :p0 + s], cv[:, :p0 + s], causal=causal,
                              window=window)
        else:
            # per-slot depths (continuous batching): row b writes at
            # cache_pos[b] and sees its first cache_pos[b] + s keys
            rows = torch.arange(b, device=x.device)[:, None]
            cols = _as_positions(cache_pos, b, s, x.device).long()
            ck[rows, cols] = k.to(ck.dtype)
            cv[rows, cols] = v.to(cv.dtype)
            kv_lens = (positions[:, -1] + 1).to(torch.int32)
            y = attention(q, ck, cv, causal=causal, window=window, kv_lens=kv_lens)
        new_kv = (ck, cv)
    elif serving:
        # no cache, serving: queries and keys at the same positions
        y = attention(q, k, v, causal=causal, window=window)
        new_kv = (k, v)
    else:
        # no cache: the training forward, differentiable plain attention
        y = attention_train(q, k, v, positions, positions, causal=causal,
                            window=window, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    return _out_proj(y, lp["wo"]), new_kv


def cross_attn_block(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
                     enc_out: Optional[torch.Tensor] = None,
                     cache: Optional[Cache] = None) -> torch.Tensor:
    """The decoder's cross-attention sublayer (lm.py:617-635): ``ln_x``, q
    from ``xwq``, k and v from ``enc_out`` (B, Se, D) through ``xwk`` and
    ``xwv``, no RoPE and no bias, every query over every encoder position
    (non-causal, no window), the output through ``xwo``.

    With a cache holding ``xk``/``xv`` and ``enc_out`` (the prefill), k and
    v are written into it, cast to its dtype, and the fresh ones are
    attended; without ``enc_out`` (decode) the cached ones are read, rounded
    to q's dtype as the reference's ``astype(q.dtype)`` does.  With a cache
    it attends through the serving kernel (:func:`attention`), without one
    (training) through :func:`attention_train`.  Returns (B, S, D)."""
    q = _proj_heads(rmsnorm(lp["ln_x"], x, cfg.norm_eps), lp["xwq"])
    if enc_out is not None:
        k, v = _proj_heads(enc_out, lp["xwk"]), _proj_heads(enc_out, lp["xwv"])
        if cache is not None and "xk" in cache:
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
    else:
        k, v = cache["xk"], cache["xv"]
    if cache is not None:
        y = attention(q, k, v, causal=False)
    else:
        b, se = k.shape[:2]
        y = attention_train(q, k, v, positions, _as_positions(0, b, se, k.device),
                            causal=False, chunk=cfg.attn_chunk)
    return _out_proj(y, lp["xwo"])


def decoder_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                  is_global: bool = False, enc_out: Optional[torch.Tensor] = None,
                  cache: Optional[Cache] = None, cache_pos=None,
                  pad_mask: Optional[torch.Tensor] = None):
    """One decoder layer (lm.py:568).  Returns (x, cache, aux): ``cache`` is
    the layer's slice of the cache ({"k", "v"}, {"conv", "ssm"} or all
    four; with "xk", "xv" for an encoder-decoder), written in place (or {}
    without a cache); ``aux`` is the MoE block's load-balance loss, 0.0 for
    the families without experts.  An SSM layer is ``x + ssm(ln1(x))``; a
    hybrid layer ``x + 0.5 * (attn + ssm)`` of the same ``ln1(x)``; after
    the self-attention's residual comes the cross-attention's
    (:func:`cross_attn_block`) where ``enc_out`` is given or the cache
    holds ``xk``; every family but the pure SSM then adds the MoE block
    (:func:`moe_block`) or the SwiGLU MLP of ``ln2(x)``.  ``pad_mask`` (B,
    S) marks the real tokens of a right-padded prefill for the SSM's state;
    an MoE block routes every row, pads included, as the reference does."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    new_cache: Cache = {}
    if cfg.family != "ssm":
        y_attn, kv = attn_block(lp, h, cfg, positions, is_global=is_global,
                                kv_cache=None if cache is None else (cache["k"], cache["v"]),
                                cache_pos=cache_pos)
        if cache is not None:
            new_cache.update(k=kv[0], v=kv[1])
    if cfg.family == "ssm" or cfg.hybrid:
        y_ssm, (conv_s, ssm_s) = ssm_block(
            lp, h, cfg, conv_state=None if cache is None else cache["conv"],
            ssm_state=None if cache is None else cache["ssm"], pad_mask=pad_mask)
        if cache is not None:
            cache["conv"].copy_(conv_s)
            cache["ssm"].copy_(ssm_s)
            new_cache.update(conv=cache["conv"], ssm=cache["ssm"])
    if cfg.family == "ssm":
        return x + y_ssm, new_cache, 0.0
    x = x + (0.5 * (y_attn + y_ssm) if cfg.hybrid else y_attn)
    if enc_out is not None or (cache is not None and "xk" in cache):
        x = x + cross_attn_block(lp, x, cfg, positions, enc_out, cache)
        if cache is not None and "xk" in cache:
            new_cache.update(xk=cache["xk"], xv=cache["xv"])
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.num_experts:
        y, aux = moe_block(lp, h, cfg)
    else:
        y, aux = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0
    return x + y, new_cache, aux


def encoder_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                  serving: bool = False) -> torch.Tensor:
    """One encoder layer (lm.py:652): ``ln1``, self-attention over every
    position (``causal=False``, RoPE at ``positions``, the config's window
    and qkv bias), its residual, then ``ln2`` and the SwiGLU MLP.  With
    ``serving`` (under :func:`lm_prefill`) it attends through the serving
    kernel, else through :func:`attention_train`."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y, _ = attn_block(lp, h, cfg, positions, causal=False, serving=serving)
    x = x + y
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


# ===========================================================================
# training forward and loss
# ===========================================================================

# the matmuls without batch dims (the projections) go through aten.mm /
# addmm; attention's einsums are bmm.  JAX's
# checkpoint_dots_with_no_batch_dims saves exactly the former.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(f, cfg: ArchConfig):
    """The config's rematerialisation of one layer (lm.py:665): "full"
    recomputes the layer in the backward, "dots" keeps the matmul outputs
    without batch dims and recomputes the rest, "none" keeps everything."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, f, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, f, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    if cfg.remat == "none":
        return f
    raise ValueError(f"unknown remat {cfg.remat!r}")


def run_decoder_stack(params: Params, cfg: ArchConfig, x: torch.Tensor,
                      positions: torch.Tensor, enc_out: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop of the training forward (lm.py:695), each layer under
    the config's remat, the hybrid's global layers flagged, every layer
    cross-attending to ``enc_out`` where given; returns (x, total aux), the
    aux a 0-d f32 sum of the layers' MoE load-balance losses (zero without
    experts)."""
    flags = _global_flags(cfg)

    def body(h, e, i):
        y, _, a = decoder_layer(_layer(params, i), h, cfg, positions, is_global=flags[i],
                                enc_out=e)
        return y, a

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = body(x, enc_out, i)
        aux = aux + a
    return x, aux


def _encode(params: Params, cfg: ArchConfig, embeds: torch.Tensor, dtype: torch.dtype,
            serving: bool) -> torch.Tensor:
    """The encoder (lm.py:716-729, 819-828): ``embeds`` (B, Se, frontend_dim)
    cast to ``dtype`` (the activations'), through ``frontend_proj``, the
    encoder layers at positions 0 .. Se - 1, then ``enc_norm``.  Training
    runs each layer under the config's remat; ``serving`` (the prefill)
    runs them plainly, through the serving kernel."""
    ex = embeds.to(dtype) @ params["frontend_proj"]
    b, se, _ = ex.shape
    epos = _as_positions(0, b, se, ex.device)

    def body(h, i):
        return encoder_layer(_layer(params, i, "enc_layers"), h, cfg, epos, serving=serving)

    if not serving:
        body = _remat(body, cfg)
    for i in range(cfg.encoder_layers):
        ex = body(ex, i)
    return rmsnorm(params["enc_norm"], ex, cfg.norm_eps)


def lm_forward(params: Params, cfg: ArchConfig, batch) -> Tuple[torch.Tensor,
                                                                  torch.Tensor]:
    """Full forward (lm.py:712) -> (final-normed hidden (B, S, D), aux); S
    counts a VLM's prepended image tokens.  An encoder-decoder model encodes
    ``batch["encoder_embeds"]`` first, and every decoder layer attends to
    it."""
    x, positions = _embed_inputs(params, cfg, batch)
    enc_out = (_encode(params, cfg, batch["encoder_embeds"], x.dtype, serving=False)
               if cfg.encoder_layers else None)
    x, aux = run_decoder_stack(params, cfg, x, positions, enc_out)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _chunk_ce(hx: torch.Tensor, lx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # hx @ w in the params' dtype, then f32, as einsum(...).astype(f32)
    logits = (hx @ w).float()
    gold = torch.gather(logits, -1, lx[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def lm_loss(params: Params, cfg: ArchConfig, batch,
            vocab_chunk_tokens: int = 512) -> torch.Tensor:
    """Next-token cross-entropy, chunked over the sequence (lm.py:738).

    ``c = min(vocab_chunk_tokens, S)`` tokens a chunk and ``S // c`` chunks:
    tokens past the last whole chunk are dropped, and the sum is divided by
    ``B * nc * c``.  Each chunk is checkpointed, so no (tokens, V) tensor
    outlives its chunk.  A VLM's hidden rows of the prepended image
    tokens are dropped (after the final norm) so that the last S rows meet
    the S labels.  Returns ``loss + 0.01 * aux``, 0-d f32."""
    hidden, aux = lm_forward(params, cfg, batch)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:      # a frontend prepended tokens
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    w = _head_weight(params, cfg)
    b, s, _ = hidden.shape
    c = min(vocab_chunk_tokens, s)
    nc = s // c
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_ce, hidden[:, sl], labels[:, sl], w,
                                   use_reentrant=False)
    return total / (b * nc * c) + 0.01 * aux


# ===========================================================================
# serving (KV and SSM cache decode)
# ===========================================================================

def _embed_inputs(params: Params, cfg: ArchConfig, batch) -> Tuple[torch.Tensor,
                                                                   torch.Tensor]:
    """tokens (+ a frontend's embeddings) -> (B, S, D) embeddings, (B, S)
    int32 positions 0 .. S - 1 (lm.py:682).  ``frontend_embeds`` (B, F,
    frontend_dim), where the config has a frontend and the batch holds
    them, are cast to the activations' dtype, projected by
    ``frontend_proj`` and prepended, so S counts them and RoPE rotates them
    too; without them nothing is prepended."""
    x = params["embed"][batch["tokens"].long()]
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([fe, x], dim=1)
    b, s, _ = x.shape
    return x, _as_positions(0, b, s, x.device)


def _head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _layer(params: Params, i: int, stack: str = "layers") -> Params:
    return {k: v[i] for k, v in params[stack].items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: DeviceLike = None, enc_seq: int = 0) -> Cache:
    """Stacked zero caches with a leading L axis (lm.py:775): ``k``, ``v``
    (L, B, max_seq, Hkv, Dh) unless the family is "ssm"; for the SSM and
    the hybrid ``conv`` (L, B, K - 1, di + 2 N) in ``dtype`` and ``ssm``
    (L, B, nh, P, N) in f32 whatever ``dtype`` is; for an encoder-decoder
    with ``enc_seq`` > 0 the cross cache ``xk``, ``xv`` (L, B, enc_seq,
    Hkv, Dh)."""
    dev = resolve_device(device)
    l = cfg.num_layers
    cache: Cache = {}
    if cfg.family != "ssm":
        shape = (l, batch, max_seq, cfg.num_kv_heads, cfg.hdim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "ssm" or cfg.hybrid:
        nh, p, n, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
        cache["conv"] = torch.zeros((l, batch, k - 1, nh * p + 2 * n), dtype=dtype,
                                    device=dev)
        cache["ssm"] = torch.zeros((l, batch, nh, p, n), dtype=torch.float32, device=dev)
    if cfg.encoder_layers and enc_seq:
        shape = (l, batch, enc_seq, cfg.num_kv_heads, cfg.hdim)
        cache["xk"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["xv"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _run_layers(params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: Cache, cache_pos, pad_mask: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer loop of prefill and decode, each layer's cache slice
    written in place; the MoE load-balance losses are dropped, as the
    reference's prefill and decode drop them.  The reference returns the
    conv window in the activations' dtype whatever the cache's (lm.py:452,
    594), so the conv cache takes x's dtype here first: exact for a bf16
    model's f32 cache, and an f32 model's window is not rounded by a bf16
    cache.  Each layer cross-attends to ``enc_out`` where given, else to
    the cross cache where there is one."""
    if "conv" in cache and cache["conv"].dtype != x.dtype:
        cache["conv"] = cache["conv"].to(x.dtype)
    flags = _global_flags(cfg)
    for i in range(cfg.num_layers):
        x, _, _ = decoder_layer(_layer(params, i), x, cfg, positions, is_global=flags[i],
                                enc_out=enc_out, cache={k: v[i] for k, v in cache.items()},
                                cache_pos=cache_pos, pad_mask=pad_mask)
    return x


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ _head_weight(params, cfg))[:, 0].float()


@torch.no_grad()
def lm_prefill(params: Params, cfg: ArchConfig, batch, max_seq: int,
               cache_dtype=torch.bfloat16, prompt_lens=None):
    """Run the prompt, return (last-token logits (B, V) f32, cache).

    ``prompt_lens`` (B,) serves a RIGHT-padded mixed-length batch: logits
    come from each row's own last real token, pad embeddings are zeroed,
    causal masking keeps real queries off the trailing pads, and the SSM
    state is pad-masked, so every row's cache equals a solo prefill of its
    prompt (lm.py:794).  A VLM's prepended image tokens are positions of
    the sequence: ``prompt_lens`` counts them, as the reference builds its
    pad mask over the whole sequence.  An encoder-decoder model encodes
    ``batch["encoder_embeds"]`` (without remat, through the serving kernel)
    and sizes the cross cache to its length."""
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    pad_mask = None
    if prompt_lens is not None:
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.int64, device=x.device)
        pad_mask = torch.arange(s, device=x.device)[None] < prompt_lens[:, None]
        x = torch.where(pad_mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    enc_out = (_encode(params, cfg, batch["encoder_embeds"], x.dtype, serving=True)
               if cfg.encoder_layers else None)
    cache = init_cache(cfg, b, max_seq, cache_dtype, device=x.device,
                       enc_seq=0 if enc_out is None else enc_out.shape[1])
    x = _run_layers(params, cfg, x, positions, cache, 0, pad_mask, enc_out)
    if prompt_lens is None:
        x = x[:, -1:]
    else:                       # each row's own last real token
        x = x[torch.arange(b, device=x.device), prompt_lens - 1][:, None]
    return _logits(params, cfg, x), cache


@torch.no_grad()
def serve_step(params: Params, cfg: ArchConfig, cache: Cache, tokens: torch.Tensor, pos,
               enc_out: Optional[torch.Tensor] = None):
    """One decode step.  tokens: (B,) int; pos: a scalar (uniform depth) or a
    (B,) tensor of per-slot depths.  An encoder-decoder model reads its
    cross cache (or attends to ``enc_out``, written into the cache, where
    given).  Writes the cache in place; returns (logits (B, V) f32,
    cache)."""
    x = params["embed"][tokens.long()][:, None]
    positions = _as_positions(pos, x.shape[0], 1, x.device)
    if not _is_scalar(pos):
        pos = positions[:, 0]
    x = _run_layers(params, cfg, x, positions, cache, pos, enc_out=enc_out)
    return _logits(params, cfg, x), cache
