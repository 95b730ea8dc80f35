"""Dense decoder LM, serving and training: the dense family of
``repro/models/lm.py``.

Parameters are a plain dictionary in the JAX package's layout: ``embed``
(V, D), ``final_norm`` (D,), ``lm_head`` (D, V) unless embeddings are tied,
and ``layers``, a dictionary of stacked (L, ...) tensors (``ln1``, ``ln2``,
``wq`` (D, H, Dh), ``wk``/``wv`` (D, Hkv, Dh), ``wo`` (H, Dh, D), optional
``bq``/``bk``/``bv``, ``w_gate``/``w_up`` (D, F), ``w_down`` (F, D)).  The
layer scan becomes a Python loop over ``l``.

Serving attention (a KV cache) goes through
:func:`repro_torch.kernels.ops.flash_attention`: the CUDA kernel on the
card, its plain version on the CPU.  The KV cache is a dictionary of (L, B,
max_seq, Hkv, Dh) tensors, written in place (the JAX functions return
updated copies); attention reads it through strided views, with per-row key
lengths ``pos + 1`` where slots sit at their own depths.

The training forward (:func:`lm_forward`, :func:`lm_loss`) has no cache and
runs :func:`attention_train`, plain PyTorch that autograd differentiates,
as the JAX package's training runs its jnp ``attention``.  The layer loop
checkpoints per layer as the config's ``remat`` asks; the loss is chunked
over the sequence with each chunk checkpointed.

Left out, because they are identities without a mesh: ``_constrain``,
``_reduce_barrier``, ``_gather_weights`` and the constraint-mesh setters.
The MoE, SSM, hybrid, encoder-decoder and frontend families raise
``NotImplementedError`` naming their ROADMAP item.
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


def check_dense(cfg: ArchConfig) -> None:
    """Raise for the families this port does not serve yet."""
    for cond, what in ((cfg.num_experts > 0, "MoE"), (cfg.hybrid, "hybrid"),
                       (cfg.family == "ssm", "SSM"),
                       (cfg.encoder_layers > 0, "encoder-decoder"),
                       (cfg.frontend != "none", "VLM / audio frontend")):
        if cond:
            raise NotImplementedError(
                f"{cfg.name}: the {what} family is not ported yet (ROADMAP Queue 1 "
                f"item 11b); the port runs the dense family only")
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP Queue 1 item 11b)")


# ===========================================================================
# parameters
# ===========================================================================

def _layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.hdim
    h, hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {"ln1": (d,), "ln2": (d,), "wq": (d, h, hd), "wk": (d, hkv, hd),
              "wv": (d, hkv, hd), "wo": (h, hd, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(h, hd), bk=(hkv, hd), bv=(hkv, hd))
    return shapes


def init_lm(gen: Union[torch.Generator, int], cfg: ArchConfig,
            device: DeviceLike = None) -> Params:
    """Random parameters with the JAX package's shapes, scales and stacked
    (L, ...) layout: N(0, 1/fan_in) matrices (fan_in = H*Dh for ``wo``),
    N(0, 0.02^2) embeddings, ones for norms, zeros for biases, drawn in f32
    from ``gen`` and cast to the config's dtype.  ``gen`` is a seeded
    ``torch.Generator`` (its device is used) or a seed, for a generator on
    ``device`` (the card unless ``device="cpu"``)."""
    check_dense(cfg)
    if isinstance(gen, torch.Generator):
        dev = gen.device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"generator on {dev}, device {device} asked")
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    dt = _dtype(cfg)
    d, v, n_l = cfg.d_model, cfg.vocab_size, cfg.num_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(std).to(dt)

    params: Params = {"embed": normal((v, d), 0.02),
                      "final_norm": torch.ones((d,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, v), 1.0 / math.sqrt(d))
    layers = {}
    for name, shape in sorted(_layer_param_shapes(cfg).items()):
        full = (n_l,) + shape
        if name.startswith("ln"):
            layers[name] = torch.ones(full, dtype=dt, device=dev)
        elif name.startswith("b"):
            layers[name] = torch.zeros(full, dtype=dt, device=dev)
        else:
            fan_in = shape[0] * shape[1] if name == "wo" else shape[0]
            layers[name] = normal(full, 1.0 / math.sqrt(fan_in))
    params["layers"] = layers
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
    """Analytic parameter count (dense family)."""
    check_dense(cfg)
    per_layer = sum(math.prod(s) for s in _layer_param_shapes(cfg).values())
    n = per_layer * cfg.num_layers + cfg.d_model        # + final_norm
    return n + cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters active per token: :func:`param_count` for the dense
    family (lm.py:894).  Only routed experts would count for MoE, which is
    not ported yet (ROADMAP Queue 1 item 11b)."""
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE family is not ported yet (ROADMAP Queue 1 item "
            f"11b); active_param_count covers the dense family only")
    return param_count(cfg)


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


# ===========================================================================
# transformer layers
# ===========================================================================

def _project_qkv(lp: Params, x: torch.Tensor, cfg: ArchConfig):
    b, s, d = x.shape

    def proj(w):
        return (x @ w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])

    q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
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


def attn_block(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
               causal: bool = True, kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]]
               = None, cache_pos=None):
    """Self-attention sublayer.  Returns (y, (k, v)): the fresh k, v without a
    cache, else the cache tensors (B, max_seq, Hkv, Dh), written in place at
    ``cache_pos`` (a scalar, or (B,) per-slot positions).  Without a cache
    this is the training forward and attends through :func:`attention_train`;
    with one, through the serving kernel (:func:`attention`)."""
    q, k, v = _project_qkv(lp, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = cfg.attn_window or None
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
    else:
        # no cache: the training forward, differentiable plain attention
        y = attention_train(q, k, v, positions, positions, causal=causal,
                            window=window, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    b, s, h, hd = y.shape
    wo = lp["wo"]
    return y.reshape(b, s, h * hd) @ wo.reshape(h * hd, wo.shape[2]), new_kv


def decoder_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                  cache: Optional[Cache] = None, cache_pos=None):
    """One dense decoder layer.  Returns (x, cache): ``cache`` is the layer's
    {"k", "v"} written in place (or {} without a cache).  The reference's
    third result, the MoE auxiliary loss, is 0 for the dense family."""
    check_dense(cfg)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y, kv = attn_block(lp, h, cfg, positions,
                       kv_cache=None if cache is None else (cache["k"], cache["v"]),
                       cache_pos=cache_pos)
    new_cache = {} if cache is None else {"k": kv[0], "v": kv[1]}
    x = x + y
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return x, new_cache


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
                      positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop of the training forward (lm.py:695), each layer under
    the config's remat; returns (x, total aux), the aux a 0-d f32 zero for
    the dense family."""
    def body(h, i):
        return decoder_layer(_layer(params, i), h, cfg, positions)[0]

    body = _remat(body, cfg)
    for i in range(cfg.num_layers):
        x = body(x, i)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_forward(params: Params, cfg: ArchConfig, batch) -> Tuple[torch.Tensor,
                                                                  torch.Tensor]:
    """Full causal forward (lm.py:712) -> (final-normed hidden (B, S, D),
    aux)."""
    check_dense(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, aux = run_decoder_stack(params, cfg, x, positions)
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
    outlives its chunk.  Returns ``loss + 0.01 * aux``, 0-d f32."""
    hidden, aux = lm_forward(params, cfg, batch)
    labels = batch["labels"]
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
# serving (KV cache decode)
# ===========================================================================

def _embed_inputs(params: Params, cfg: ArchConfig, batch) -> Tuple[torch.Tensor,
                                                                   torch.Tensor]:
    """tokens -> (B, S, D) embeddings, (B, S) int32 positions."""
    x = params["embed"][batch["tokens"].long()]
    b, s, _ = x.shape
    return x, _as_positions(0, b, s, x.device)


def _head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> Cache:
    """Stacked (L, B, max_seq, Hkv, Dh) zero caches for k and v."""
    check_dense(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.hdim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _run_layers(params: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                cache: Cache, cache_pos) -> torch.Tensor:
    for i in range(cfg.num_layers):
        x, _ = decoder_layer(_layer(params, i), x, cfg, positions,
                                cache={"k": cache["k"][i], "v": cache["v"][i]},
                                cache_pos=cache_pos)
    return x


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ _head_weight(params, cfg))[:, 0].float()


@torch.no_grad()
def lm_prefill(params: Params, cfg: ArchConfig, batch, max_seq: int,
               cache_dtype=torch.bfloat16, prompt_lens=None):
    """Run the prompt, return (last-token logits (B, V) f32, cache).

    ``prompt_lens`` (B,) serves a RIGHT-padded mixed-length batch: logits
    come from each row's own last real token, pad embeddings are zeroed, and
    causal masking keeps real queries off the trailing pads (lm.py:794)."""
    check_dense(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if prompt_lens is not None:
        prompt_lens = torch.as_tensor(prompt_lens, dtype=torch.int64, device=x.device)
        pad_mask = torch.arange(s, device=x.device)[None] < prompt_lens[:, None]
        x = torch.where(pad_mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    cache = init_cache(cfg, b, max_seq, cache_dtype, device=x.device)
    x = _run_layers(params, cfg, x, positions, cache, 0)
    if prompt_lens is None:
        x = x[:, -1:]
    else:                       # each row's own last real token
        x = x[torch.arange(b, device=x.device), prompt_lens - 1][:, None]
    return _logits(params, cfg, x), cache


@torch.no_grad()
def serve_step(params: Params, cfg: ArchConfig, cache: Cache, tokens: torch.Tensor, pos):
    """One decode step.  tokens: (B,) int; pos: a scalar (uniform depth) or a
    (B,) tensor of per-slot depths.  Writes the cache in place; returns
    (logits (B, V) f32, cache)."""
    check_dense(cfg)
    x = params["embed"][tokens.long()][:, None]
    positions = _as_positions(pos, x.shape[0], 1, x.device)
    if not _is_scalar(pos):
        pos = positions[:, 0]
    x = _run_layers(params, cfg, x, positions, cache, pos)
    return _logits(params, cfg, x), cache
