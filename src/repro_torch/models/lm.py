"""LMs, serving and training: the dense, MoE, SSM (Mamba2 SSD), hybrid
(Hymba), VLM and encoder-decoder families of ``repro/models/lm.py``, and
the port's own mixed stacks (granite-4.0-h, ``MixedArchConfig``).

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
no attention and no MLP; a hybrid layer has both branches.  A mixed
stack (``layer_kinds``) stacks each mixer's leaves over the layers of its
kind only (``wq`` (L_attention, ...), ``ssm_in`` (L_mamba, ...), with the
conv bias ``ssm_conv_b`` (L_mamba, di + 2 N)) and the rest over every
layer: ``ln1``, ``ln2``, the router (D, E), the held experts ``e_gate``/
``e_up`` (E_held, D, F), ``e_down`` (E_held, F, D) and the shared expert
``s_gate``/``s_up`` (D, Fs), ``s_down`` (Fs, D).  An
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
  backward.  A mixed stack's attention layers (no JAX counterpart) attend
  through ``scaled_dot_product_attention`` (:func:`_nope_attention`), and
  a mixed stack is not served (:func:`lm_prefill`, :func:`serve_step` and
  :func:`init_cache` raise ``ValueError``).

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
loop.  A mixed stack's MoE (:func:`moe_dropless`) drops nothing: every
pair routed to an expert the chip holds goes through grouped products.

With a constraint mesh (:func:`set_constraint_mesh`) and parameters and
inputs that are DTensors on it, the same functions run sharded, as the
reference under GSPMD: ``_constrain`` redistributes at the reference's
call sites, ``_gather_weights`` all-gathers each layer's FSDP weight shard
(its gradient is reduce-scattered back), ``_reduce_barrier`` reduces
tensor-parallel partial sums in their own dtype, and the work that is
local to a shard runs on the local tensors through ``local_map`` (as the
reference's ``shard_map``): attention per head shard (kernel 5 gets local
tensors), decode attention over a sequence-sharded cache with a
max/sum merge across the shards, ``moe_block`` per expert shard,
``ssd_scan`` per head shard, and the vocab-parallel cross-entropy.
Without a mesh they are identities, and nothing above changes.
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

from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor.placement_types import Placement

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (P, _axes, axis_sizes, cache_specs,
                                              placements, resolve_specs)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import DECODE_MAX_SQ
from repro_torch.obs.metrics import get_registry
from repro_torch.obs.trace import device_range

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
    mixed = cfg.family == "mixed"
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
        eh = cfg.held_experts if mixed else e
        shapes.update(router=(d, e), e_gate=(eh, d, f), e_up=(eh, d, f), e_down=(eh, f, d))
        if cfg.moe_dense_ff:
            fd = cfg.moe_dense_ff
            shapes.update(w_gate=(d, fd), w_up=(d, fd), w_down=(fd, d))
        if mixed:
            fs = cfg.shared_expert_ff
            shapes.update(s_gate=(d, fs), s_up=(d, fs), s_down=(fs, d))
    elif cfg.family != "ssm":
        shapes.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    if cfg.family == "ssm" or mixed or cfg.hybrid:
        nh, p, n, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv
        di = nh * p
        shapes.update(ssm_in=(d, 2 * di + 2 * n + nh), ssm_conv_w=(k, di + 2 * n),
                      ssm_A=(nh,), ssm_D=(nh,), ssm_dt_bias=(nh,), ssm_norm=(di,),
                      ssm_out=(di, d))
        if mixed and cfg.ssm_conv_bias:
            shapes["ssm_conv_b"] = (di + 2 * n,)
    return shapes


# a mixed stack's leaves that only one kind of layer has; the others
# (norms, router, experts, shared expert) every layer has
_MIXER_LEAVES = {"attention": ("wq", "wk", "wv", "wo"),
                 "mamba": ("ssm_in", "ssm_conv_w", "ssm_conv_b", "ssm_A", "ssm_D",
                           "ssm_dt_bias", "ssm_norm", "ssm_out")}


def _leaf_kind(name: str) -> Optional[str]:
    return next((kind for kind, names in _MIXER_LEAVES.items() if name in names), None)


def _stack_shapes(cfg: ArchConfig, cross_attn: bool = False, n_layers: Optional[int] = None
                  ) -> Dict[str, Tuple[int, ...]]:
    """Stacked shapes of a layer stack's leaves: (L, ...) each, or, in a
    mixed stack (``layer_kinds``), a mixer's leaves stacked over the layers
    of its kind only, in order."""
    shapes = _layer_param_shapes(cfg, cross_attn)
    n_layers = cfg.num_layers if n_layers is None else n_layers
    if cfg.family != "mixed":
        return {k: (n_layers,) + s for k, s in shapes.items()}
    return {k: ((cfg.layer_kinds.count(_leaf_kind(k)) if _leaf_kind(k) else n_layers,) + s)
            for k, s in shapes.items()}


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
    ``device="cpu"``).  ``device="meta"`` gives the same tree of shapes
    and dtypes with no values and draws nothing (the dry run's abstract
    state)."""
    if device is not None and torch.device(device).type == "meta":
        return _meta_params(cfg)
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
        for name, full in sorted(_stack_shapes(cfg, cross, n_l).items()):
            shape = full[1:]
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
            elif name == "ssm_conv_b":
                layers[name] = normal(full, 1.0 / math.sqrt(cfg.ssm_conv))
            else:
                fan_in = shape[0] * shape[1] if name in ("wo", "xwo") else shape[0]
                if cfg.family == "mixed" and name in _EXPERT_LEAVES:
                    fan_in = shape[1]               # the product's contraction
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


def _meta_params(cfg: ArchConfig) -> Params:
    """:func:`init_lm`'s tree on the meta device: shapes and dtypes only."""
    dt = _dtype(cfg)
    d, v = cfg.d_model, cfg.vocab_size

    def empty(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    def stack(n_l, cross):
        return {name: empty(full, torch.float32 if name in _F32_LEAVES else dt)
                for name, full in sorted(_stack_shapes(cfg, cross, n_l).items())}

    params: Params = {"embed": empty((v, d)), "final_norm": empty((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = empty((d, v))
    params["layers"] = stack(cfg.num_layers, cfg.encoder_layers > 0)
    if cfg.encoder_layers:
        params["enc_layers"] = stack(cfg.encoder_layers, False)
        params["enc_norm"] = empty((d,))
    if cfg.frontend != "none":
        params["frontend_proj"] = empty((cfg.frontend_dim, d))
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
    def stacked(cross, n_l):
        return sum(math.prod(s) for s in _stack_shapes(cfg, cross, n_l).values())

    n = stacked(cfg.encoder_layers > 0, cfg.num_layers) + cfg.d_model
    if cfg.encoder_layers:
        n += stacked(False, cfg.encoder_layers) + cfg.d_model
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
    if cfg.family == "mixed":
        # every layer's k experts of the published width, wherever they are held
        shapes = _stack_shapes(cfg)
        held = sum(math.prod(shapes[n]) for n in _EXPERT_LEAVES)
        return (param_count(cfg) - held - cfg.d_model
                + cfg.num_layers * cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff)
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
    freqs = _lift(torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                            * (math.log(theta) / half)), positions)
    ang = positions[..., None].float() * freqs                     # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# ===========================================================================
# the constraint mesh (lm.py:151-260)
# ===========================================================================

_CONSTRAINT_MESH = None
_CONSTRAINT_EXCLUDE: Tuple[str, ...] = ()
DP = ("pod", "data")     # batch axes (filtered against the tensor's mesh)


def set_constraint_exclude(axes) -> None:
    """Axes to strip from constraints (e.g. "pod" where the caller owns it)."""
    global _CONSTRAINT_EXCLUDE
    _CONSTRAINT_EXCLUDE = tuple(axes)


def set_constraint_mesh(mesh) -> None:
    """Switch the constraints on for DTensors (``None`` = off).  The
    constraints act on a DTensor's own mesh, so parameters on a submesh
    (the pod-compressed step's) are constrained there."""
    global _CONSTRAINT_MESH
    _CONSTRAINT_MESH = mesh


def _on_mesh(x) -> bool:
    return _CONSTRAINT_MESH is not None and isinstance(x, DTensor)


def _target(x: DTensor, spec) -> tuple:
    """The placements of ``spec`` on x's mesh, cleaned as the reference's
    ``_constrain``: axes absent from the mesh or excluded are dropped, then
    those not dividing the dim (``resolve_specs``), leaving replication."""
    names = x.device_mesh.mesh_dim_names
    kept = P(*(tuple(a for a in _axes(s) if a in names and a not in _CONSTRAINT_EXCLUDE)
               or None for s in spec[:x.ndim]))
    return placements(x.device_mesh, resolve_specs(kept, x, x.device_mesh))


class _CotangentTo(torch.autograd.Function):
    """Identity forward; the backward redistributes the gradient to the same
    placements, as a sharding constraint transposes to a constraint on the
    cotangent (partial gradients are reduced there, not carried on)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def _hold(x):
    """x as it is, its gradient held to x's placements."""
    if not _on_mesh(x) or not x.requires_grad:
        return x
    return _CotangentTo.apply(x, tuple(x.placements))


def _constrain(x, *spec, cotangent: bool = True):
    """``with_sharding_constraint`` (lm.py:172): x redistributed to the
    spec's placements, and (``cotangent``) its gradient held to them too;
    identity without a mesh."""
    if not _on_mesh(x):
        return x
    pl = _target(x, spec)
    if tuple(x.placements) != pl:
        x = x.redistribute(x.device_mesh, pl)
    return _CotangentTo.apply(x, pl) if cotangent and x.requires_grad else x


def _reduce_barrier(x):
    """Reduce tensor-parallel partial sums now, in x's own dtype (lm.py:207):
    a bf16 product's all-reduce moves bf16, whatever upcast follows.  The
    gradient is held replicated there too (the backward all-reduce of the
    column-parallel inputs' partial gradients), so no later product is
    computed on a partial gradient against gathered weights."""
    if not _on_mesh(x) or not any(p.is_partial() for p in x.placements):
        return x
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(x.device_mesh, pl)
    return _CotangentTo.apply(x, pl) if x.requires_grad else x


# Per-layer gathered-weight specs (lm.py:244-256): weights arrive
# FSDP-sharded over "data"; constraining them to their TP-only spec gives the
# ZeRO-3 pattern (forward all-gather of the weight shard, backward
# reduce-scatter of its gradient).
_GATHERED_W = {
    "wq": (None, "model", None), "wk": (None, "model", None),
    "wv": (None, "model", None), "wo": ("model", None, None),
    "xwq": (None, "model", None), "xwk": (None, "model", None),
    "xwv": (None, "model", None), "xwo": ("model", None, None),
    "w_gate": (None, "model"), "w_up": (None, "model"),
    "w_down": ("model", None),
    "e_gate": ("model", None, None), "e_up": ("model", None, None),
    "e_down": ("model", None, None),
    "router": (None, None),
    "ssm_in": (None, "model"), "ssm_out": ("model", None),
}


def _gather_weights(lp: Params) -> Params:
    # the gradient is left partial over "data", so it reduce-scatters into
    # the parameter's shard
    return {k: (_constrain(v, *_GATHERED_W[k], cotangent=False) if k in _GATHERED_W else v)
            for k, v in lp.items()}


def _lift(t: torch.Tensor, like, shard_batch: bool = False):
    """A plain tensor ``t`` -> a DTensor on ``like``'s mesh where ``like``
    is one: replicated, or with ``t``'s dim 0 sharded where ``like``'s dim
    0 is (``shard_batch``; ``t`` then holds the global batch).  Each rank
    keeps its own rows; nothing is sent."""
    if not isinstance(like, DTensor):
        return t
    pl = [Shard(0) if shard_batch and p == Shard(0) else Replicate()
          for p in like.placements]
    return distribute_tensor(t, like.device_mesh, pl, src_data_rank=None)


def _linear_rank(mesh, dims) -> int:
    """This rank's index among the shards of mesh ``dims`` (mesh order,
    the first outermost)."""
    r = 0
    for i in dims:
        r = r * mesh.size(i) + mesh.get_local_rank(i)
    return r


def _split_dims(out_placements) -> set:
    """Mesh dims on which some output is sharded or partial (the work is
    split there)."""
    return {i for pl in out_placements for i, p in enumerate(pl)
            if p.is_shard() or p.is_partial()}


def _run_local(fn, out_placements, inputs, mesh, reduced=()):
    """``fn`` on the local tensors of ``inputs`` (each DTensor at its own
    placements; other inputs as they are), its outputs DTensors at
    ``out_placements`` (one tuple, or a tuple of them for several outputs).
    A replicated input's gradient is partial on every mesh dim where the
    work is split, so autograd sums the shards' contributions: the dims
    where an output is sharded or partial, and the ``reduced`` ones, where
    ``fn`` reduces its outputs itself."""
    single = isinstance(out_placements[0], Placement)
    outs = (out_placements,) if single else out_placements
    split = _split_dims(outs) | set(reduced)
    in_pl, grad_pl = [], []
    for t in inputs:
        if isinstance(t, DTensor):
            in_pl.append(tuple(t.placements))
            grad_pl.append(tuple(Partial() if (i in split and p.is_replicate()) else p
                                 for i, p in enumerate(t.placements)))
        else:
            in_pl.append(None)
            grad_pl.append(None)
    # local_map reads a list as one output's placements, a tuple as one per output
    out_arg = list(outs[0]) if single else tuple(list(pl) for pl in outs)
    return local_map(fn, out_placements=out_arg, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*inputs)


def _dims_sharding(t: DTensor, dim: int) -> list:
    return [i for i, p in enumerate(t.placements) if p == Shard(dim)]


def _heads_local(attend, q, k, v, *rest):
    """``attend(q, k, v, *rest)`` per head shard (the reference's score
    constraint over heads, lm.py:296): q (B, S, H, Dh) as constrained; k, v
    (B, Sk, Hkv, Dh) head-sharded alike, or replicated, in which case each
    shard takes the KV heads of its own query heads (the reference repeats
    KV heads to H first).  ``rest``: DTensors with a leading batch dim."""
    mesh = q.device_mesh
    h, hkv = q.shape[2], k.shape[2]
    hdims = _dims_sharding(q, 2)
    kv_split = bool(_dims_sharding(k, 2))
    r = _linear_rank(mesh, hdims)

    def local(ql, kl, vl, *rl):
        if hdims and not kv_split and hkv != h:
            hl = ql.shape[2]
            idx = (r * hl + torch.arange(hl, device=ql.device)) // (h // hkv)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        elif hdims and not kv_split:
            hl = ql.shape[2]
            kl, vl = kl[:, :, r * hl:(r + 1) * hl], vl[:, :, r * hl:(r + 1) * hl]
        return attend(ql, kl, vl, *rl)

    return _run_local(local, tuple(q.placements), (q, k, v) + rest, mesh)


def _batch_only(c: DTensor) -> list:
    """Placements keeping only c's batch (dim 0) sharding."""
    return [p if p == Shard(0) else Replicate() for p in c.placements]


def _copy_into(dst, src) -> None:
    """``dst.copy_(src)``; a DTensor destination takes src redistributed to
    its own placements, copied shard by shard."""
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def _write_kv(c, new: torch.Tensor, p0: int) -> None:
    """``c[:, p0:p0 + s] = new`` (cast to c's dtype) on a per-layer cache (B,
    S, Hkv, Dh) whose sequence may be sharded: a whole-cache write is a
    redistribute (heads to sequence: an all-to-all); otherwise ``new`` is
    replicated but for its batch and each rank writes the rows it holds."""
    s = new.shape[1]
    new = new.to(c.dtype)
    if not isinstance(c, DTensor):
        c[:, p0:p0 + s] = new
        return
    if p0 == 0 and s == c.shape[1]:
        _copy_into(c, new)
        return
    new = new.redistribute(c.device_mesh, _batch_only(c)).to_local()
    cl = c.to_local()
    off = _linear_rank(c.device_mesh, _dims_sharding(c, 1)) * cl.shape[1]
    lo, hi = max(p0, off), min(p0 + s, off + cl.shape[1])
    if lo < hi:
        cl[:, lo - off:hi - off] = new[:, lo - p0:hi - p0]


def _attend_cache(q, ck, cv, end: int, causal: bool, window: Optional[int]):
    """Attention of q (B, Sq, H, Dh), end-aligned with them, over the
    first ``end`` rows of a per-layer cache whose sequence may be sharded
    (the reference's decode: scores sharded over the keys, lm.py:285).
    Each rank holds every head: q is gathered over heads.  Where the
    sequence is split, each shard attends its own keys through the serving
    kernel's partial entry (the keys at or past ``end`` masked, the
    queries moved past the shard's keys) and the shards merge by their
    log-sum-exps, reduced over the sequence's mesh dims; where it is not
    (one rank along it), the local call is the serving kernel's."""
    if not isinstance(ck, DTensor):
        return attention(q, ck[:, :end], cv[:, :end], causal=causal, window=window)
    mesh = ck.device_mesh
    q = q.redistribute(mesh, _batch_only(ck))
    sdims = _dims_sharding(ck, 1)
    n_seq = math.prod(mesh.size(i) for i in sdims)
    r = _linear_rank(mesh, sdims)

    if n_seq > 1 and q.is_cuda and q.shape[1] > DECODE_MAX_SQ:
        raise NotImplementedError(
            f"{q.shape[1]} queries over a sequence-sharded cache: the card's partial "
            f"attention takes at most {DECODE_MAX_SQ} (ROADMAP D4)")

    def local(ql, kl, vl):
        if n_seq == 1:
            return attention(ql, kl[:, :end], vl[:, :end], causal=causal, window=window)
        from torch.distributed import _functional_collectives as funcol
        k0, sl = r * kl.shape[1], kl.shape[1]
        n = min(max(end - k0, 0), sl)               # this shard's keys before end
        lens = torch.full((ql.shape[0],), n, dtype=torch.int32, device=ql.device)
        o, lse = ops.flash_attention_partial(
            ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2), causal=causal,
            window=window, kv_lens=lens, q_shift=max(end - k0 - n, 0))
        o, lse = o.transpose(1, 2), lse.transpose(1, 2)             # (B, Sq, H, ...)
        big = lse
        for i in sdims:
            big = funcol.all_reduce(big, "max", (mesh, i))
        w = torch.exp(lse - big)
        num, den = o * w[..., None], w
        for i in sdims:
            num = funcol.all_reduce(num, "sum", (mesh, i))
            den = funcol.all_reduce(den, "sum", (mesh, i))
        return (num / den[..., None]).to(ql.dtype)

    return _run_local(local, tuple(q.placements), (q, ck, cv), mesh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None,
              kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Sk, Hkv, Dh), any strides with a unit
    stride over Dh.  Queries are end-aligned with the keys (row b's with
    ``kv_lens[b]`` keys when given), which is the JAX function's position
    masking on every call this model makes.  Returns (B, Sq, H, Dh) in q's
    dtype; no copy of k or v is made.  Meta tensors (the dry run's
    shape-only trace, which computes nothing) take the plain version, which
    carries the shapes through."""
    attend = ref.flash_attention_ref if q.device.type == "meta" else ops.flash_attention
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
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
    g = _constrain(x @ w_gate, DP, None, "model")
    u = _constrain(x @ w_up, DP, None, "model")
    return _reduce_barrier((F.silu(g) * u) @ w_down)


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
    n = b * s
    g = min(cfg.moe_group, n)
    if n % g:
        raise ValueError(f"moe_block: B*S = {n} tokens must be at most moe_group "
                         f"({cfg.moe_group}) or a multiple of it (the reference reshapes "
                         f"the tokens into groups of moe_group)")
    if _on_mesh(x):
        y, frac, pmean = _moe_sharded(lp, x, cfg, g)
    else:
        y, frac, pmean = _moe_local(x, lp["router"], lp["e_gate"], lp["e_up"],
                                    lp["e_down"], cfg, g)
    # load-balance loss (Switch): E * sum_e f_e * p_e
    aux = cfg.num_experts * (frac * pmean).sum()
    if cfg.moe_dense_ff:                                            # Arctic's residual
        y = y + swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return y.to(x.dtype), aux


def _moe_local(x, router, e_gate, e_up, e_down, cfg: ArchConfig, g: int,
               expert0: int = 0):
    """The grouped dense dispatch on one shard: x (b, s, D) in groups of
    ``g``, routed over all E experts, through the experts ``expert0 ..
    expert0 + e_gate.shape[0]`` (all of them unsharded).  Returns (y (b, s,
    D), the partial sum over those experts; the per-expert token fraction
    and mean probability over these groups, f32 (E,))."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n = b * s
    ng = n // g
    cap = max(int(math.ceil(g * k / e * cfg.capacity_factor)), 4)
    bf = torch.bfloat16
    xt = x.reshape(ng, g, d)

    logits = (x.reshape(n, d) @ router).float()
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
    el = e_gate.shape[0]
    eoh = eoh_i.to(bf).reshape(n, k, e)[:, :, expert0:expert0 + el].transpose(1, 2)
    dispatch = (eoh @ (poh * keep[..., None]).reshape(n, k, cap)).reshape(ng, g, el * cap)
    combine = (eoh @ (poh * (keep * top_p.to(bf))[..., None]).reshape(n, k, cap)
               ).reshape(ng, g, el * cap)

    ct = torch.promote_types(bf, e_gate.dtype)
    xe = dispatch.transpose(1, 2) @ xt.to(bf)                       # (G, E*C, D)
    xe = xe.reshape(ng, el, cap, d).transpose(0, 1).reshape(el, ng * cap, d)
    # one cast a product: JAX's mixed bf16 x f32 products give each its own
    # bf16 cotangent for xe, summed in bf16
    h = F.silu(xe.to(ct) @ e_gate.to(ct)) * (xe.to(ct) @ e_up.to(ct))
    ye = h @ e_down.to(ct)                                          # (E, G*C, D)
    ye = ye.reshape(el, ng, cap, d).transpose(0, 1).reshape(ng, el * cap, d)
    y = (combine.to(ye.dtype) @ ye).reshape(b, s, d)
    frac = eoh_i.float().sum(2).mean((0, 1))                        # (E,)
    return y, frac, probs.mean((0, 1))


def _moe_sharded(lp: Params, x, cfg: ArchConfig, g: int):
    """:func:`_moe_local` per expert shard (the reference's EP over
    "model", lm.py:364-370), on the local groups: tokens stay sharded over
    the batch axes where each shard holds whole groups, else they are
    gathered first (as the reference's group constraint replicates them).
    y is partial over the expert shards, reduced in its own dtype; the
    routing statistics are averaged over the batch shards."""
    mesh = x.device_mesh
    bdims = _dims_sharding(x, 0)
    n_b = math.prod(mesh.size(i) for i in bdims)
    if (x.shape[0] // n_b) * x.shape[1] % g:
        x = _constrain(x, None, None, None)
        bdims, n_b = [], 1
    router = _constrain(lp["router"], None, None)
    ws = [_constrain(lp[n], "model", None, None) for n in _EXPERT_LEAVES]
    edims = _dims_sharding(ws[0], 0)
    expert0 = _linear_rank(mesh, edims) * (cfg.num_experts // math.prod(
        mesh.size(i) for i in edims))

    def local(xl, rl, gl, ul, dl):
        y, frac, pmean = _moe_local(xl, rl, gl, ul, dl, cfg, g, expert0)
        return y, frac / n_b, pmean / n_b

    y_pl = tuple(Partial() if i in edims else (Shard(0) if i in bdims else Replicate())
                 for i in range(mesh.ndim))
    stat_pl = tuple(Partial() if i in bdims else Replicate() for i in range(mesh.ndim))
    y, frac, pmean = _run_local(local, (y_pl, stat_pl, stat_pl), [x, router] + ws, mesh)
    return _constrain(_reduce_barrier(y), DP, None, None), frac, pmean


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
                 conv_state: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None):
    """Depthwise causal convolution (lm.py:442).  x: (B, S, C); w: (K, C).
    Returns (y, new state (B, K-1, C)).  The reference's sum of K shifted
    products, starting from 0 and in x's dtype, in its order; ``bias`` (C,)
    (granite-4.0-h's ``mamba_conv_bias``) is added to that sum."""
    k = w.shape[0]
    if conv_state is None:
        pad = _lift(torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                                device=x.device), x, shard_batch=True)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
    if bias is not None:
        y = y + bias
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
    zxbcdt = _constrain((x.reshape(bsz * s, d) @ lp["ssm_in"]).reshape(bsz, s, -1),
                        DP, None, None)
    z, xin, bm, cm, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    xbc = torch.cat([xin, bm, cm], -1)
    if pad_mask is not None:
        xbc = torch.where(pad_mask[..., None], xbc, torch.zeros((), dtype=xbc.dtype,
                                                                  device=xbc.device))
    xbc_in = xbc
    if conv_state is not None:
        conv_state = _constrain(conv_state, DP, None, None)
    xbc, new_conv = _causal_conv(xbc, _constrain(lp["ssm_conv_w"], None, None), conv_state,
                                 lp.get("ssm_conv_b"))
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
    y, final_state = _ssm_core(xh, dt, lp["ssm_A"], lp["ssm_D"], bm, cm, ssm_state, chunk)
    # the gradient keeps y's head sharding, so it unflattens back into heads
    y = _hold(y.reshape(bsz, s, di).to(x.dtype))
    y = rmsnorm(lp["ssm_norm"], y * F.silu(z), cfg.norm_eps)
    out = _reduce_barrier((y.reshape(bsz * s, di) @ lp["ssm_out"]).reshape(bsz, s, -1))
    return out, (new_conv, final_state)


def _ssm_heads(xh, dt, A_log, D, bm, cm, state, chunk: int):
    """The SSM over the heads it is given: the decode step's direct state
    update for one token with a state, else :func:`ssd_scan`; plus the
    skip term ``x * D``.  Returns (y (B, S, H, P) f32, final state)."""
    if xh.shape[1] == 1 and state is not None:
        a = -torch.exp(A_log.float())
        dA = torch.exp(dt[:, 0] * a)                                  # (B, H)
        xw = (xh[:, 0] * dt[:, 0, :, None]).float()                   # (B, H, P)
        upd = xw[..., None] * bm[:, 0].float()[:, None, None, :]
        state = state * dA[:, :, None, None] + upd
        y = (state @ cm[:, 0].float()[:, None, :, None])[..., 0]      # (B, H, P)
        y = y[:, None]
    else:
        y, state = ssd_scan(xh, dt, A_log, bm, cm, chunk, init_state=state)
    return y + xh.float() * D[None, None, :, None], state


def _ssm_core(xh, dt, A_log, D, bm, cm, state, chunk: int):
    """:func:`_ssm_heads`, per head shard on a mesh (heads over "model"
    where they divide; B and C replicated)."""
    if not _on_mesh(xh):
        return _ssm_heads(xh, dt, A_log, D, bm, cm, state, chunk)
    xh = _constrain(xh, DP, None, "model", None)
    dt = _constrain(dt, DP, None, "model")
    A_log, D = _constrain(A_log, "model"), _constrain(D, "model")
    bm, cm = _constrain(bm, DP, None, None), _constrain(cm, DP, None, None)
    if state is not None:
        state = _constrain(state, DP, "model", None, None)
    y_pl = tuple(xh.placements)
    st_pl = tuple(Shard(1) if p == Shard(2) else p for p in y_pl)
    return _run_local(lambda *a: _ssm_heads(*a, chunk), (y_pl, st_pl),
                      (xh, dt, A_log, D, bm, cm, state), xh.device_mesh)


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
    q = _constrain(rope(q, positions, cfg.rope_theta), DP, None, "model", None)
    k = _constrain(rope(k, positions, cfg.rope_theta), DP, None, "model", None)
    v = _constrain(v, DP, None, "model", None)
    window = _window(cfg, is_global)
    if kv_cache is not None:
        ck, cv = kv_cache
        b, s = x.shape[:2]
        if _is_scalar(cache_pos):
            p0 = int(cache_pos)
            _write_kv(ck, k, p0)
            _write_kv(cv, v, p0)
            # queries end-aligned with the p0 + s keys written so far.  From
            # p0 = 0 those keys are exactly the fresh k, v whenever the cache
            # holds k's dtype without loss (bf16 k in the f32 cache): attend
            # to them, the same values in k's own dtype and half the bytes.
            if p0 == 0 and torch.promote_types(k.dtype, ck.dtype) == ck.dtype:
                y = _serve_attention(q, k, v, causal, window)
            else:
                y = _attend_cache(q, ck, cv, p0 + s, causal, window)
        else:
            if _on_mesh(x):
                raise NotImplementedError("sharded decode takes one scalar position "
                                          "for the batch, as the reference's dry run")
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
        y = _serve_attention(q, k, v, causal, window)
        new_kv = (k, v)
    else:
        # no cache: the training forward, differentiable plain attention
        y = _train_attention(q, k, v, positions, positions, causal=causal,
                             window=window, chunk=cfg.attn_chunk)
        new_kv = (k, v)
    return _reduce_barrier(_out_proj(y, lp["wo"])), new_kv


def _serve_attention(q, k, v, causal: bool, window: Optional[int]):
    """:func:`attention` (the serving kernel), per head shard on a mesh."""
    if not _on_mesh(q):
        return attention(q, k, v, causal=causal, window=window)
    return _heads_local(lambda ql, kl, vl: attention(ql, kl, vl, causal=causal,
                                                     window=window), q, k, v)


def _train_attention(q, k, v, qpos, kpos, **kw):
    """:func:`attention_train`, per head shard on a mesh."""
    if not _on_mesh(q):
        return attention_train(q, k, v, qpos, kpos, **kw)
    return _heads_local(lambda ql, kl, vl, qp, kp: attention_train(ql, kl, vl, qp, kp, **kw),
                        q, k, v, qpos, kpos)


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
    heads = (DP, None, "model", None)
    q = _constrain(_proj_heads(rmsnorm(lp["ln_x"], x, cfg.norm_eps), lp["xwq"]), *heads)
    if enc_out is not None:
        k = _constrain(_proj_heads(enc_out, lp["xwk"]), *heads)
        v = _constrain(_proj_heads(enc_out, lp["xwv"]), *heads)
        if cache is not None and "xk" in cache:
            _copy_into(cache["xk"], k)
            _copy_into(cache["xv"], v)
        if cache is not None:
            y = _serve_attention(q, k, v, False, None)
    else:
        y = _attend_cache(q, cache["xk"], cache["xv"], cache["xk"].shape[1], False, None)
    if cache is None:
        b, se = k.shape[:2]
        kpos = _lift(_as_positions(0, b, se, k.device), k, shard_batch=True)
        y = _train_attention(q, k, v, positions, kpos, causal=False, chunk=cfg.attn_chunk)
    return _reduce_barrier(_out_proj(y, lp["xwo"]))


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
    lp = _gather_weights(lp)
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
            _copy_into(cache["conv"], conv_s)
            _copy_into(cache["ssm"], ssm_s)
            new_cache.update(conv=cache["conv"], ssm=cache["ssm"])
    if cfg.family == "ssm":
        return _layer_out(x + y_ssm, cfg), new_cache, 0.0
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
    return _layer_out(x + y, cfg), new_cache, aux


def _layer_out(x, cfg: ArchConfig):
    """The layer boundary's constraint (lm.py:643-648): batch over DP, and
    under Megatron-SP the sequence over "model"."""
    if cfg.seq_parallel:
        return _constrain(x, DP, "model", None)
    return _constrain(x, DP, None, None)


def encoder_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor, *,
                  serving: bool = False) -> torch.Tensor:
    """One encoder layer (lm.py:652): ``ln1``, self-attention over every
    position (``causal=False``, RoPE at ``positions``, the config's window
    and qkv bias), its residual, then ``ln2`` and the SwiGLU MLP.  With
    ``serving`` (under :func:`lm_prefill`) it attends through the serving
    kernel, else through :func:`attention_train`."""
    lp = _gather_weights(lp)
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    y, _ = attn_block(lp, h, cfg, positions, causal=False, serving=serving)
    x = x + y
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


# ===========================================================================
# mixed stacks (granite-4.0-h): Mamba2 and attention layers in one stack, and
# on every layer a dropless MoE over the held experts beside a shared expert
# ===========================================================================

def _expert_mm(xs: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows of ``xs`` (M, a), sorted by expert, each through its expert's
    matrix of ``w`` (E_held, a, b): expert e takes rows ``offs[e - 1] ..
    offs[e]`` (``offs`` the int32 running count).  The rows past
    ``offs[-1]`` come out unspecified, and so do their gradients.  One
    grouped matrix product (``torch._grouped_mm``) where this build of
    PyTorch has one for the dtype and device; else one product per expert
    over its contiguous rows, whose bounds the host reads (one synchronise
    a call)."""
    if hasattr(torch, "_grouped_mm") and (xs.dtype == torch.bfloat16
                                          or xs.device.type == "cpu"):
        return torch._grouped_mm(xs, w, offs=offs)
    bounds = [0] + offs.tolist()
    rest = xs.new_zeros((xs.shape[0] - bounds[-1], w.shape[2]))
    return torch.cat([xs[lo:hi] @ w[e] for e, (lo, hi) in enumerate(zip(bounds, bounds[1:]))]
                     + [rest])


class _PermuteRows(torch.autograd.Function):
    """``x.index_select(0, perm)`` for a permutation ``perm`` of x's rows,
    whose gradient is the inverse permutation's gather (``index_select``'s
    own backward scatters with atomic adds)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.index_select(0, inv), None, None


def moe_dropless(lp: Params, x: torch.Tensor, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D) in x's dtype, the Switch load-balance
    loss, 0-d f32): a dropless MoE over the ``cfg.held_experts`` experts
    ``cfg.expert_offset ..`` that ``e_gate``/``e_up``/``e_down`` hold,
    routed over all ``cfg.num_experts`` (granite-4.0-h's
    ``GraniteMoeHybridMoE``, on one chip of an expert-parallel layer).

    Router logits (``x @ router``, rounded to bf16 as a bf16 product gives
    them) pick each token's top ``k`` experts (:func:`top_k`'s order); the
    gates are the softmax of those ``k`` logits.  Every (token, k) pair
    routed to a held expert is computed, none dropped: the pairs are sorted
    by expert (ties in token order) and each held expert's SwiGLU runs on
    its contiguous rows as three grouped products (:func:`_expert_mm`).
    The buffer holds all ``B S k`` pairs, so its shape does not depend on
    the routing and nothing is read back to the host; the pairs of the
    other chips' experts sit past the last held row, zeroed before and
    after the products so that neither they nor their gradients reach x.
    Each token's output is its pairs' outputs weighted by the gates (in
    x's dtype, as the published model weighs them), which is this chip's
    part of the layer's result.  The registry counts ``lm.moe.held_pairs``
    and ``lm.moe.max_expert_pairs`` (the busiest held expert's pairs) on
    the device, with no synchronise.  The aux, ``E * sum_e f_e p_e``,
    needs only the router, which every chip holds whole."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.num_experts, cfg.experts_per_token
    eh = cfg.held_experts
    xf = x.reshape(n, d)
    logits = (xf @ lp["router"]).float().to(torch.bfloat16).float()    # (n, E)
    top_l, top_ids = top_k(logits, k)
    gates = torch.softmax(top_l, -1)                                    # (n, k) f32
    frac = torch.bincount(top_ids.reshape(-1), minlength=e).float() / n
    aux = e * (frac * torch.softmax(logits, -1).mean(0)).sum()

    local = top_ids.reshape(-1) - cfg.expert_offset                     # (n k,)
    key = torch.where((local >= 0) & (local < eh), local, eh)           # eh: not held
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=eh + 1)[:eh]
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=x.device))
    held = (key[order] < eh)[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xs = _PermuteRows.apply(xf[:, None].expand(n, k, d).reshape(n * k, d), order, inv)
    xs = torch.where(held, xs, zero)
    hs = F.silu(_expert_mm(xs, lp["e_gate"], offs)) * _expert_mm(xs, lp["e_up"], offs)
    ys = torch.where(held, _expert_mm(hs, lp["e_down"], offs), zero)
    yk = _PermuteRows.apply(ys, inv, order).reshape(n, k, d)          # (token, k) order
    y = torch.bmm(gates.to(yk.dtype)[:, None, :], yk)[:, 0]

    reg = get_registry()
    reg.counter("lm.moe.held_pairs").add(counts.sum())
    reg.counter("lm.moe.max_expert_pairs").add(counts.max())
    return y.reshape(b, s, d).to(x.dtype), aux


def _nope_attention(lp: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Causal GQA without a position encoding, scores scaled by
    ``cfg.attn_scale`` (granite-4.0-h's ``attention_multiplier``), over
    packed sequences (no document mask): the KV heads repeated to the
    query heads and one ``scaled_dot_product_attention``, whose backward
    keeps no (S, S) scores (at 8k tokens the plain :func:`attention_train`
    would keep tens of GB of them)."""
    q, k, v = _project_qkv(lp, x, cfg)
    g = cfg.num_heads // cfg.num_kv_heads
    k, v = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    y = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       is_causal=True, scale=cfg.attn_scale or None)
    return _out_proj(y.transpose(1, 2), lp["wo"])


def mixed_layer(lp: Params, x: torch.Tensor, cfg: ArchConfig, kind: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of a mixed stack (``GraniteMoeHybridDecoderLayer``):
    ``x + m * mixer(ln1(x))``, the mixer a Mamba2 block (:func:`ssm_block`,
    with its conv bias) or :func:`_nope_attention` as ``kind`` says, then
    ``x + m * (moe(h) + shared(h))`` of ``h = ln2(x)``, ``m`` the
    residual multiplier.  Returns (x, the MoE's aux).  The device ranges
    ``lm.mamba``, ``lm.attention`` and ``lm.moe`` (the MoE block and the
    shared expert) time each forward, a recompute's too."""
    m = cfg.residual_multiplier
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if kind == "mamba":
        with device_range("lm.mamba", x.device):
            y, _ = ssm_block(lp, h, cfg)
    else:
        with device_range("lm.attention", x.device):
            y = _nope_attention(lp, h, cfg)
    x = x + m * y
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    with device_range("lm.moe", x.device):
        y, aux = moe_dropless(lp, h, cfg)
        y = y + swiglu(h, lp["s_gate"], lp["s_up"], lp["s_down"])
    return x + m * y, aux


def _mixed_layer_params(params: Params, cfg: ArchConfig, i: int) -> Params:
    """Layer ``i``'s leaves: the shared ones at ``i``, its mixer's at its
    place among the layers of its kind."""
    kind = cfg.layer_kinds[i]
    j = cfg.layer_kinds[:i].count(kind)
    return {name: v[i if _leaf_kind(name) is None else j]
            for name, v in params["layers"].items() if _leaf_kind(name) in (None, kind)}


class _EmbedRows(torch.autograd.Function):
    """``table[tokens]`` whose gradient sums each row's repeats in f32 and
    rounds once to the table's dtype.  Indexing's own backward (and
    ``F.embedding``'s on the CPU) rounds at every repeat, so a bf16 row
    stops growing once its sum is 2^8 times a term: on Zipf-distributed
    text the most frequent tokens' gradients lose most of their size."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.rows = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        d = g.shape[-1]
        acc = torch.zeros((ctx.rows, d), dtype=torch.float32, device=g.device)
        acc.index_add_(0, tokens.reshape(-1), g.reshape(-1, d).float())
        return acc.to(g.dtype), None


def _run_mixed_stack(params: Params, cfg: ArchConfig, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer loop of a mixed stack's training forward -> (x, total
    aux): each layer (:func:`mixed_layer`) under the config's remat."""
    if not cfg.nope or _on_mesh(x):
        raise NotImplementedError("a mixed stack attends without a position encoding, "
                                  "on one device")

    def body(h, i):
        return mixed_layer(_mixed_layer_params(params, cfg, i), h, cfg, cfg.layer_kinds[i])

    body = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = body(x, i)
        aux = aux + a
    return x, aux


def _refuse_mixed(cfg: ArchConfig, what: str) -> None:
    if cfg.family == "mixed":
        raise ValueError(
            f"{what}: {cfg.name} mixes {' and '.join(sorted(set(cfg.layer_kinds)))} layers "
            f"in one stack, whose serving needs SSM state and a KV cache in one cache "
            f"(ROADMAP Queue 6); it trains through lm_loss")


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
    aux = _lift(torch.zeros((), dtype=torch.float32, device=x.device), x)
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
    ex = _constrain(embeds.to(dtype) @ params["frontend_proj"], DP, None, None)
    b, se, _ = ex.shape
    epos = _lift(_as_positions(0, b, se, ex.device), ex, shard_batch=True)

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
    it.  A mixed stack scales its embeddings by the embedding multiplier
    and runs :func:`_run_mixed_stack`."""
    if cfg.family == "mixed":
        x = _EmbedRows.apply(params["embed"], batch["tokens"].long()) * cfg.embedding_multiplier
        x, aux = _run_mixed_stack(params, cfg, x)
        return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux
    x, positions = _embed_inputs(params, cfg, batch)
    enc_out = (_encode(params, cfg, batch["encoder_embeds"], x.dtype, serving=False)
               if cfg.encoder_layers else None)
    x, aux = run_decoder_stack(params, cfg, x, positions, enc_out)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _chunk_ce(hx: torch.Tensor, lx: torch.Tensor, w: torch.Tensor,
              logits_scaling: float = 1.0) -> torch.Tensor:
    # hx @ w in the params' dtype, then f32, as einsum(...).astype(f32)
    if _on_mesh(hx):
        return _chunk_ce_sharded(hx, lx, w)
    logits = (hx @ w).float()
    if logits_scaling != 1.0:
        logits = logits / logits_scaling
    gold = torch.gather(logits, -1, lx[..., None].long())[..., 0]
    return (torch.logsumexp(logits, -1) - gold).sum()


def _chunk_ce_sharded(hx, lx, w):
    """The vocab-parallel cross-entropy of one chunk (lm.py:753-757: logits
    sharded over the vocab on "model"): each shard computes its logits once
    and :class:`_VocabParallelCE` reduces their max, sum of exps and gold
    logit over the vocab's mesh dims."""
    hx, lx = _constrain(hx, DP, None, None), _constrain(lx, DP, None)
    mesh = hx.device_mesh
    vdims = _dims_sharding(w, 1)
    bdims = _dims_sharding(hx, 0)
    v0 = _linear_rank(mesh, vdims) * w.to_local().shape[1]
    row_pl = tuple(Shard(0) if i in bdims else Replicate() for i in range(mesh.ndim))

    def local(hl, ll, wl):
        return _VocabParallelCE.apply((hl @ wl).float(), ll.long() - v0, mesh, vdims)

    return _run_local(local, row_pl, (hx, lx, w), mesh, reduced=vdims).sum()


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross-entropy of local logits (rows, V / n) whose vocabulary
    is split over mesh ``dims``; ``idx``: each label less this shard's
    first vocabulary row (outside [0, V / n): another shard's).  Forward:
    the max, the sum of exp(logits - max) and the gold logit, each reduced
    over ``dims``, give ``log(sum) + max - gold``, which is ``logsumexp``'s
    own arithmetic.  Backward: ``g * exp(logits - lse)``, less g at the
    label, which is ``logsumexp``'s and ``gather``'s backward; so on one
    shard the gradient is the plain path's, bit for bit."""

    @staticmethod
    def forward(ctx, logits, idx, mesh, dims):
        from torch.distributed import _functional_collectives as funcol
        inside = (idx >= 0) & (idx < logits.shape[-1])
        idx = idx.clamp(0, logits.shape[-1] - 1)
        m = logits.amax(-1)
        for i in dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        se = torch.exp(logits - m[..., None]).sum(-1)
        gold = torch.where(inside, torch.gather(logits, -1, idx[..., None])[..., 0], 0.0)
        for i in dims:
            se = funcol.all_reduce(se, "sum", (mesh, i))
            gold = funcol.all_reduce(gold, "sum", (mesh, i))
        lse = torch.log(se) + m
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, inside = ctx.saved_tensors
        d = g[..., None] * torch.exp(logits - lse[..., None])
        d.scatter_add_(-1, idx[..., None], torch.where(inside, -g, 0.0)[..., None])
        return d, None, None, None


def lm_loss(params: Params, cfg: ArchConfig, batch,
            vocab_chunk_tokens: int = 512) -> torch.Tensor:
    """Next-token cross-entropy, chunked over the sequence (lm.py:738).

    ``c = min(vocab_chunk_tokens, S)`` tokens a chunk and ``S // c`` chunks:
    tokens past the last whole chunk are dropped, and the sum is divided by
    ``B * nc * c``.  A mixed stack's logits are divided by its
    ``logits_scaling``.  Each chunk is checkpointed, so no (tokens, V) tensor
    outlives its chunk.  A VLM's hidden rows of the prepended image
    tokens are dropped (after the final norm) so that the last S rows meet
    the S labels.  Returns ``loss + 0.01 * aux``, 0-d f32."""
    hidden, aux = lm_forward(params, cfg, batch)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:      # a frontend prepended tokens
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    w = _head_weight(params, cfg)
    scaling = cfg.logits_scaling if cfg.family == "mixed" else 1.0
    b, s, _ = hidden.shape
    c = min(vocab_chunk_tokens, s)
    nc = s // c
    total = _lift(torch.zeros((), dtype=torch.float32, device=hidden.device), hidden)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_ce, hidden[:, sl], labels[:, sl], w,
                                   scaling, use_reentrant=False)
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
    too; without them nothing is prepended.  On a mesh the lookup is the
    vocab-parallel embedding (each shard's rows, summed over "model")."""
    x = _embed(params["embed"], batch["tokens"])
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = batch["frontend_embeds"].to(x.dtype) @ params["frontend_proj"]
        x = torch.cat([_constrain(fe, DP, None, None), x], dim=1)
    x = _constrain(x, DP, None, None)
    b, s, _ = x.shape
    return x, _lift(_as_positions(0, b, s, x.device), x, shard_batch=True)


def _embed(table, tokens):
    """Rows ``tokens`` of ``table``.  On a mesh each vocab shard reads the
    rows it holds (0 for the others), and the partial sums are reduced in
    the table's dtype."""
    if not _on_mesh(table):
        return table[tokens.long()]
    mesh = table.device_mesh
    vdims = _dims_sharding(table, 0)
    v0 = _linear_rank(mesh, vdims) * table.to_local().shape[0]
    out_pl = tuple(Partial() if i in vdims else p for i, p in enumerate(tokens.placements))

    def local(tl, wl):
        idx = tl.long() - v0
        inside = (idx >= 0) & (idx < wl.shape[0])
        rows = wl[idx.clamp(0, wl.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=wl.dtype,
                                                                device=wl.device))

    return _reduce_barrier(_run_local(local, out_pl, (tokens, table), mesh))


def _head_weight(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _layer(params: Params, i: int, stack: str = "layers") -> Params:
    return {k: v[i] for k, v in params[stack].items()}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: DeviceLike = None, enc_seq: int = 0, mesh=None) -> Cache:
    """Stacked zero caches with a leading L axis (lm.py:775): ``k``, ``v``
    (L, B, max_seq, Hkv, Dh) unless the family is "ssm"; for the SSM and
    the hybrid ``conv`` (L, B, K - 1, di + 2 N) in ``dtype`` and ``ssm``
    (L, B, nh, P, N) in f32 whatever ``dtype`` is; for an encoder-decoder
    with ``enc_seq`` > 0 the cross cache ``xk``, ``xv`` (L, B, enc_seq,
    Hkv, Dh).  With a named ``mesh`` every leaf is a DTensor on it, sharded
    as :func:`repro_torch.distributed.sharding.cache_specs` says for that
    mesh (resolved against the shapes); ``device="meta"`` allocates
    nothing.  A mixed stack has no cache yet (``ValueError``)."""
    _refuse_mixed(cfg, "init_cache")
    dev = torch.device("meta") if device is not None and \
        torch.device(device).type == "meta" else resolve_device(device)
    if mesh is not None:
        return _sharded_cache(init_cache(cfg, batch, max_seq, dtype, "meta", enc_seq),
                              cfg, mesh, dev)
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


def _sharded_cache(shapes: Cache, cfg: ArchConfig, mesh, dev) -> Cache:
    sizes = axis_sizes(mesh)
    specs = cache_specs(cfg, next(iter(shapes.values())).shape[1], "pod" in sizes,
                        n_pod=sizes.get("pod", 1), n_data=sizes.get("data", 1))
    specs = resolve_specs({k: specs[k] for k in shapes}, shapes, sizes)
    return {k: distribute_tensor(torch.zeros(t.shape, dtype=t.dtype, device=dev), mesh,
                                 placements(mesh, specs[k]), src_data_rank=None)
            for k, t in shapes.items()}


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
    _refuse_mixed(cfg, "lm_prefill")
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
                       enc_seq=0 if enc_out is None else enc_out.shape[1],
                       mesh=x.device_mesh if _on_mesh(x) else None)
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
    _refuse_mixed(cfg, "serve_step")
    x = _constrain(_embed(params["embed"], tokens)[:, None], DP, None, None)
    positions = _lift(_as_positions(pos, x.shape[0], 1, x.device), x, shard_batch=True)
    if not _is_scalar(pos):
        pos = positions[:, 0]
    x = _run_layers(params, cfg, x, positions, cache, pos, enc_out=enc_out)
    return _logits(params, cfg, x), cache
