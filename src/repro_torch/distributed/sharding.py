"""Sharding rules: logical parameter and activation axes -> partition specs
-> DTensor placements.  The port of ``repro/distributed/sharding.py``.

Strategy (DESIGN.md §6), the reference's:
  * TP over "model": attention heads, FFN hidden, MoE experts (EP), SSM inner
  * FSDP/ZeRO over "data": the non-TP weight dim of every large matrix;
    optimizer moments inherit the same fully-sharded specs (ZeRO)
  * DP batch over ("pod", "data"); params replicated across pods (weight
    all-gathers stay inside a pod; only grad reduction crosses pods)
  * decode KV caches: batch over ("pod", "data"), sequence over "model";
    batch=1 long-context shards sequence over every axis

A spec (:class:`P`) is kept in the reference's vocabulary: one entry per
tensor dim, holding a mesh axis name, a tuple of names or ``None``, with a
one-name tuple written as the name, as ``jax.sharding.PartitionSpec``
writes it.  :func:`placements` turns a spec into DTensor placements, one
per mesh dim: an axis (or each axis of a tuple) on tensor dim d is
``Shard(d)`` on that mesh dim, in mesh order; every other mesh dim is
``Replicate()``.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, or a ``{axis name: size}`` mapping where only the sizes are read
(:func:`resolve_specs`, :func:`cache_specs`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A partition spec: ``P(None, "data", ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def is_spec(x) -> bool:
    return isinstance(x, P)


def spec_map(fn, spec_tree, *rest):
    """Apply ``fn`` to every spec of a tree of dicts (and the AdamState of
    :func:`opt_specs`), with the matching leaves of ``rest``."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(spec_map(fn, v, *(getattr(r, f) for r in rest))
                                 for f, v in zip(spec_tree._fields, spec_tree)))
    raise TypeError(f"not a spec tree: {type(spec_tree).__name__}")


# ---------------------------------------------------------------------------
# dataset shard ownership (host-sliced, composes with the loaders)
# ---------------------------------------------------------------------------

def owned_shards(num_shards: int, host_id: int, num_hosts: int) -> np.ndarray:
    """Contiguous balanced slice of dataset shard ids owned by one host.

    Host h owns shards [start_h, start_h + count_h): the first
    ``num_shards % num_hosts`` hosts take one extra shard.  Contiguous
    (rather than strided) ownership keeps each host's reads inside a
    minimal set of shard files -- the point of packing many samples per
    shard -- while the union over hosts partitions [0, num_shards)
    exactly, mirroring the data-parallel batch axis split.
    """
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    counts = np.full(num_hosts, num_shards // num_hosts, np.int64)
    counts[:num_shards % num_hosts] += 1
    start = int(counts[:host_id].sum())
    return np.arange(start, start + counts[host_id])


# ---------------------------------------------------------------------------
# rule tables (sharding.py:45-86)
# ---------------------------------------------------------------------------

# leaf-name -> spec for stacked (L, ...) layer params
_LAYER_RULES: Dict[str, P] = {
    "wq":        P(None, "data", "model", None),
    "wk":        P(None, "data", "model", None),
    "wv":        P(None, "data", "model", None),
    "wo":        P(None, "model", None, "data"),
    "bq":        P(None, "model", None),
    "bk":        P(None, "model", None),
    "bv":        P(None, "model", None),
    "xwq":       P(None, "data", "model", None),
    "xwk":       P(None, "data", "model", None),
    "xwv":       P(None, "data", "model", None),
    "xwo":       P(None, "model", None, "data"),
    "w_gate":    P(None, "data", "model"),
    "w_up":      P(None, "data", "model"),
    "w_down":    P(None, "model", "data"),
    "router":    P(None, "data", None),
    "e_gate":    P(None, "model", "data", None),
    "e_up":      P(None, "model", "data", None),
    "e_down":    P(None, "model", None, "data"),
    "ssm_in":    P(None, "data", "model"),
    "ssm_conv_w": P(None, None, "model"),
    "ssm_out":   P(None, "model", "data"),
    "ssm_norm":  P(None, "model"),
    "ssm_A":     P(None, None),
    "ssm_D":     P(None, None),
    "ssm_dt_bias": P(None, None),
    "ln1":       P(None, None),
    "ln2":       P(None, None),
    "ln_x":      P(None, None),
}

_TOP_RULES: Dict[str, P] = {
    "embed":         P("model", None),   # vocab-sharded; tied head -> (None, model)
    "lm_head":       P(None, "model"),   # vocab-sharded logits for chunked CE
    "final_norm":    P(None),
    "enc_norm":      P(None),
    "frontend_proj": P(None, "model"),
}


def param_specs(params_shape_tree) -> Dict[str, Any]:
    """Spec tree mirroring the parameter tree (leaves: anything with
    ``.ndim``, meta tensors included).  A layer leaf whose rank differs
    from its rule's falls back to replication; an unknown leaf is
    replicated."""

    def walk(prefix, tree):
        if isinstance(tree, dict):
            return {k: walk(k, v) for k, v in tree.items()}
        if prefix in _TOP_RULES:
            return _TOP_RULES[prefix]
        if prefix in _LAYER_RULES:
            spec = _LAYER_RULES[prefix]
            if len(spec) == getattr(tree, "ndim", len(spec)):
                return spec
            return P()
        return P()

    out = {}
    for k, v in params_shape_tree.items():
        if k in ("layers", "enc_layers"):
            out[k] = {n: walk(n, leaf) for n, leaf in v.items()}
        else:
            out[k] = walk(k, v)
    return out


def opt_specs(param_spec_tree):
    """AdamState(step, m, v): moments fully sharded like params (ZeRO)."""
    from repro_torch.train.optimizer import AdamState
    return AdamState(step=P(), m=param_spec_tree, v=param_spec_tree)


def batch_specs(cfg: ArchConfig, kind: str, multi_pod: bool) -> Dict[str, P]:
    dp = ("pod", "data") if multi_pod else ("data",)
    tok = P(dp) if kind == "decode" else P(dp, None)
    specs = {"tokens": tok, "labels": P(dp, None)}
    if cfg.frontend != "none":
        specs["frontend_embeds"] = P(dp, None, None)
    if cfg.encoder_layers:
        specs["encoder_embeds"] = P(dp, None, None)
    return specs


def cache_specs(cfg: ArchConfig, batch: int, multi_pod: bool,
                n_pod: int = 2, n_data: int = 16) -> Dict[str, P]:
    """Stacked (L, B, S, ...) cache specs for serving."""
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    n_dp = (n_pod * n_data) if multi_pod else n_data
    if batch >= n_dp:
        bspec, sspec = dp_axes, ("model",)
    elif batch == 1:
        # long-context single stream: sequence over every axis
        bspec, sspec = None, dp_axes + ("model",)
    else:
        bspec, sspec = dp_axes, ("model",)
    specs: Dict[str, P] = {}
    if cfg.family != "ssm":
        specs["k"] = P(None, bspec, sspec, None, None)
        specs["v"] = P(None, bspec, sspec, None, None)
    if cfg.family == "ssm" or cfg.hybrid:
        specs["conv"] = P(None, bspec, None, "model")
        specs["ssm"] = P(None, bspec, "model", None, None)
    if cfg.encoder_layers:
        specs["xk"] = P(None, bspec, sspec, None, None)
        specs["xv"] = P(None, bspec, sspec, None, None)
    return specs


# ---------------------------------------------------------------------------
# meshes, resolution, placements
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a named DeviceMesh or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def resolve_specs(spec_tree, shape_tree, mesh):
    """Drop sharding axes whose size does not divide the dim (e.g. kv_heads=8
    over model=16, 25 query heads, odd vocab sizes).  The dropped axis means
    replication for that dim -- the Megatron convention when kv_heads < TP
    (sharding.py:158)."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None:
            return spec
        dims = []
        for i in range(len(shape)):
            ax = spec[i] if i < len(spec) else None
            if ax is None:
                dims.append(None)
                continue
            total = math.prod(sizes[a] for a in _axes(ax))
            dims.append(ax if shape[i] % total == 0 else None)
        return P(*dims)

    return spec_map(fix, spec_tree, shape_tree)


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on a named ``mesh``: ``Shard(d)`` on
    each mesh dim whose axis the spec names on tensor dim d, ``Replicate()``
    on the rest.  A mesh dim of size 1 holds the whole tensor either way and
    is given ``Replicate()`` (DTensor refuses to reshape a dim of size 1
    sharded over it).  An axis the mesh lacks raises, as a ``NamedSharding``
    does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the mesh {names}")
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def make_shardings(mesh, spec_tree, shape_tree=None):
    """The placements of every spec in ``spec_tree`` (resolved against
    ``shape_tree`` first where given)."""
    if shape_tree is not None:
        spec_tree = resolve_specs(spec_tree, shape_tree, mesh)
    return spec_map(lambda s: placements(mesh, s), spec_tree)


def distribute_tree(tree, mesh, spec_tree):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` at its (resolved)
    spec.  Each rank keeps its own shard of the tensor it holds (every rank
    holds the same values, or meta tensors); nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    spec_tree = resolve_specs(spec_tree, tree, mesh)
    return spec_map(lambda s, t: distribute_tensor(t, mesh, placements(mesh, s),
                                                   src_data_rank=None), spec_tree, tree)


def gather_tree(tree):
    """The full tensors of a tree of DTensors (collectives over the mesh)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(v) for v in tree))
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
