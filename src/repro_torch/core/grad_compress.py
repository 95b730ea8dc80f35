"""Error-bounded gradient compression for data parallelism.

Counterpart of ``repro/core/grad_compress.py``.  SGD cannot exploit
gradient detail below the gradient-noise floor, so data-parallel gradients
go through the codec seam before the collective, with error feedback: each
rank's truncation residual re-enters its next step.  Any codec of the port
applies -- fixed-rate for a guaranteed wire ratio, fixed-accuracy for an
explicit error bound.

Where the JAX package names the mapped axis of ``shard_map``/``vmap``, this
module takes a ``torch.distributed`` process group (``None`` for the
default group).  The mean is ``all_reduce(SUM)`` of the decoded tensors
divided by the group's size (gloo has no ``ReduceOp.AVG``).  Encode and
decode run on the gradients' device (array leaves go to the card); a
group whose backend cannot carry that device's tensors (gloo and CUDA
tensors) is refused, not worked around.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.compression import (as_tensor, decode_tree, encode_tree,
                                     get_codec, tree_flatten, tree_map,
                                     tree_nbytes)

CodecLike = Union[object, int]


def as_codec(codec: CodecLike):
    """Resolve the ``bits`` shorthand: an int means the fixed-rate codec at
    that many bit planes; anything else must already be a codec."""
    if isinstance(codec, int):
        return get_codec("fixed_rate", bits_per_value=codec)
    return codec


def compress_decompress(g: torch.Tensor, codec: CodecLike) -> torch.Tensor:
    """Round-trip one gradient tensor through the codec (error-feedback
    math) on its device; shape and dtype are preserved."""
    codec = as_codec(codec)
    enc, meta = encode_tree(codec, g)
    return decode_tree(enc, meta, codec=codec)[0]


def _check_group(group, leaves) -> None:
    if any(as_tensor(x).is_cuda for x in leaves) and \
            dist.get_backend(group) == "gloo":
        raise ValueError("a gloo group does not carry CUDA gradients here; "
                         "use an NCCL group")


def compressed_psum_tree(grads, group, codec: CodecLike, residuals=None,
                         tolerances=None):
    """Error-feedback compressed mean over the ranks of ``group``.

    grads: this rank's gradient tree.  group: a ``torch.distributed``
    process group, or None for the default one.  codec: any codec of the
    port (or int bits for fixed-rate).  residuals: the previous step's
    residual tree (None starts from zero).  tolerances: per-leaf error
    bounds forwarded to :func:`encode_tree` -- scalar or ``{leaf_key:
    tol}``.  Returns ``(mean_grads, new_residuals)``, two trees with the
    structure of ``grads``.

    Each rank adds its carried residual, compresses, and the decoded
    tensors are averaged; the local truncation error becomes the new
    residual.  Leaves the codec skips (non-float, or no tolerance for a
    default-free fixed-accuracy codec) go through the mean raw with a zero
    residual; as in the JAX package, an integer leaf's mean comes back
    float32 and its residual keeps its dtype.
    """
    codec = as_codec(codec)
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros_like(as_tensor(g)), grads)
    g_fb = tree_map(lambda g, r: as_tensor(g) + r, grads, residuals)
    leaves, treedef = tree_flatten(g_fb)
    _check_group(group, leaves)
    enc, meta = encode_tree(codec, g_fb, tolerances=tolerances)
    g_hat = decode_tree(enc, meta, codec=codec)
    new_res = treedef.unflatten([f - h for f, h in zip(leaves, g_hat)])
    world = dist.get_world_size(group)
    means = []
    for h in g_hat:
        s = h.contiguous().clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        means.append(s / world)
    return treedef.unflatten(means), new_res


def tree_collective_bytes(grads, codec: Optional[CodecLike]) -> Tuple[int, int]:
    """(raw_bytes, compressed_bytes) one gradient exchange would move.
    ``codec=None`` is the uncompressed baseline (raw == compressed)."""
    if codec is None:
        raw = sum(l.numel() * l.element_size() if isinstance(l, torch.Tensor)
                  else np.asarray(l).nbytes for l in tree_flatten(grads)[0])
        return raw, raw
    codec = as_codec(codec)
    enc, meta = encode_tree(codec, grads)
    return tree_nbytes(codec, enc, meta)
