"""Layer functions on NCHW tensors, each taking a dict of its parameters.

Counterparts of ``repro/models/nn.py`` (which is NHWC/HWIO).  Weights are
kept in PyTorch's layouts: ``dense`` (in, out) as ``x @ w + b``;
``conv2d`` (Cout, Cin, kh, kw); ``conv2d_transpose`` (Cin, Cout, kh, kw).
:func:`repro_torch.models.surrogate.params_from_jax` converts JAX weights.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels import ln_lrelu, ops
from repro_torch.obs.metrics import get_registry

Params = Mapping[str, torch.Tensor]


def he_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """He/Kaiming normal init, as ``repro/models/nn.py:he_normal``."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution (odd kernel)."""
    return F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)


def conv2d_transpose(p: Params, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Fractionally-strided conv with out = in * stride.

    The JAX layer is an lhs-dilated convolution with padding
    ``(k + s - 2) // 2`` on each side; for k = 4, s = 2 that equals
    ``conv_transpose2d(stride=2, padding=1)`` with the JAX kernel flipped
    spatially and stored (Cin, Cout, kh, kw).

    A spatial extent of 0 (the surrogate below a width of 16) comes out as
    1, as in the JAX layer: the lhs-dilated size 0, plus the padding
    ``k + s - 2``, minus ``k - 1``.  No input contributes, so every value is
    the bias; ``F.conv_transpose2d`` would refuse the empty input.
    """
    k = p["w"].shape[-1]
    if 0 in x.shape[2:]:
        h, w = (n * stride if n else 1 for n in x.shape[2:])
        # the empty sum is written out so that w and x keep their (zero)
        # gradients
        y = x.sum(dim=(2, 3)) @ p["w"].sum(dim=(2, 3)) + p["b"]
        return y[:, :, None, None].expand(-1, -1, h, w)
    pad = k - 1 - (k + stride - 2) // 2
    return F.conv_transpose2d(x, p["w"], p["b"], stride=stride, padding=pad)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize over the channel axis only (dim 1 of NCHW), population
    variance, as the JAX layer does over its last axis."""
    mu = x.mean(dim=1, keepdim=True)
    var = (x - mu).square().mean(dim=1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["g"][:, None, None]
            + p["b"][:, None, None])


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    # where(x >= 0) keeps JAX's gradient of 1 at exactly 0
    return torch.where(x >= 0, x, slope * x)


def layernorm_leaky_relu(p: Params, x: torch.Tensor, eps: float = 1e-5,
                         slope: float = 0.2) -> torch.Tensor:
    """``leaky_relu(layernorm(p, x))``, the surrogate's block.  On the CPU
    the two layers above, as they are; on the card the hand-written kernel
    pair (``kernels/ln_lrelu.py``) on x made contiguous (an empty extent
    comes out of ``conv2d_transpose`` expanded).  The registry counts
    ``surrogate.ln_blocks`` for every block and ``surrogate.ln_kernel_blocks``
    for every block that took the kernel."""
    reg = get_registry()
    reg.counter("surrogate.ln_blocks").add()
    if ops._on_cpu(x, p["g"], p["b"], kind="layer norm"):
        return leaky_relu(layernorm(p, x, eps), slope)
    reg.counter("surrogate.ln_kernel_blocks").add()
    return ln_lrelu.layernorm_leaky_relu(x.contiguous(), p["g"], p["b"], eps, slope)


def count_params(tree) -> int:
    """Number of scalars in a tree of tensors or arrays (mappings, lists,
    tuples; ``None`` holds none), or in a module's parameters, as
    ``repro/models/nn.py:count_params`` counts a pytree's leaves."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if tree is None:
        return 0
    if isinstance(tree, Mapping):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return math.prod(tree.shape) if hasattr(tree, "shape") else 1
