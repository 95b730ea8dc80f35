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
    """
    k = p["w"].shape[-1]
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
