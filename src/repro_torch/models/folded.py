"""The surrogate's forward for a seed ensemble, its members folded into the
channels of one channels-last batch.

Training N members of one ``SurrogateConfig`` at once, member ``m``'s
channels are group ``m`` of every activation: an activation is the
contiguous ``(B, H, W, N, C)``, which as NCHW is the channels-last
``(B, N * C, H, W)``.  Each convolution is one grouped ``conv2d`` /
``conv_transpose2d`` with ``groups = N`` on it, which cuDNN takes as
channels-last, without the generic transposes it wraps around grouped
NCHW convolutions.  The bias is added on the folded view: PyTorch adds
a cuDNN convolution's bias in a kernel of its own anyway, and its
gradient is then a plain sum on every device (oneDNN's fused one, on the
CPU, accumulates in sequence).  The layer norm reduces each member's
own C, the innermost axis; the leaky ReLU is elementwise.  Members share
no parameter, so each member's prediction is the single model's.

The parameters are the stacked state dict ``{name: (N, ...)}`` of
:func:`repro_torch.models.surrogate.stack_params`.  A stacked weight
reshapes into the grouped one for free and is copied into channels-last
inside the forward, so autograd returns the gradients of the stacks.
The single model's layers (``models/nn.py``, ``Surrogate.forward``) are
not used here.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.nn import leaky_relu

Params = Mapping[str, torch.Tensor]


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, N, C) -> its channels-last (B, N * C, H, W) view."""
    return x.flatten(3).permute(0, 3, 1, 2)


def _unfold(y: torch.Tensor, n: int) -> torch.Tensor:
    """A convolution's channels-last (B, N * C, H, W) -> its (B, H, W, N, C)
    view."""
    return y.permute(0, 2, 3, 1).unflatten(3, (n, -1))


def _grouped(w: torch.Tensor) -> torch.Tensor:
    """Stacked (N, O, I, kh, kw) weights -> the grouped (N * O, I, kh, kw),
    channels-last."""
    return w.flatten(0, 1).contiguous(memory_format=torch.channels_last)


def dense(w: torch.Tensor, b: torch.Tensor, cond: torch.Tensor,
          grid: tuple) -> torch.Tensor:
    """cond (N, B, cond_dim) @ w (N, cond_dim, h0 * w0 * C) + b -> the folded
    (B, h0, w0, N, C) seed grid, ``grid = (h0, w0, C)``."""
    x = torch.baddbmm(b.unsqueeze(1), cond, w)
    return x.unflatten(2, grid).permute(1, 2, 3, 0, 4).contiguous()


def conv2d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 'SAME' convolution of every member: w (N, Cout, Cin, k, k),
    b (N, Cout), x (B, H, W, N, Cin) -> (B, H, W, N, Cout)."""
    n, k = w.shape[0], w.shape[-1]
    y = F.conv2d(_as_nchw(x), _grouped(w), padding=k // 2, groups=n)
    return _unfold(y, n) + b


def conv2d_transpose(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                     stride: int = 2) -> torch.Tensor:
    """Fractionally-strided convolution of every member, out = in * stride:
    w (N, Cin, Cout, k, k), b (N, Cout), x (B, H, W, N, Cin) -> (B, H *
    stride, W * stride, N, Cout), the single model's padding.  A spatial
    extent of 0 comes out as 1 and every value is the bias, as in the
    single model's layer."""
    n, k = w.shape[0], w.shape[-1]
    if 0 in x.shape[1:3]:
        h, wd = (s * stride if s else 1 for s in x.shape[1:3])
        # the empty sum is written out so that w and x keep their (zero)
        # gradients
        y = torch.einsum("bni,nio->bno", x.sum(dim=(1, 2)), w.sum(dim=(-2, -1))) + b
        return y[:, None, None].expand(-1, h, wd, -1, -1)
    pad = k - 1 - (k + stride - 2) // 2
    y = F.conv_transpose2d(_as_nchw(x), _grouped(w), stride=stride, padding=pad,
                           groups=n)
    return _unfold(y, n) + b


def layernorm(g: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Normalize each member's channels, the innermost axis of (B, H, W, N,
    C), population variance; g, b (N, C)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def folded_forward(cfg, params: Params, cond: torch.Tensor) -> torch.Tensor:
    """Every member's forward: stacked ``params``, cond (N, B, cond_dim) ->
    (N, B, H, W, fields), a view of the folded (B, H, W, N, fields)
    output."""
    def p(layer):
        return params[f"{layer}.w"], params[f"{layer}.b"]

    def ln(layer, x):
        return leaky_relu(layernorm(params[f"{layer}.g"], params[f"{layer}.b"], x))

    grid = (cfg.height // 16, cfg.width // 16, cfg.base_channels)
    x = ln("ln_in", dense(*p("proj"), cond, grid))
    for i in range(4):
        x = leaky_relu(conv2d_transpose(*p(f"up{i}_t"), x))
        x = ln(f"up{i}_ln", conv2d(*p(f"up{i}_c"), x))
    return conv2d(*p("out"), x).permute(3, 0, 1, 2, 4)
