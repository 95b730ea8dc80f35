"""Image-quality metrics, as ``repro/metrics/image.py`` computes them."""
from __future__ import annotations

import torch


def psnr(ref: torch.Tensor, test: torch.Tensor, axis=(-2, -1)) -> torch.Tensor:
    """Peak signal-to-noise ratio over the grid axes ``axis``, per field and
    sample.  The peak is the reference's per-sample range (max - min),
    clamped at 1e-12; the MSE is clamped at 1e-20."""
    axis = tuple(axis)
    mse = (ref - test).square().mean(dim=axis)
    peak = ref.amax(dim=axis) - ref.amin(dim=axis)
    peak = torch.clamp(peak, min=1e-12)
    return 10.0 * torch.log10(peak.square() / torch.clamp(mse, min=1e-20))
