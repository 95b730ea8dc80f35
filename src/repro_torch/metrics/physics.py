"""Physics-based quality metrics (paper Eqs. 2-4), on tensors.

Counterpart of ``repro/metrics/physics.py``.  Fields are channels-last
``(..., H, W, 6)`` with channel order (density, vx, vy, pressure, energy,
material); H is the y (gravity) axis.
"""
from __future__ import annotations

import torch


def total_mass(fields: torch.Tensor, cell_area: float = 1.0) -> torch.Tensor:
    """m = sum_i A rho_i (Eq. 2), reducing the (H, W) grid."""
    return cell_area * fields[..., 0].sum(dim=(-2, -1))


def total_momentum(fields: torch.Tensor, cell_area: float = 1.0) -> torch.Tensor:
    """p = sum_i A rho_i v_i (Eq. 3).  Returns (..., 2) = (px, py)."""
    rho = fields[..., 0]
    px = cell_area * (rho * fields[..., 1]).sum(dim=(-2, -1))
    py = cell_area * (rho * fields[..., 2]).sum(dim=(-2, -1))
    return torch.stack([px, py], dim=-1)


def mixing_layer_thickness(fields: torch.Tensor, rho1: float, rho2: float,
                           dy: float = 1.0) -> torch.Tensor:
    """h(t) = H - 2/(rho2-rho1) * integral |rho_bar(y) - (rho1+rho2)/2| dy
    (Eq. 4).  fields (..., H, W, 6) -> (...,) thickness in units of dy*H."""
    rho_bar = fields[..., 0].mean(dim=-1)                 # (..., H)
    height = fields.shape[-3] * dy
    mid = 0.5 * (rho1 + rho2)
    integral = (rho_bar - mid).abs().sum(dim=-1) * dy
    return height - (2.0 / (rho2 - rho1)) * integral


def timeseries_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation along the last (time) axis (Fig. 8 statistic)."""
    am = a - a.mean(dim=-1, keepdim=True)
    bm = b - b.mean(dim=-1, keepdim=True)
    num = (am * bm).sum(dim=-1)
    den = torch.sqrt((am * am).sum(dim=-1) * (bm * bm).sum(dim=-1))
    return num / torch.clamp(den, min=1e-12)
