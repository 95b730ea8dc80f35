"""Learnable synthetic mini-study (no solver run), pure numpy.

A copy of ``repro/sim/synthetic.py``, so the port has data at full size
without the solver: conditions encode a phase, fields are smooth
phase-shifted channels with a positive density.  Same seed, same numbers.
"""
from __future__ import annotations

import numpy as np


def synthetic_study(n: int = 48, height: int = 16, width: int = 16,
                    base_channels: int = 16, noise: float = 0.02,
                    seed: int = 0):
    """Returns (model_cfg, conditions (n, cond_dim), fields (n, H, W, 6))."""
    # deferred: models.surrogate imports repro_torch.sim.solver, so a
    # module-level import here would be circular through sim/__init__
    from repro_torch.models.surrogate import SurrogateConfig

    rng = np.random.default_rng(seed)
    t = (np.linspace(0, 1, height)[:, None]
         + np.linspace(0, 1, width)[None, :])
    phases = rng.uniform(0, 6, n).astype(np.float32)
    fields = np.empty((n, height, width, 6), np.float32)
    for i, p in enumerate(phases):
        s = np.sin(3 * t + p)
        fields[i, ..., 0] = 2.0 + 0.5 * s                  # density > 0
        fields[i, ..., 1] = 0.3 * np.cos(3 * t + p)        # vx
        fields[i, ..., 2] = 0.3 * np.sin(2 * t - p)        # vy
        fields[i, ..., 3] = 1.0 + 0.2 * s                  # pressure
        fields[i, ..., 4] = 1.5 + 0.3 * s * s              # energy
        fields[i, ..., 5] = 0.5 + 0.5 * np.tanh(2 * s)     # material
    fields += noise * rng.standard_normal(fields.shape).astype(np.float32)
    cfg = SurrogateConfig(height=height, width=width,
                          base_channels=base_channels)
    cond = np.zeros((n, cfg.cond_dim), np.float32)
    cond[:, 0] = np.sin(phases)
    cond[:, 1] = np.cos(phases)
    return cfg, cond, fields
