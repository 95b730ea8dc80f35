"""Ensemble generation: uniform parameter sampling -> simulation datasets.

Counterpart of ``repro/sim/ensemble.py`` (the same specs and the same
parameters from the same seed, drawn in numpy): each ensemble member is one
simulation of 51 time steps x 6 fields; each time step is a training
sample conditioned on (input parameters, time).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim.solver import PARAM_DIM, SimParams, run_simulation


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    name: str
    ny: int
    nx: int
    nsnaps: int = 51
    nsteps: int = 2000
    pchip: bool = False
    atwood_range: Tuple[float, float] = (0.25, 0.65)
    amplitude_range: Tuple[float, float] = (0.01, 0.05)
    mode_range: Tuple[float, float] = (1.0, 4.0)
    log_diff_range: Tuple[float, float] = (-3.9, -3.2)


# Paper: RT 768x256, PCHIP 512x512 -- scaled 8x for the container.
RT_SPEC = EnsembleSpec(name="rt", ny=96, nx=32)
PCHIP_SPEC = EnsembleSpec(name="pchip", ny=64, nx=64, pchip=True, nsteps=1600)


def sample_params(spec: EnsembleSpec, num: int, seed: int = 0) -> List[SimParams]:
    """Uniform sampling across each parameter dimension (paper §II)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num):
        p = SimParams(
            atwood=float(rng.uniform(*spec.atwood_range)),
            amplitude=float(rng.uniform(*spec.amplitude_range)),
            mode=float(rng.uniform(*spec.mode_range)),
            diffusivity=float(10 ** rng.uniform(*spec.log_diff_range)),
            pchip_seed=int(rng.integers(1, 2**31)) if spec.pchip else 0,
            impulse=float(rng.uniform(0.5, 2.0)) if spec.pchip else 0.0,
        )
        out.append(p)
    return out


def generate_ensemble(spec: EnsembleSpec, num_sims: int, seed: int = 0, *,
                      device: DeviceLike = None):
    """Returns (params (N, PARAM_DIM) f32 numpy, fields (N, T, H, W, 6) f32
    numpy), simulated on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    plist = sample_params(spec, num_sims, seed)
    fields = []
    for p in plist:
        f = run_simulation(p, ny=spec.ny, nx=spec.nx,
                           nsteps=spec.nsteps, nsnaps=spec.nsnaps, device=dev)
        fields.append(f.cpu().numpy())
    pvec = np.stack([p.as_vector() for p in plist])
    if pvec.shape[1] != PARAM_DIM:
        raise ValueError(f"parameter vectors of width {pvec.shape[1]}, "
                         f"expected {PARAM_DIM}")
    return pvec, np.stack(fields)
