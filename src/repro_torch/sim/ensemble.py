"""Ensemble generation: uniform parameter sampling -> simulation datasets.

Counterpart of ``repro/sim/ensemble.py`` (the same specs and the same
parameters from the same seed, drawn in numpy): each ensemble member is one
simulation of 51 time steps x 6 fields; each time step is a training
sample conditioned on (input parameters, time).  A spec carries its
solver's time step, ``dt``: the JAX package's specs have none and run at
the solver's default, which holds up to ``RT_SPEC``'s grid but not at the
paper's RT grid, where the largest resolved wavenumbers are 8x larger.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim.solver import DT, PARAM_DIM, SimParams, run_simulation


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
    dt: float = DT

    @property
    def rk3_steps(self) -> int:
        """RK3 steps a member simulates: whole snapshot intervals."""
        return self.nsteps // (self.nsnaps - 1) * (self.nsnaps - 1)


# Paper: RT 768x256, PCHIP 512x512.  RT_SPEC and PCHIP_SPEC are those grids
# scaled 8x down, at the default time step; RT_PAPER_SPEC is the paper's RT
# grid, at RT_SPEC's step scaled with the grid (1.5e-3 x 32/256) over the
# same end time, 3.0.  On the card its fastest members keep the advective
# CFL number dt (max|u| kx_max + max|v| ky_max) at 0.52; twice the step
# stays finite but passes 1, and 1.5e-3 turns members non-finite.
RT_SPEC = EnsembleSpec(name="rt", ny=96, nx=32)
PCHIP_SPEC = EnsembleSpec(name="pchip", ny=64, nx=64, pchip=True, nsteps=1600)
RT_PAPER_SPEC = EnsembleSpec(name="rt", ny=768, nx=256, nsteps=16000, dt=1.875e-4)


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
        f = run_simulation(p, ny=spec.ny, nx=spec.nx, nsteps=spec.nsteps,
                           nsnaps=spec.nsnaps, dt=spec.dt, device=dev)
        fields.append(f.cpu().numpy())
    pvec = np.stack([p.as_vector() for p in plist])
    if pvec.shape[1] != PARAM_DIM:
        raise ValueError(f"parameter vectors of width {pvec.shape[1]}, "
                         f"expected {PARAM_DIM}")
    return pvec, np.stack(fields)
