"""Simulation substrate: miniature Rayleigh-Taylor / PCHIP-perturbed ensembles.

A 2D Boussinesq vorticity-streamfunction spectral solver in PyTorch (cuFFT
through ``torch.fft`` on the card, one CUDA graph per snapshot interval)
generates the training ensembles: 51 snapshots x 6 fields (density, vx,
vy, pressure, energy, material) per simulation, mirroring the paper's
Table I datasets at container scale.  ``synthetic_study`` gives learnable
data without a solver run.
"""
from repro_torch.sim.solver import FIELD_NAMES, PARAM_DIM, SimParams, run_simulation
from repro_torch.sim.ensemble import (
    EnsembleSpec, RT_SPEC, PCHIP_SPEC, generate_ensemble, sample_params,
)
from repro_torch.sim.synthetic import synthetic_study

__all__ = [
    "SimParams", "run_simulation", "FIELD_NAMES", "PARAM_DIM",
    "EnsembleSpec", "RT_SPEC", "PCHIP_SPEC", "generate_ensemble", "sample_params",
    "synthetic_study",
]
