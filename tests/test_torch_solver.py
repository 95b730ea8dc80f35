"""The port's spectral solver against the JAX solver, on the CPU.

The same ``SimParams`` and grids go through ``repro.sim.solver`` and
``repro_torch.sim.solver``.  Held to a tolerance, not to the golden hashes
of tests/test_solver.py (those are XLA's bits):

  * 16x8 / 40 steps and 32x16 / 300 steps, RT and PCHIP: every field within
    ``SMALL_RTOL`` of that field's largest magnitude;
  * one full ``RT_SPEC`` member (96x32, 2000 steps, 51 snapshots) with the
    RT parameters of tests/test_solver.py: within ``FULL_RTOL``.  The
    Rayleigh-Taylor instability amplifies rounding: a difference of 6e-7
    at the start grows to 1e-4 here, and to 6e-4..1.5e-2 (worst field) on
    the first four members ``sample_params(RT_SPEC, 4, 0)`` draws, where
    the instability grows faster; a transcription without the batched
    transforms grows the same way;
  * the golden summary statistics to tests/test_solver.py's ``atol``, mass
    conservation and energy sanity with that file's limits, the same bits
    across two calls;
  * the interface, the initial fields, the wavenumbers and the ensemble's
    parameters equal to the JAX package's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import ensemble as jax_ensemble
from repro.sim import solver as jax_solver

from repro_torch.sim import ensemble, solver
from repro_torch.sim.solver import FIELD_NAMES, SimParams, run_simulation

torch.set_num_threads(2)

RT = SimParams(atwood=0.4, amplitude=0.03, mode=2.0)
PCHIP = SimParams(atwood=0.5, amplitude=0.03, pchip_seed=11, impulse=1.0)
PARAMS = {"rt": RT, "pchip": PCHIP}
TINY = dict(ny=16, nx=8, nsteps=40, nsnaps=5)
SMALL = dict(ny=32, nx=16, nsteps=300, nsnaps=11)
GRIDS = {"16x8": TINY, "32x16": SMALL}
SMALL_RTOL = 1e-5
FULL_RTOL = 1e-3
# tests/test_solver.py GOLDEN_STATS: (mean, std) of the TINY fields
GOLDEN_STATS = {"rt": (0.342214, 0.971820), "pchip": (0.395370, 1.793113)}

_cache = {}


def _port(name, grid):
    key = ("port", name, grid)
    if key not in _cache:
        _cache[key] = run_simulation(PARAMS[name], **GRIDS[grid],
                                     device="cpu").numpy()
    return _cache[key]


def _jax(name, grid):
    key = ("jax", name, grid)
    if key not in _cache:
        _cache[key] = np.asarray(jax_solver.run_simulation(PARAMS[name],
                                                           **GRIDS[grid]))
    return _cache[key]


def _worst_rel(got, want):
    """Largest per-field difference over that field's largest magnitude."""
    return max(float(np.abs(got[..., f] - want[..., f]).max()
                     / np.abs(want[..., f]).max())
               for f in range(len(FIELD_NAMES)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_matches_jax_solver(name, grid):
    got, want = _port(name, grid), _jax(name, grid)
    assert got.shape == want.shape and got.dtype == np.float32
    assert _worst_rel(got, want) <= SMALL_RTOL


def test_full_rt_member_matches_jax():
    spec = ensemble.RT_SPEC
    full = dict(ny=spec.ny, nx=spec.nx, nsteps=spec.nsteps, nsnaps=spec.nsnaps)
    got = run_simulation(RT, **full, device="cpu").numpy()
    want = np.asarray(jax_solver.run_simulation(RT, **full))
    assert got.shape == (51, 96, 32, 6)
    assert np.isfinite(got).all()
    assert _worst_rel(got, want) <= FULL_RTOL


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_tiny_grid_golden_stats(name):
    arr = _port(name, "16x8")
    assert arr.shape == (5, 16, 8, len(FIELD_NAMES))
    assert np.isfinite(arr).all()
    mean, std = GOLDEN_STATS[name]
    np.testing.assert_allclose(arr.mean(), mean, atol=1e-4)
    np.testing.assert_allclose(arr.std(), std, atol=1e-4)


def test_deterministic_across_calls():
    a = run_simulation(RT, **TINY, device="cpu")
    b = run_simulation(RT, **TINY, device="cpu")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_mass_conservation(name):
    f = _port(name, "32x16")
    mass = f[..., 0].sum(axis=(1, 2))
    assert mass[0] > 0
    drift = np.max(np.abs(mass - mass[0]) / mass[0])
    assert drift < 1e-5, f"total mass drifted by {drift:.2e}"


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_energy_sanity(name):
    f = _port(name, "32x16")
    assert np.isfinite(f).all()
    ke = (0.5 * f[..., 0] * (f[..., 1] ** 2 + f[..., 2] ** 2)).sum(axis=(1, 2))
    assert ke[0] == pytest.approx(0.0, abs=1e-10)   # starts at rest
    assert ke.max() > 0                              # instability does grow
    assert ke.max() < 100.0                          # ... and stays bounded
    assert f[..., 5].min() >= 0.0 and f[..., 5].max() <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 11, 2**31 - 1])
@pytest.mark.parametrize("nx", [8, 64])
def test_pchip_interface_matches_jax(seed, nx):
    got = solver._pchip_interface(seed, nx, 0.03)
    want = jax_solver._pchip_interface(seed, nx, 0.03)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_initial_fields_match_jax(name):
    rho, omega, r1, r2 = solver._initial_fields(PARAMS[name], 96, 32, 1.0, 3.0)
    jrho, jomega, jr1, jr2 = jax_solver._initial_fields(PARAMS[name], 96, 32,
                                                        1.0, 3.0)
    assert (r1, r2) == (jr1, jr2)
    assert rho.dtype == torch.float32 and rho.device.type == "cpu"
    assert np.array_equal(rho.numpy().view(np.int32),
                          np.asarray(jrho).view(np.int32))
    assert np.array_equal(omega.numpy(), np.asarray(jomega))


@pytest.mark.parametrize("grid", [(96, 32, 1.0, 3.0), (64, 64, 1.0, 3.0),
                                  (16, 8, 1.0, 3.0), (30, 10, 0.7, 2.3)])
def test_wavenumbers_and_mask_match_jax(grid):
    """The f32 wavenumbers and the 2/3 mask, as XLA forms them with a
    traced float32 spacing inside the jitted integrator."""
    ny, nx, lx, ly = grid

    @jax.jit
    def jax_k(lx, ly):
        kx = jnp.fft.rfftfreq(nx, d=lx / nx) * 2 * jnp.pi
        ky = jnp.fft.fftfreq(ny, d=ly / ny) * 2 * jnp.pi
        mask = ((jnp.abs(kx[None, :]) <= (2 / 3) * jnp.max(jnp.abs(kx))) &
                (jnp.abs(ky[:, None]) <= (2 / 3) * jnp.max(jnp.abs(ky))))
        return kx, ky, mask.astype(jnp.float32)

    kx, ky = solver._wavenumbers(ny, nx, lx, ly)
    op = solver._Operators(ny, nx, lx, ly, 2e-4, 2.0, torch.device("cpu"))
    jkx, jky, jmask = (np.asarray(a) for a in jax_k(lx, ly))
    assert np.array_equal(kx.view(np.int32), jkx.view(np.int32))
    assert np.array_equal(ky.view(np.int32), jky.view(np.int32))
    assert np.array_equal(op.mask.numpy(), jmask)


@pytest.mark.parametrize("spec", ["RT_SPEC", "PCHIP_SPEC"])
def test_sample_params_match_jax(spec):
    got = ensemble.sample_params(getattr(ensemble, spec), 8, seed=3)
    want = jax_ensemble.sample_params(getattr(jax_ensemble, spec), 8, seed=3)
    assert [p.__dict__ for p in got] == [p.__dict__ for p in want]
    assert all(np.array_equal(a.as_vector(), b.as_vector())
               for a, b in zip(got, want))


def test_generate_ensemble_on_cpu():
    spec = ensemble.EnsembleSpec(name="rt", ny=16, nx=8, nsnaps=3, nsteps=4)
    pvec, fields = ensemble.generate_ensemble(spec, 2, seed=5, device="cpu")
    jpvec, jfields = jax_ensemble.generate_ensemble(spec, 2, seed=5)
    assert np.array_equal(pvec, jpvec)
    assert fields.shape == jfields.shape == (2, 3, 16, 8, 6)
    assert _worst_rel(fields, jfields) <= SMALL_RTOL
