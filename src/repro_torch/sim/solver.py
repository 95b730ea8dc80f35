"""2D Boussinesq vorticity-streamfunction spectral solver for RT/RM ensembles.

Counterpart of ``repro/sim/solver.py``: periodic pseudo-spectral
formulation (``torch.fft.rfft2``), 2/3 dealiasing, SSP-RK3 time stepping.
A heavy band sits mid-domain; with gravity -y its lower interface is
RT-unstable.  The interface perturbation eta(x) is either sinusoidal modes
(RT ensemble) or a PCHIP curve through random control points (PCHIP/RM-like
ensemble, with an impulsive gravity pulse approximating Richtmyer's model).

Outputs the paper's six fields per snapshot: density, vx, vy, pressure,
energy, material -- (T, H, W, 6) float32 on the device.

The arithmetic follows the JAX solver's in float32/complex64: the
wavenumbers, the 2/3 mask and ``nu * k2`` are formed in float32 on the host
exactly as XLA forms them, and each RK3 stage keeps its order and form.
One thing differs in form only: the vorticity and density travel as one
(2, ny, nx//2+1) stack, and the inverse transforms of one right-hand side
go through one batched ``irfft2`` (six fields) and the forward ones through
one ``rfft2`` (two), so a step launches 67 kernels where a plain
transcription launches 120-140.

On the card one snapshot interval (``nsteps // (nsnaps - 1)`` RK3 steps,
then the snapshot) is captured once per call in a CUDA graph and replayed
per snapshot with ``g`` in a device tensor; the same interval run eagerly
(``_simulate(..., graph=False)``) launches the same kernels and gives the
same bits.  Two ``datagen.capture`` spans hold what the graph costs the
host: its capture (the warm-up interval's dispatch; ``torch.cuda.graph``'s
device synchronise and ``empty_cache``, which frees every cached block;
the capture, its private pool's allocations and the instantiation) and
its release at the call's end (``phase="release"``: the graph destroyed
and its pool handed back).  Two calls with the same arguments on one
device give the same bits, which exact resume of a production run relies
on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace as obs_trace

FIELD_NAMES = ("density", "velocity_x", "velocity_y", "pressure", "energy", "material")
GAMMA = 5.0 / 3.0
PARAM_DIM = 6
DT = 1.5e-3          # the default time step, the JAX solver's fixed one


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Ensemble input parameters (the surrogate model's conditioning vector)."""
    atwood: float = 0.5          # (rho2-rho1)/(rho2+rho1)
    amplitude: float = 0.02      # interface perturbation amplitude (fraction of Lx)
    mode: float = 3.0            # dominant perturbation wavenumber (RT)
    diffusivity: float = 2e-4    # nu = kappa
    # PCHIP variant: control-point seed + impulse strength
    pchip_seed: int = 0
    impulse: float = 0.0         # >0: RM-like impulsive acceleration at t=0

    def as_vector(self) -> np.ndarray:
        return np.array([self.atwood, self.amplitude, self.mode,
                         np.log10(self.diffusivity), float(self.pchip_seed % 97) / 97.0,
                         self.impulse], dtype=np.float32)


def _pchip_interface(seed: int, nx: int, amplitude: float) -> np.ndarray:
    """PCHIP curve through random control points -> periodic eta(x)."""
    rng = np.random.default_rng(seed)
    ncp = 6
    xs = np.linspace(0.0, 1.0, ncp + 1)
    ys = rng.uniform(-1.0, 1.0, ncp + 1)
    ys[-1] = ys[0]                                # periodic
    # monotone-cubic (Fritsch-Carlson) Hermite slopes
    h = np.diff(xs)
    d = np.diff(ys) / h
    m = np.zeros(ncp + 1)
    m[1:-1] = np.where(np.sign(d[:-1]) * np.sign(d[1:]) > 0,
                       2.0 / (1.0 / np.where(d[:-1] == 0, 1, d[:-1]) +
                              1.0 / np.where(d[1:] == 0, 1, d[1:])), 0.0)
    m[0] = m[-1] = 0.5 * (d[0] + d[-1])
    x = np.linspace(0.0, 1.0, nx, endpoint=False)
    idx = np.clip(np.searchsorted(xs, x, side="right") - 1, 0, ncp - 1)
    t = (x - xs[idx]) / h[idx]
    h00 = 2 * t**3 - 3 * t**2 + 1
    h10 = t**3 - 2 * t**2 + t
    h01 = -2 * t**3 + 3 * t**2
    h11 = t**3 - t**2
    eta = (h00 * ys[idx] + h10 * h[idx] * m[idx]
           + h01 * ys[idx + 1] + h11 * h[idx] * m[idx + 1])
    eta -= eta.mean()
    return (amplitude * eta).astype(np.float32)


def _initial_fields(p: SimParams, ny: int, nx: int, lx: float, ly: float,
                    device: DeviceLike = "cpu"):
    """Initial (rho, omega) float32 tensors on ``device``, rho1, rho2;
    heavy band mid-domain."""
    x = np.linspace(0.0, lx, nx, endpoint=False)
    y = np.linspace(0.0, ly, ny, endpoint=False)
    xx = x[None, :]
    yy = y[:, None]
    rho1 = 1.0
    rho2 = rho1 * (1 + p.atwood) / (1 - p.atwood)
    delta = 0.02 * ly
    y_lo, y_hi = 0.35 * ly, 0.8 * ly
    if p.impulse > 0 or p.pchip_seed:
        eta = _pchip_interface(p.pchip_seed, nx, p.amplitude * lx)[None, :]
    else:
        k = 2 * np.pi * p.mode / lx
        eta = (p.amplitude * lx * (np.cos(k * xx)
               + 0.3 * np.cos(2 * k * xx + 1.1) + 0.2 * np.cos(3 * k * xx + 2.3)))
    band = 0.5 * (np.tanh((yy - (y_lo + eta)) / delta)
                  - np.tanh((yy - y_hi) / delta))
    rho = rho1 + (rho2 - rho1) * band
    omega = np.zeros_like(rho)
    dev = torch.device(device)
    return (torch.from_numpy(rho.astype(np.float32)).to(dev),
            torch.from_numpy(omega.astype(np.float32)).to(dev), rho1, rho2)


def _wavenumbers(ny: int, nx: int, lx: float, ly: float):
    """kx (nx//2+1,) and ky (ny,) float32, as ``jnp.fft.rfftfreq`` /
    ``fftfreq`` with a traced float32 spacing, times 2 pi."""
    f32 = np.float32
    dnx = (f32(lx) / f32(nx)) * f32(nx)
    dny = (f32(ly) / f32(ny)) * f32(ny)
    kx = np.arange(nx // 2 + 1, dtype=f32) / dnx
    i = np.arange(ny, dtype=f32)
    ky = ((i + f32(ny // 2)) % f32(ny) - f32(ny // 2)) / dny
    two_pi = lambda k: (k * f32(2)) * f32(np.pi)
    return two_pi(kx), two_pi(ky)


class _Operators:
    """The step's constant arrays and per-member scalars, on the device."""

    def __init__(self, ny: int, nx: int, lx: float, ly: float, nu: float,
                 rho0_mean: float, dev: torch.device):
        f32, c64 = np.float32, np.complex64
        kx, ky = _wavenumbers(ny, nx, lx, ly)
        kxg, kyg = kx[None, :], ky[:, None]
        k2 = kxg * kxg + kyg * kyg
        inv_k2 = np.where(k2 > 0, f32(1.0) / np.maximum(k2, f32(1e-12)),
                          f32(0.0)).astype(f32)
        # 2/3 dealiasing: float32 |k| against float32 (2/3) max|k|
        mask = ((np.abs(kxg) <= f32(2 / 3) * np.abs(kx).max())
                & (np.abs(kyg) <= f32(2 / 3) * np.abs(ky).max())).astype(f32)
        shape = (ny, nx // 2 + 1)
        ikx = np.broadcast_to((1j * kxg).astype(c64), shape)
        iky = np.broadcast_to((1j * kyg).astype(c64), shape)
        nikx = np.broadcast_to((-1j * kxg).astype(c64), shape)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        self.ny, self.nx = ny, nx
        self.kx = t(kxg)                                # (1, nxh) f32
        self.ky = t(kyg)                                # (ny, 1) f32
        self.inv_k2 = t(inv_k2)
        self.mask = t(mask)
        self.nuk2 = t(f32(nu) * k2)                     # nu * k2, float32
        self.k_vel = t(np.stack([iky, nikx]))           # u = iky psi, v = -ikx psi
        self.k_grad = t(np.stack([ikx, iky]))           # d/dx, d/dy
        # divisors live on the device: a CUDA division by a host scalar is a
        # multiply by its reciprocal, XLA's is a true division
        self.rho0 = torch.tensor(rho0_mean, dtype=torch.float32, device=dev)
        self.three = torch.tensor(3, dtype=torch.complex64, device=dev)


def _to_grid(fh: torch.Tensor, op: _Operators) -> torch.Tensor:
    """Batched ``irfft2`` over the last two dims."""
    return torch.fft.irfft2(fh, s=(op.ny, op.nx))


def _rhs(s: torch.Tensor, bk: torch.Tensor, op: _Operators) -> torch.Tensor:
    """d/dt of the (omega_h, rho_h) stack ``s``; ``bk`` is the buoyancy
    factor ``-(g / rho0) * 1j * kx``."""
    ny, nxh = s.shape[-2:]
    psi = s[0] * op.inv_k2                              # psi: lap psi = -omega
    gh = torch.empty((6, ny, nxh), dtype=s.dtype, device=s.device)
    torch.mul(psi, op.k_vel, out=gh[0:2])               # u_h, v_h
    torch.mul(s.unsqueeze(1), op.k_grad, out=gh[2:].view(2, 2, ny, nxh))
    grid = _to_grid(gh, op)
    u, v = grid[0], grid[1]
    d = grid[2:].view(2, 2, op.ny, op.nx)               # (om, rh) x (d/dx, d/dy)
    adv = torch.fft.rfft2(d[:, 0] * u + d[:, 1] * v)    # (adv_om, adv_rh)
    buoy = bk * s[1]                                    # -g/rho0 * d rho/dx
    out = -adv
    out[0] += buoy
    return (out - op.nuk2 * s) * op.mask


def _rk3_step(s: torch.Tensor, bk: torch.Tensor, dt: float,
              op: _Operators) -> torch.Tensor:
    s1 = s + dt * _rhs(s, bk, op)
    s2 = 0.75 * s + 0.25 * (s1 + dt * _rhs(s1, bk, op))
    return s / op.three + 2 / 3 * (s2 + dt * _rhs(s2, bk, op))


def _snapshot(s: torch.Tensor, g: torch.Tensor, op: _Operators) -> torch.Tensor:
    """(ny, nx, 6) fields of the state ``s`` under gravity ``g``."""
    ny, nxh = s.shape[-2:]
    h = torch.empty((3, ny, nxh), dtype=s.dtype, device=s.device)
    torch.mul(s[0] * op.inv_k2, op.k_vel, out=h[0:2])
    h[2] = s[1]
    grid = _to_grid(h, op)
    u, v, rho = grid[0], grid[1], grid[2]
    # pressure Poisson: lap p = 2 rho0 (u_x v_y - u_y v_x) - g d rho/dy
    uv_h = torch.fft.rfft2(grid[0:2])
    q = _to_grid(uv_h.unsqueeze(1) * op.k_grad, op)     # (u, v) x (d/dx, d/dy)
    ux, uy, vx, vy = q[0, 0], q[0, 1], q[1, 0], q[1, 1]
    rhs_p = (torch.fft.rfft2(2 * op.rho0 * (ux * vy - uy * vx))
             - g * 1j * op.ky * s[1])
    p = _to_grid(-rhs_p * op.inv_k2, op)
    rho_safe = torch.clamp(rho, min=0.05)
    energy = p / ((GAMMA - 1) * rho_safe) + 0.5 * (u * u + v * v)
    material = rho                                     # normalized downstream
    return torch.stack([rho, u, v, p, energy, material], dim=-1)


def _interval(s: torch.Tensor, g: torch.Tensor, steps: int, dt: float,
              op: _Operators) -> torch.Tensor:
    """``steps`` RK3 steps of the state ``s`` (updated in place) under
    gravity ``g``, then its snapshot."""
    bk = -(g / op.rho0) * 1j * op.kx
    state = s
    for _ in range(steps):
        state = _rk3_step(state, bk, dt, op)
    s.copy_(state)
    return _snapshot(s, g, op)


def _captured_interval(s: torch.Tensor, g: torch.Tensor, steps: int, dt: float,
                       op: _Operators):
    """:func:`_interval` of the card-resident ``s`` and ``g`` captured in a
    CUDA graph: returns (the graph, the snapshot tensor each replay
    rewrites).  The warm-up on a copy of ``s`` builds the cuFFT plans
    first.  Other threads may use the card during the capture (the
    datagen writer copies chunks on a stream of its own)."""
    dev = s.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _interval(s.clone(), g, steps, dt, op)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        snap = _interval(s, g, steps, dt, op)
    return graph, snap


def _gravity(params: SimParams, nsnaps: int, g: float) -> np.ndarray:
    if params.impulse > 0:
        g_t = np.full((nsnaps,), 0.05 * g, np.float32)
        g_t[:3] = g * (1.0 + params.impulse)
    else:
        g_t = np.full((nsnaps,), g, np.float32)
    return g_t


def _simulate(params: SimParams, ny: int, nx: int, nsteps: int, nsnaps: int,
              lx: float, ly: float, dt: float, g: float, dev: torch.device,
              graph: bool) -> torch.Tensor:
    rho, omega, rho1, rho2 = _initial_fields(params, ny, nx, lx, ly, dev)
    op = _Operators(ny, nx, lx, ly, params.diffusivity, 0.5 * (rho1 + rho2), dev)
    g_t = torch.from_numpy(_gravity(params, nsnaps, g)).to(dev)
    steps = nsteps // (nsnaps - 1)
    s = torch.stack([torch.fft.rfft2(omega), torch.fft.rfft2(rho)])
    g_now = g_t[0].clone()
    out = torch.empty((nsnaps, ny, nx, 6), dtype=torch.float32, device=dev)
    out[0] = _snapshot(s, g_now, op)
    if graph and nsnaps > 1:
        with obs_trace.span("datagen.capture", cat="datagen", phase="capture"):
            cuda_graph, snap = _captured_interval(s, g_now, steps, dt, op)
        for t in range(1, nsnaps):
            g_now.copy_(g_t[t])
            cuda_graph.replay()
            out[t] = snap
        with obs_trace.span("datagen.capture", cat="datagen", phase="release"):
            del snap
            cuda_graph.reset()
    else:
        for t in range(1, nsnaps):
            g_now.copy_(g_t[t])
            out[t] = _interval(s, g_now, steps, dt, op)
    # normalize material to [0,1]
    span = torch.tensor(rho2 - rho1, dtype=torch.float32, device=dev)
    out[..., 5] = torch.clamp((out[..., 5] - rho1) / span, 0.0, 1.0)
    return out


def run_simulation(params: SimParams, ny: int = 96, nx: int = 32,
                   nsteps: int = 2000, nsnaps: int = 51,
                   lx: float = 1.0, ly: float = 3.0,
                   dt: float = DT, g: float = 4.0, *,
                   device: DeviceLike = None) -> torch.Tensor:
    """Run one simulation; returns (nsnaps, ny, nx, 6) float32 on ``device``
    (the card unless ``device="cpu"``; on the card each snapshot interval
    replays one CUDA graph).

    ``params.impulse > 0`` switches to RM-like impulsive forcing: a strong
    gravity pulse for the first snapshot intervals, then g ~ 0 (coasting),
    approximating shock-driven Richtmyer-Meshkov growth.
    """
    dev = resolve_device(device)
    return _simulate(params, ny, nx, nsteps, nsnaps, lx, ly, dt, g, dev,
                     graph=dev.type == "cuda")
