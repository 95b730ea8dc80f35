"""The solver's time step carried by the ensemble spec, and production's
refusal of a non-finite member, on the CPU.

  * a plan of the default specs leaves ``dt`` out of its JSON and hashes
    as the JAX package's plan does; a plan of ``RT_PAPER_SPEC`` carries
    its step, reads back and hashes apart (and the JAX package, whose
    specs have no ``dt``, refuses it);
  * ``produce`` simulates at the spec's ``dt``: the fields it encodes equal
    ``run_simulation(..., dt=spec.dt)`` bit for bit;
  * at a 3:1 grid and ``RT_PAPER_SPEC``'s step, the port's eager solver
    equals the benchmark's plain solver (``portbench/reference/solver.py``)
    stepped by its own ``_rk3_step`` and ``_snapshot`` bit for bit: the
    reference is a frozen copy of the same float32 and complex64
    arithmetic in the same order, so no tolerance is needed; and it is
    within tests/test_torch_solver.py's ``SMALL_RTOL`` of the JAX solver
    run at the same step (JAX's ``run_simulation`` takes ``dt``; only a
    plan that carries one is beyond the JAX package);
  * a member driven non-finite by an absurd step, or holding one planted
    NaN or infinity, makes ``produce`` raise, naming the member and its
    first bad snapshot, with nothing finalized;
    the registry's ``datagen.nonfinite_members``, ``datagen.rk3_steps``
    and ``datagen.simulate_seconds`` count what production did.
"""
import dataclasses
import importlib
import json
import os

import pytest
import torch

import numpy as np

import repro.datagen as jax_datagen
from repro.sim import solver as jax_solver

from portbench.reference import solver as ref_solver
from repro_torch.data.shards import MANIFEST_NAME
from repro_torch.datagen import (CodecPlan, NonFiniteMemberError, ProductionPlan,
                                 ScenarioPlan, finalize, produce)
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.ensemble import (PCHIP_SPEC, RT_PAPER_SPEC, RT_SPEC, EnsembleSpec,
                                      sample_params)
from repro_torch.sim.solver import DT, FIELD_NAMES, SimParams, run_simulation

torch.set_num_threads(2)
produce_mod = importlib.import_module("repro_torch.datagen.produce")

CPU = dict(device="cpu")
SMALL_RTOL = 1e-5                    # tests/test_torch_solver.py's, per field


def _plan(*specs, members=2, seed=3):
    return ProductionPlan(scenarios=tuple(ScenarioPlan(s.name + str(k), s, members, seed)
                                          for k, s in enumerate(specs)),
                          codec=CodecPlan(tolerance=1e-3), shard_size=4)


def _count(name):
    return get_registry().snapshot().get(name, 0)


def _observed(name):
    """(count, total) of a histogram of the registry."""
    h = get_registry().snapshot().get(name, {"count": 0})
    return h["count"], h["count"] and h["mean"] * h["count"]


# -- the step in the spec and the plan -----------------------------------------------------

def test_existing_specs_keep_the_default_step():
    assert DT == 1.5e-3
    assert RT_SPEC.dt == PCHIP_SPEC.dt == DT
    assert RT_PAPER_SPEC.nsteps * RT_PAPER_SPEC.dt == pytest.approx(RT_SPEC.nsteps * RT_SPEC.dt)
    assert RT_PAPER_SPEC.nsteps % (RT_PAPER_SPEC.nsnaps - 1) == 0
    assert (RT_PAPER_SPEC.ny, RT_PAPER_SPEC.nx) == (768, 256)


@pytest.mark.parametrize("specs", [(RT_SPEC,), (PCHIP_SPEC,), (RT_SPEC, PCHIP_SPEC)],
                         ids=["rt", "pchip", "both"])
def test_default_plans_leave_dt_out_and_hash_as_jax(specs):
    plan = _plan(*specs)
    for sd in plan.to_dict()["scenarios"]:
        assert "dt" not in sd["spec"]
    jplan = jax_datagen.ProductionPlan.from_dict(plan.to_dict())
    assert plan.config_hash() == jplan.config_hash()
    assert ProductionPlan.from_dict(jplan.to_dict()) == plan


def test_paper_grid_plan_carries_its_step():
    plan, rt = _plan(RT_PAPER_SPEC), _plan(RT_SPEC)
    d = json.loads(json.dumps(plan.to_dict()))
    assert d["scenarios"][0]["spec"]["dt"] == RT_PAPER_SPEC.dt
    back = ProductionPlan.from_dict(d)
    assert back == plan and back.scenarios[0].spec.dt == RT_PAPER_SPEC.dt
    assert back.config_hash() == plan.config_hash() != rt.config_hash()
    # same grid, default step: another plan
    assert plan.config_hash() != _plan(dataclasses.replace(RT_PAPER_SPEC, dt=DT)).config_hash()
    with pytest.raises(TypeError):
        jax_datagen.ProductionPlan.from_dict(d)


# -- production at the spec's step ---------------------------------------------------------

SPEC = EnsembleSpec(name="rt", ny=16, nx=8, nsnaps=6, nsteps=30, dt=7.5e-4)


def test_produce_simulates_at_the_spec_step(tmp_path, monkeypatch):
    seen = []

    def spy(*a, **kw):
        seen.append(run_simulation(*a, **kw))
        return seen[-1]
    monkeypatch.setattr(produce_mod, "run_simulation", spy)
    plan = _plan(SPEC)
    assert produce(plan, str(tmp_path), **CPU).finalized
    params = plan.scenarios[0].params()
    assert len(seen) == len(params)
    for p, got in zip(params, seen):
        grid = dict(ny=SPEC.ny, nx=SPEC.nx, nsteps=SPEC.nsteps, nsnaps=SPEC.nsnaps, **CPU)
        assert torch.equal(got, run_simulation(p, dt=SPEC.dt, **grid))
        assert not torch.equal(got, run_simulation(p, **grid))


def _reference_loop(p: SimParams, ny, nx, nsteps, nsnaps, dt):
    """The benchmark's plain solver, stepped at ``dt`` by its own pieces."""
    rho, omega, rho1, rho2 = ref_solver._initial_fields(p, ny, nx, ref_solver.LX,
                                                        ref_solver.LY)
    op = ref_solver._Operators(ny, nx, ref_solver.LX, ref_solver.LY, p.diffusivity,
                               0.5 * (rho1 + rho2), torch.device("cpu"))
    g_t = torch.from_numpy(ref_solver._gravity(p, nsnaps, ref_solver.G))
    s = torch.stack([torch.fft.rfft2(omega), torch.fft.rfft2(rho)])
    out = torch.empty((nsnaps, ny, nx, 6))
    out[0] = ref_solver._snapshot(s, g_t[0].clone(), op)
    for t in range(1, nsnaps):
        g = g_t[t].clone()
        bk = -(g / op.rho0) * 1j * op.kx
        for _ in range(nsteps // (nsnaps - 1)):
            s = ref_solver._rk3_step(s, bk, dt, op)
        out[t] = ref_solver._snapshot(s, g, op)
    span = torch.tensor(rho2 - rho1, dtype=torch.float32)
    out[..., 5] = torch.clamp((out[..., 5] - rho1) / span, 0.0, 1.0)
    return out


PAPER_STEP_GRID = dict(ny=48, nx=16, nsteps=4 * 25, nsnaps=5)
_paper_step = {}


def _port_at_paper_step(member):
    if member not in _paper_step:
        p = sample_params(RT_PAPER_SPEC, 2, seed=5)[member]
        _paper_step[member] = p, run_simulation(p, dt=RT_PAPER_SPEC.dt,
                                                **PAPER_STEP_GRID, **CPU)
    return _paper_step[member]


@pytest.mark.parametrize("member", range(2))
def test_eager_solver_at_the_paper_step_equals_the_reference(member):
    p, port = _port_at_paper_step(member)
    assert torch.equal(port, _reference_loop(p, dt=RT_PAPER_SPEC.dt, **PAPER_STEP_GRID))
    assert torch.isfinite(port).all()


@pytest.mark.parametrize("member", range(2))
def test_eager_solver_at_the_paper_step_matches_jax(member):
    p, port = _port_at_paper_step(member)
    want = np.asarray(jax_solver.run_simulation(p, dt=RT_PAPER_SPEC.dt, **PAPER_STEP_GRID))
    got = port.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # a default-step run differs by far more, so the step reached both solvers
    default = np.asarray(jax_solver.run_simulation(p, **PAPER_STEP_GRID))
    for f in range(len(FIELD_NAMES)):
        scale = np.abs(want[..., f]).max()
        assert np.abs(got[..., f] - want[..., f]).max() / scale <= SMALL_RTOL, FIELD_NAMES[f]
    assert max(np.abs(default[..., f] - want[..., f]).max() / np.abs(want[..., f]).max()
               for f in range(len(FIELD_NAMES))) > 100 * SMALL_RTOL


# -- refusal and counters ------------------------------------------------------------------

ABSURD = EnsembleSpec(name="rt", ny=48, nx=16, nsnaps=6, nsteps=10, dt=0.5)


def test_non_finite_member_is_refused_and_nothing_finalized(tmp_path):
    plan = _plan(ABSURD)
    sc = plan.scenarios[0]
    fields = run_simulation(sc.params()[0], ny=ABSURD.ny, nx=ABSURD.nx,
                            nsteps=ABSURD.nsteps, nsnaps=ABSURD.nsnaps, dt=ABSURD.dt, **CPU)
    bad = [t for t in range(ABSURD.nsnaps) if not torch.isfinite(fields[t]).all()]
    assert bad and bad[0] > 0
    before = _count("datagen.nonfinite_members")
    with pytest.raises(NonFiniteMemberError,
                       match=rf"scenario '{sc.name}', member 0: .* snapshot {bad[0]} of 6"):
        produce(plan, str(tmp_path), **CPU)
    assert _count("datagen.nonfinite_members") == before + 1
    sdir = tmp_path / sc.name
    assert not (sdir / MANIFEST_NAME).exists()
    assert not any(n.startswith("shard_") for n in os.listdir(sdir))
    assert not finalize(plan, str(tmp_path))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")],
                         ids=["nan", "inf", "-inf"])
def test_one_non_finite_value_refuses_its_member(tmp_path, monkeypatch, bad):
    def planted(params, **kw):
        fields = run_simulation(params, **kw)
        if params == plan.scenarios[0].params()[1]:
            fields[3, 5, 2, 4] = bad
        return fields
    monkeypatch.setattr(produce_mod, "run_simulation", planted)
    plan = _plan(SPEC)
    with pytest.raises(NonFiniteMemberError, match="member 1: .* snapshot 3 of 6"):
        produce(plan, str(tmp_path), **CPU)
    assert not finalize(plan, str(tmp_path))


def test_counters_count_a_known_production(tmp_path):
    spec = dataclasses.replace(SPEC, nsteps=32)       # 6 RK3 steps an interval, 2 left over
    assert spec.rk3_steps == 30
    steps0, (n0, total0) = _count("datagen.rk3_steps"), _observed("datagen.simulate_seconds")
    bad0 = _count("datagen.nonfinite_members")
    assert produce(_plan(spec, members=3), str(tmp_path), **CPU).finalized
    assert _count("datagen.rk3_steps") == steps0 + 3 * 30
    n1, total1 = _observed("datagen.simulate_seconds")
    assert n1 == n0 + 3 and total1 > total0
    assert _count("datagen.nonfinite_members") == bad0
    # generate_ensemble does not produce, and counts nothing
    from repro_torch.sim.ensemble import generate_ensemble
    generate_ensemble(spec, 1, **CPU)
    assert _count("datagen.rk3_steps") == steps0 + 3 * 30
