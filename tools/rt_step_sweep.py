"""The RT ensemble at the paper's 768x256 grid under candidate solver time steps.

    python tools/rt_step_sweep.py [--members 27] [--seed 0]
        [--dts 1.5e-3,7.5e-4,3.75e-4,1.875e-4] [--out FILE] [--device cuda]

Every time step keeps RT's end time, 3.0 (``nsteps = 3.0 / dt``).  The
members are ``--members`` drawn from ``--seed`` as a production plan draws
them, then the four corners of the parameter box at the largest Atwood
number and the smallest diffusivity (amplitude and mode at their ends),
where the flow is fastest.  For each step and member it prints one JSON
line: the first snapshot with a non-finite field (null if none), the
largest advective CFL number ``dt (max|u| kx_max + max|v| ky_max)`` over
the member's finite snapshots, where ``kx_max`` and ``ky_max`` are the
largest wavenumbers the 2/3 rule keeps, and the member's seconds.  Then
it runs ``produce`` of the drawn members at each step under which one of
them turned non-finite, and prints the error that refuses it.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.datagen import (CodecPlan, NonFiniteMemberError,  # noqa: E402
                                 ProductionPlan, ScenarioPlan, produce)
from repro_torch.sim import solver  # noqa: E402
from repro_torch.sim.ensemble import RT_PAPER_SPEC, sample_params  # noqa: E402

END_TIME = 3.0


def corners(spec):
    return [solver.SimParams(atwood=spec.atwood_range[1], amplitude=a, mode=m,
                             diffusivity=10 ** spec.log_diff_range[0])
            for a in spec.amplitude_range for m in spec.mode_range]


def kept_wavenumbers(spec):
    """The largest |kx| and |ky| the 2/3 rule keeps."""
    kx, ky = solver._wavenumbers(spec.ny, spec.nx, 1.0, 3.0)
    kx, ky = np.abs(kx), np.abs(ky)
    return (float(kx[kx <= np.float32(2 / 3) * kx.max()].max()),
            float(ky[ky <= np.float32(2 / 3) * ky.max()].max()))


def member(p, spec, dev, kxm, kym) -> dict:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    f = solver.run_simulation(p, ny=spec.ny, nx=spec.nx, nsteps=spec.nsteps,
                              nsnaps=spec.nsnaps, dt=spec.dt, device=dev)
    finite = f.isfinite().view(spec.nsnaps, -1).all(1).cpu().numpy()
    seconds = time.perf_counter() - t0
    umax = f[..., 1].abs().amax((1, 2)).cpu().numpy()
    vmax = f[..., 2].abs().amax((1, 2)).cpu().numpy()
    cfl = spec.dt * (umax * kxm + vmax * kym)
    bad = np.flatnonzero(~finite)
    return {"first_nonfinite": int(bad[0]) if bad.size else None,
            "cfl_max": float(cfl[finite].max()),
            "umax": float(umax[finite].max()), "vmax": float(vmax[finite].max()),
            "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=27)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dts", default="1.5e-3,7.5e-4,3.75e-4,1.875e-4")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = open(args.out, "a") if args.out else None
    kxm, kym = kept_wavenumbers(RT_PAPER_SPEC)
    drawn = sample_params(RT_PAPER_SPEC, args.members, args.seed)
    params = drawn + corners(RT_PAPER_SPEC)
    failing = []
    for dt in (float(x) for x in args.dts.split(",")):
        spec = dataclasses.replace(RT_PAPER_SPEC, dt=dt, nsteps=round(END_TIME / dt))
        rows = []
        for i, p in enumerate(params):
            row = {"dt": dt, "nsteps": spec.nsteps, "member": i,
                   "drawn": i < len(drawn), **dataclasses.asdict(p),
                   **member(p, spec, dev, kxm, kym)}
            rows.append(row)
            for stream in (sys.stdout, out):
                if stream:
                    print(json.dumps(row), file=stream, flush=True)
        bad = [r for r in rows if r["first_nonfinite"] is not None]
        print(json.dumps({"dt": dt, "members": len(rows), "nonfinite": len(bad),
                          "first_nonfinite": sorted(r["first_nonfinite"] for r in bad),
                          "cfl_max": max(r["cfl_max"] for r in rows),
                          "us_per_step": 1e6 * sum(r["seconds"] for r in rows)
                          / (len(rows) * spec.rk3_steps)}), flush=True)
        if any(r["drawn"] for r in bad):
            failing.append(spec)
    for spec in failing:
        plan = ProductionPlan(scenarios=(ScenarioPlan(spec.name, spec, args.members, args.seed),),
                              codec=CodecPlan(tolerance=1e-3))
        with tempfile.TemporaryDirectory() as root:
            try:
                produce(plan, root, device=dev)
                print(json.dumps({"dt": spec.dt, "produce": "finalized"}), flush=True)
            except NonFiniteMemberError as e:
                print(json.dumps({"dt": spec.dt, "produce": f"refused: {e}"}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
