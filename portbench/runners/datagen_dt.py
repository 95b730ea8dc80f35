"""Runner of the datagen cells whose configuration sets the solver's time
step (``dt``, RT at its 768x256 grid): the ``datagen`` runner whole, with
its reference simulating each checked member at the configuration's
``dt``.  ``portbench/reference/solver.py`` steps at its module constant
``DT`` (RT_SPEC's 1.5e-3, the step of the cells written before a
configuration could set one); the check and the calibration run with that
constant set to the configuration's step and put back after."""
from __future__ import annotations

from portbench.reference import solver
from portbench.runners import datagen


def _at_step(dt: float, fn):
    def call():
        before = solver.DT
        solver.DT = dt
        try:
            return fn()
        finally:
            solver.DT = before
    return call


def run(run) -> None:
    datagen.run(run)
    dt = float(run.config["dt"])
    run.check, run.calibrate = _at_step(dt, run.check), _at_step(dt, run.calibrate)
