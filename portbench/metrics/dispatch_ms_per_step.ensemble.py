"""Host milliseconds the ensemble takes to dispatch a step, from the step
function's call to its return with no synchronise: the program's
``ensemble.dispatch`` spans in the device stretch over its steps.  Near
the step's own time, the host paces the device."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "ensemble.dispatch")
