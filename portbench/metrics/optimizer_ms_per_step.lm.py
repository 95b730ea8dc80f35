"""Device milliseconds an LM training step spends in the launcher's Adam:
the program's ``lm.optimizer`` device ranges (the clip, the moments and
the parameters, updated in place) in the device stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "lm.optimizer")
