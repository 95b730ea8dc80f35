"""Device milliseconds an ensemble step spends in the stacked Adam update:
the program's ``ensemble.optimizer`` device ranges in the device stretch
over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "ensemble.optimizer")
