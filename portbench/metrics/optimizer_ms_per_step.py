"""Device milliseconds a training step spends in Adam and the copy of the
updated parameters back: the program's ``train.optimizer`` device ranges
in the device stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "train.optimizer")
