"""Device milliseconds a training step spends in ``loss.backward()``: the
program's ``train.backward`` device ranges in the device stretch over its
steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "train.backward")
