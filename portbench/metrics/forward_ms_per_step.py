"""Device milliseconds a training step spends in its forward pass and L1
loss: the program's ``train.forward`` device ranges in the device stretch
over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "train.forward")
