"""Device milliseconds an LM training step spends in autograd: the
program's ``lm.backward`` device ranges (the gradients, with the
recompute of the checkpointed layers and loss chunks) in the device
stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "lm.backward")
