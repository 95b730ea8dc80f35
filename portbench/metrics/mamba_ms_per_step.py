"""Device milliseconds an LM training step spends in its Mamba-2 mixers:
the program's ``lm.mamba`` device ranges (each Mamba-2 layer's mixer
forward, the recompute of the backward's checkpointed layers counted
too) in the device stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "lm.mamba")
