"""Device milliseconds an LM training step spends in its MoE blocks: the
program's ``lm.moe`` device ranges (each layer's routing, held experts and
shared expert, forward; the recompute of the backward's checkpointed
layers counted too) in the device stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "lm.moe")
