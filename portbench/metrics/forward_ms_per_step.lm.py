"""Device milliseconds an LM training step spends in its forward pass and
loss: the program's ``lm.forward`` device ranges (``lm_loss``: the layers,
the head and the cross-entropy; the checkpointed layers' recompute falls
in the backward) in the device stretch over its steps."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "lm.forward")
