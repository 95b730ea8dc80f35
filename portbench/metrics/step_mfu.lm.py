"""The whole LM training step's share of the card's dense BF16 peak: the
model FLOPs of the steps outside the host-operator stretch
(``portbench.lm_counts``: the device stretch, whose device-only capture
costs the host little, and the steps after the host stretch) over their
host-clock time and 989 TFLOP/s, in %."""
from portbench import lm_counts


def read(run):
    w = run.window
    steps, seconds = w.steps, w.t_close - w.t_open
    if w.host_trace_end_step is not None:
        steps -= w.host_trace_end_step - w.trace_end_step
        seconds -= w.t_host_trace_end - w.t_trace_end
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * run.flops_per_step * steps / seconds / lm_counts.BF16_FLOPS_PER_S
