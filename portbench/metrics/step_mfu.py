"""The whole step's share of the card's peak: the model FLOPs of the steps
after the two traced stretches (``portbench.counts``) over their host-clock time
and the peak of the configuration's precision (float32 outside the tensor
cores, or TF32), in %."""
from portbench import peaks


def read(run):
    w = run.window
    steps = w.steps - (w.host_trace_end_step or w.trace_end_step or 0)
    seconds = w.t_close - (w.t_host_trace_end or w.t_trace_end or w.t_open)
    if steps <= 0 or seconds <= 0:
        return None
    peak = peaks.TF32_FLOPS_PER_S if run.config["tf32"] else peaks.F32_FLOPS_PER_S
    return 100.0 * run.flops_per_step * steps / seconds / peak
