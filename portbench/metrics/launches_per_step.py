"""Kernels the device ran per training step, over the traced steps
(copies and sets not counted)."""


def read(run):
    steps = run.window.trace_end_step
    kernels = run.trace_data.kernels() if run.trace_data is not None else []
    if not kernels or not steps:
        return None
    return len(kernels) / steps
