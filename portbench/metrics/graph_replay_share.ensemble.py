"""Share of an ensemble cell's traced steps that replayed the step's CUDA
graphs instead of dispatching its kernels one by one: the program's
``ensemble.replay`` spans in the device stretch over its steps, x 100.
The eager path (the CPU, a host-streaming source, a program without the
graphs) records no such span, and the metric is then left out."""
from portbench.records import in_stretch


def read(run):
    steps = run.window.trace_end_step
    replays = in_stretch(run, "ensemble.replay")
    if not replays or not steps:
        return None
    return 100.0 * len(replays) / steps
