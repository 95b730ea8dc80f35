"""Share of the traced production in which no activity ran on the device:
one less the union of its activities' intervals over the window, in %."""


def read(run):
    w, t = run.window, run.trace_data
    if t is None or not t.device or w.t_trace_end is None:
        return None
    window_ns = 1e9 * (w.t_trace_end - w.t_open)
    return 100.0 * (1.0 - t.busy_ns() / window_ns)
