"""Share of the device's busy time in cuDNN's transpose kernels
(``genericTranspose_kernel`` around vmap's grouped convolutions), in %."""


def read(run):
    t = run.trace_data
    busy = t.busy_ns() if t is not None else 0
    if not busy:
        return None
    spent = sum(e - s for s, e, name in t.kernels() if "transpose" in name.lower())
    return 100.0 * spent / busy
