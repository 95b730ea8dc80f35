"""The device memory the window's run held at its peak: PyTorch's caching
allocator's ``max_memory_allocated`` over the window (reset as it opens),
the resident store, weights, optimizer state and activations counted, in GB."""


def read(run):
    peak = run.window.peak
    return peak / 1e9 if peak else None
