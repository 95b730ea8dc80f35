"""Kernel 3, the fixed-rate decode of a host-streamed batch: its bound over
its device time in the traced window, in %.  Each launch decodes one batch
padded to its widest record (``portbench.counts.fr_decode``); the launches
in the trace are the batches from the store's count of finished batches
at the window's start on, in order (the prefetch thread decodes ahead of
the step)."""
import numpy as np

from portbench import counts, peaks

KERNEL = "decode_fr_kernel"


def read(run):
    t, store = run.trace_data, run.store
    launches = t.kernels(KERNEL) if t is not None else []
    if not launches or not hasattr(store, "widths"):
        return None
    b0 = int(run.window.at_open.get("batches", 0))
    batches = run.loader.drawn[b0:b0 + len(launches)]
    if len(batches) < len(launches):
        return None
    bound = 0.0
    for batch in batches:
        idx = np.asarray(batch).reshape(-1)
        blocks = idx.size * store.nb
        bound += peaks.bound_seconds(*counts.fr_decode(blocks, int(store.widths[idx].max())))
    return 100.0 * bound / (sum(e - s for s, e, _ in launches) / 1e9)
