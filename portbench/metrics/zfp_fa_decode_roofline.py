"""Kernel 1, the gathered fixed-accuracy decode: its bound over its device
time in the traced steps, in %.  The bound counts each launch's inputs as
the device-resident store holds them: every gathered block's payload words
(ceil of its plane count over two), emax and plane count, the indices, and
the decoded floats (``portbench.counts.fa_gather_decode``)."""
import numpy as np

from portbench import counts, peaks

KERNEL = "decode_fa_gather_kernel"


def read(run):
    t, store = run.trace_data, run.store
    spent = t.kernel_ns(KERNEL) if t is not None else 0
    if not spent or not hasattr(store, "nplanes"):
        return None
    width = store.payload.shape[-1]
    bound = 0.0
    for batch in run.traced_batches():
        idx = np.asarray(batch).reshape(-1)
        planes = store.nplanes[idx].cpu().numpy()
        words = np.minimum((planes + 1) // 2, width)
        bound += peaks.bound_seconds(*counts.fa_gather_decode(words, idx.size))
    return 100.0 * bound / (spent / 1e9)
