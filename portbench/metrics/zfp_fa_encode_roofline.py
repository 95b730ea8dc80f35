"""Kernel 2, the fixed-accuracy encode of the produced snapshots: its bound
over its device time in the traced production, in %.  Every launch encodes
whole samples (shard-sized chunks of a member's snapshots); the bound counts
each block's inputs (16 floats, its tolerance and the tolerance's exponent)
and outputs (the 15-word payload row, emax, plane count), and the operations
of one bound-verification pass (``portbench.counts.fa_encode``)."""
from portbench import counts, peaks

KERNEL = "encode_fa_kernel"


def read(run):
    t = run.trace_data
    spent = t.kernel_ns(KERNEL) if t is not None else 0
    if not spent:
        return None
    c = run.config
    blocks = run.window.steps * c["nsnaps"] * 6 * (-(-c["ny"] // 4)) * (-(-c["nx"] // 4))
    return 100.0 * peaks.bound_seconds(*counts.fa_encode(blocks)) / (spent / 1e9)
