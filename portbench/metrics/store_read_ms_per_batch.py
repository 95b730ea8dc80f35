"""Host milliseconds a batch spent reading records from the store: the
store's ``IoStats.read_seconds`` over its batches, in the window."""


def read(run):
    w = run.window
    if "read_seconds" not in w.at_open or w.delta("batches") <= 0:
        return None
    return 1e3 * w.delta("read_seconds") / w.delta("batches")
