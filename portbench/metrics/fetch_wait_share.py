"""Share of the window the train loop waited for batches: the program's
``train.fetch_wait_seconds`` counter over the window, in %."""


def read(run):
    if "fetch_wait" not in run.window.at_open:
        return None
    return 100.0 * run.window.delta("fetch_wait") / run.window.length
