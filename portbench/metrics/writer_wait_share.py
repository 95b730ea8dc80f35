"""Share of the traced production the producer waited on the shard
writer: the program's ``datagen.writer_wait`` spans (a ``put`` on a full
queue, ``close`` joining the worker) over the device stretch, in %.

The traced production is one member, whose two chunks never fill the
queue: the reading is almost all ``close`` draining that member's copy
out and shard writes, not the ``put`` waits that pace a production of
many members.  It shows the writer's drain, not its steady state."""
from portbench.records import seconds


def read(run):
    w = run.window
    waited = seconds(run, "datagen.writer_wait")
    if waited is None:
        return None
    return 100.0 * waited / (w.t_trace_end - w.t_open)
