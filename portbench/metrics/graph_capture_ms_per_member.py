"""Host milliseconds a produced member spends on its solver's CUDA graph:
the program's ``datagen.capture`` spans (the capture with its device
synchronise, ``empty_cache`` and pool allocations, and the graph's
release) in the traced production over its members.  The traced
production is one member, so a run gives a single sample.  The CPU path
captures no graph, so it reads nothing there."""
from portbench.records import ms_per_step


def read(run):
    return ms_per_step(run, "datagen.capture")
