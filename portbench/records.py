"""The program's own records of a traced run, for the metrics that read
them: the spans and device ranges that ``repro_torch.obs.trace`` keeps
while a ``torch.profiler`` capture runs (or in the tracer a caller
configured), those whose host stamps fall in the window's device stretch,
``[t_open, t_trace_end]``.

A program that keeps no such records gives none, and every metric read
from them is then left out of the run's line.
"""
from __future__ import annotations

from typing import List, Optional


def in_stretch(run, name: str) -> List[dict]:
    """The records named ``name`` that began inside the device stretch."""
    w = run.window
    if w is None or w.t_open is None or w.t_trace_end is None:
        return []
    from repro_torch.obs import trace
    # an older program has no capture tracer: its traced runs, read with
    # these files too, then leave these metrics out
    capture_tracer = getattr(trace, "capture_tracer", lambda: None)
    tracer = trace.get_tracer() or capture_tracer()
    if tracer is None:
        return []
    lo, hi = tracer.rel(w.t_open), tracer.rel(w.t_trace_end)
    return [e for e in tracer.events() if e["name"] == name and lo <= e["ts"] <= hi]


def seconds(run, name: str) -> Optional[float]:
    """Summed seconds of the records named ``name`` in the device stretch:
    device seconds of a device range, host seconds of a span."""
    found = in_stretch(run, name)
    return sum(e["dur"] for e in found) if found else None


def ms_per_step(run, name: str) -> Optional[float]:
    """Milliseconds of ``name`` a unit of work (a step; a member in
    datagen) over the device stretch's units."""
    total, steps = seconds(run, name), run.window.trace_end_step
    if total is None or not steps:
        return None
    return 1e3 * total / steps
