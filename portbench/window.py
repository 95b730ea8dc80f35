"""The measured window of a training run.

``tick(steps)`` is called with the number of steps the run has issued (a
hook after each step, or the loader before each draw).  At ``open_at``
steps the device is synchronised and the window opens: the peak-memory
counter is reset, the counters are read and, in a traced run, the profiler
starts.

A traced run traces two stretches of ``trace_steps`` steps each, the
device synchronised at every border.  The first records the device's
activity alone (``ProfilerActivity.CUDA``), which costs the host little:
the busy time, the kernels and their times come from it.  The second
records the host's operators too, which slows a host-bound step severalfold;
it serves only to name what the host was doing in the device's idle gaps.
The first tick at which ``seconds`` have passed synchronises the device,
closes the window and returns False; the steps counted are those issued,
and finished, inside it.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_profiler(dev: torch.device, host: bool):
    """A started ``torch.profiler`` of the device's activity, and of the
    host's operators too where ``host``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host or dev.type != "cuda" else []
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


class Window:
    def __init__(self, dev: torch.device, open_at: int, seconds: float,
                 trace_steps: int = 0,
                 counters: Optional[Callable[[], dict]] = None):
        self.dev = dev
        self.open_at, self.seconds, self.trace_steps = open_at, seconds, trace_steps
        self.counters = counters or (lambda: {})
        self.t_open = self.t_close = self.t_trace_end = self.t_host_trace_end = None
        self.steps = 0
        self.trace_end_step = None          # steps of the window in the device stretch
        self.host_trace_end_step = None     # ... and at the end of the host stretch
        self.peak_before = 0            # process peak before the window
        self.peak = 0                   # peak inside the window
        self.at_open: dict = {}
        self.at_close: dict = {}
        self.profiler = None                # the device stretch
        self.host_profiler = None           # the host stretch

    @property
    def is_open(self) -> bool:
        return self.t_open is not None and self.t_close is None

    @property
    def closed(self) -> bool:
        return self.t_close is not None

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

    def open(self) -> None:
        sync(self.dev)
        if self.dev.type == "cuda":
            self.peak_before = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.at_open = self.counters()
        if self.trace_steps:
            self.profiler = start_profiler(self.dev, host=False)
        self.t_open = time.perf_counter()

    def _stop_trace(self, steps: int) -> None:
        sync(self.dev)
        self.t_trace_end = time.perf_counter()
        self.trace_end_step = steps
        self.profiler.stop()

    def _stop_host_trace(self, steps: int) -> None:
        sync(self.dev)
        self.t_host_trace_end = time.perf_counter()
        self.host_trace_end_step = steps
        self.host_profiler.stop()

    def tick(self, steps: int) -> bool:
        """False once the window has closed."""
        if self.closed:
            return False
        if steps == self.open_at:
            self.open()
            return True
        if not self.is_open:
            return True
        inside = steps - self.open_at
        if (self.profiler is not None and self.trace_end_step is None
                and inside >= self.trace_steps):
            self._stop_trace(inside)
            self.host_profiler = start_profiler(self.dev, host=True)
        elif (self.host_profiler is not None and self.host_trace_end_step is None
              and inside >= 2 * self.trace_steps):
            self._stop_host_trace(inside)
        if time.perf_counter() - self.t_open < self.seconds:
            return True
        self.close(inside)
        return False

    def close(self, steps: int) -> None:
        """Synchronise and close the window after ``steps`` units of work."""
        sync(self.dev)
        self.t_close = time.perf_counter()
        self.steps = steps
        if self.profiler is not None and self.trace_end_step is None:
            self._stop_trace(steps)
        if self.host_profiler is not None and self.host_trace_end_step is None:
            self._stop_host_trace(steps)
        if self.dev.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.dev)
        self.at_close = self.counters()

    def host_stretch(self, fn: Callable[[], None]) -> None:
        """Trace ``fn()`` with the host's operators, after the window has
        closed (a run whose unit of work is one call, not a step)."""
        sync(self.dev)
        prof = start_profiler(self.dev, host=True)
        fn()
        sync(self.dev)
        prof.stop()
        self.host_profiler = prof

    def delta(self, key: str) -> float:
        return self.at_close.get(key, 0.0) - self.at_open.get(key, 0.0)
