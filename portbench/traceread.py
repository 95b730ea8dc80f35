"""Reduction of a ``torch.profiler`` trace to what the metrics read.

The profiler's raw events are read once (``key_averages()`` builds an
object and a tree for every event, far too slow for a window of thousands
of kernels).  The device is busy over the union of its activities'
intervals (kernels, copies, sets): activities on different streams
overlap, so their summed times can pass the wall time and the union
cannot.  An idle gap is named by the innermost host event that was open,
at the gap's middle, on the thread that launched most kernels.
"""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

# names the profiler's own aggregation leaves out, and host bookkeeping
SKIP = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                  "profiler::_record_function_enter_new",
                  "profiler::_record_function_exit", "aten::is_leaf",
                  "aten::output_nr", "aten::_version"))
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
TOP = 10


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """Total length of the union of [start, end) intervals."""
    busy, start, end = 0, None, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += 0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (0 if end is None else end - start)


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short_name(name: str, limit: int = 120) -> str:
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    return (name if cut <= 0 else name[:cut])[:limit]


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class Trace:
    """Device activities ``(start_ns, end_ns, name)`` and host events
    ``(thread, start_ns, end_ns, name)`` of one traced window."""

    def __init__(self, device: Sequence[Tuple[int, int, str]],
                 host: Sequence[Tuple[int, int, int, str]] = ()):
        self.device = sorted(device)
        self.host = list(host)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name in SKIP or e.is_hidden_event():
                continue
            if e.device_type() != DeviceType.CPU:
                device.append((e.start_ns(), e.end_ns(), name))
            elif e.start_thread_id() == e.end_thread_id():
                host.append((e.start_thread_id(), e.start_ns(), e.end_ns(), name))
        return cls(device, host)

    # -- device ---------------------------------------------------------------
    def kernels(self, match: str = "") -> List[Tuple[int, int, str]]:
        return [d for d in self.device if is_kernel(d[2]) and match in d[2]]

    def busy_ns(self) -> int:
        return union_ns((s, e) for s, e, _ in self.device)

    def kernel_ns(self, match: str) -> int:
        return sum(e - s for s, e, _ in self.kernels(match))

    def device_ops(self) -> List[List]:
        by: Dict[str, int] = defaultdict(int)
        for s, e, name in self.device:
            by[short_name(name)] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    # -- idle gaps --------------------------------------------------------------
    def launch_thread(self):
        counts = Counter(t for t, _, _, n in self.host if n in LAUNCH_CALLS)
        return counts.most_common(1)[0][0] if counts else None

    def idle_gaps(self) -> List[List]:
        """The idle gaps between device activities, summed by what the host
        was doing at each gap's middle; the ten largest sums."""
        spans = merged((s, e) for s, e, _ in self.device)
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) // 2)
                       for a, b in zip(spans, spans[1:])), reverse=True)
        thread = self.launch_thread()
        events = sorted((s, e, n) for t, s, e, n in self.host if t == thread)
        starts = [s for s, _, _ in events]
        by: Dict[str, int] = defaultdict(int)
        for length, mid in gaps[:200]:
            label = "(no profiled host event)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if events[j][1] >= mid:         # the latest open event is the innermost
                    label = events[j][2]
                    break
            by[short_name(label)] += length
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
