"""``chip_smoke.profile_rows`` against torch.profiler's own ``key_averages()``.

``chip_smoke.py`` aggregates its profiles from the profiler's raw events
(``key_averages()`` costs tens of microseconds an event, and a window of
full-width decode steps holds hundreds of thousands).  Here on the CPU the
two aggregations are held equal on host work with nested operators, an
autograd backward and a second thread; ``chip_smoke.py`` holds them equal
on a card's profile, kernels included (``check_profile_rows``).  The
device's busy time (``device_busy_us``) is the union of its activities'
intervals: overlapping kernels on two streams count once, so a busy share
never passes 100%.
"""
import importlib.util
import pathlib
import threading

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _work(threads: int):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(32, 32, generator=g, requires_grad=True)
    x = torch.randn(16, 32, generator=g)

    def step():
        y = torch.nn.functional.silu(x @ w).to(torch.bfloat16).float()
        (y.softmax(-1) * y).sum().backward()

    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            step()
        pool = [threading.Thread(target=step) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    return prof


@pytest.mark.parametrize("threads", [0, 2])
def test_profile_rows_equal_key_averages(threads):
    prof = _work(threads)
    fast = {r.key: r for r in _chip_smoke().profile_rows(prof)}
    slow = {e.key: e for e in prof.key_averages()}
    assert set(fast) == set(slow)
    assert sum(e.count for e in slow.values()) > 100
    for k, s in slow.items():
        f = fast[k]
        assert (f.count, f.device_type) == (s.count, s.device_type), k
        if s.device_type == DeviceType.CPU:
            assert f.self_cpu_time_total == pytest.approx(s.self_cpu_time_total,
                                                          abs=1e-3 * s.count), k


class _Event:
    """The fields of a raw profiler event that ``device_busy_us`` reads."""

    def __init__(self, start, end, kind=DeviceType.CUDA, name="kernel", hidden=False):
        self.start, self.end, self.kind, self._name, self.hidden = start, end, kind, name, hidden

    def start_ns(self):
        return self.start

    def end_ns(self):
        return self.end

    def device_type(self):
        return self.kind

    def name(self):
        return self._name

    def is_hidden_event(self):
        return self.hidden


class _Prof:
    def __init__(self, events):
        results = type("Results", (), {"events": lambda _self: events})()
        self.profiler = type("Profiler", (), {"kineto_results": results})()


@pytest.mark.parametrize("events, want_us", [
    ([], 0.0),
    # two streams overlapping by 4 us, a third kernel after a gap: 20 + 6
    ([_Event(0, 10_000), _Event(6_000, 20_000), _Event(30_000, 36_000)], 26.0),
    # nested and touching intervals, given out of order
    ([_Event(5_000, 8_000), _Event(0, 10_000), _Event(10_000, 12_000)], 12.0),
    # host events, hidden events and the profiler's own are not device time
    ([_Event(0, 50_000, kind=DeviceType.CPU), _Event(0, 4_000, hidden=True),
      _Event(0, 4_000, name="[memory]"), _Event(1_000, 3_000)], 2.0),
])
def test_device_busy_is_the_union_of_intervals(events, want_us):
    cs = _chip_smoke()
    assert cs.device_busy_us(_Prof(events)) == want_us
    summed = sum((e.end - e.start) / 1e3 for e in events
                 if e.kind != DeviceType.CPU and not e.hidden and e.name() != "[memory]")
    assert cs.device_busy_us(_Prof(events)) <= summed


def test_device_busy_of_a_host_profile_is_zero():
    assert _chip_smoke().device_busy_us(_work(0)) == 0.0
