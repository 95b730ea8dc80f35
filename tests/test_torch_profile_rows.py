"""``chip_smoke.profile_rows`` against torch.profiler's own ``key_averages()``.

``chip_smoke.py`` aggregates its profiles from the profiler's raw events
(``key_averages()`` costs tens of microseconds an event, and a window of
full-width decode steps holds hundreds of thousands).  Here on the CPU the
two aggregations are held equal on host work with nested operators, an
autograd backward and a second thread; ``chip_smoke.py`` holds them equal
on a card's profile, kernels included (``check_profile_rows``).
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
