"""The port's tracer on the CPU: recording under a ``torch.profiler`` capture,
the epoch clock of its Chrome export, device ranges, parent ids, and the
datagen spans.

  * under a CPU capture, a program span and a ``record_function`` around
    the same code line up on the exported clock within 1 ms;
  * under a capture with no tracer configured, ``train_surrogate`` records
    each step phase's range once a step with the step's number, and
    ``train_ensemble`` its ``ensemble.dispatch`` span and ranges;
  * outside a capture nothing records, and ``annotation()`` stays null
    under one;
  * a device range waits for nothing: it resolves by ``query()`` when a
    later range begins, or when the tracer is read;
  * every record carries its id, parent and depth in both exports,
    ``tools/trace_report_torch.py`` takes self times from the parent ids and
    sums the device ranges, and ``tools/trace_report.py`` still reads both
    exports;
  * the capture's tracer keeps the newest records of a process's captures;
  * ``datagen.writer_wait`` is recorded in a tiny ``produce``, for a full
    queue and for ``close``.
"""
import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core.ensemble import train_ensemble
from repro_torch.data import DeviceResidentCompressedStore, RawArrayStore, channels_last
from repro_torch.datagen import (CodecPlan, ProductionPlan, ScenarioPlan, ShardWriter,
                                 produce)
from repro_torch.models.surrogate import SurrogateConfig
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.ensemble import EnsembleSpec
from repro_torch.train.loop import TrainConfig, train_surrogate

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

CFG = dict(height=16, width=16, base_channels=8)
PHASES = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def clean_telemetry():
    obs_trace.shutdown(write=False)
    get_registry().reset()
    yield
    obs_trace.shutdown(write=False)
    get_registry().reset()


def _capture():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _study(n=32):
    fields = np.random.default_rng(0).normal(size=(n, 16, 16, 6)).astype(np.float32)
    cond = np.random.default_rng(1).normal(
        size=(n, SurrogateConfig(**CFG).cond_dim)).astype(np.float32)
    return cond, fields


def _resident(fields):
    samples = np.ascontiguousarray(fields.transpose(0, 3, 1, 2))
    return DeviceResidentCompressedStore.from_samples(samples, [1e-2] * len(fields),
                                                      device="cpu")


def _by_name(events, name):
    return [e for e in events if e["name"] == name]


# ---------------------------------------------------------------------------
# the clock and the two switches
# ---------------------------------------------------------------------------

def test_span_and_record_function_line_up_on_the_exported_clock(tmp_path):
    with record_function("warm"):           # the first region pays a set-up
        pass
    prof = _capture()
    with obs_trace.span("matmul"):
        with record_function("matmul"):
            torch.ones(256, 256) @ torch.ones(256, 256)
    prof.stop()
    path = tmp_path / "kineto.json"
    prof.export_chrome_trace(str(path))
    kineto = json.loads(path.read_text())
    ours = obs_trace.capture_tracer().chrome_trace()
    assert ours["baseTimeNanoseconds"] == kineto["baseTimeNanoseconds"]
    (k,) = [e for e in kineto["traceEvents"] if e.get("name") == "matmul"]
    (o,) = [e for e in ours["traceEvents"] if e["name"] == "matmul"]
    assert abs(k["ts"] - o["ts"]) < 1000.0
    assert abs((k["ts"] + k["dur"]) - (o["ts"] + o["dur"])) < 1000.0


def test_nothing_records_outside_a_capture():
    cond, fields = _study(16)
    train_surrogate(SurrogateConfig(**CFG), TrainConfig(epochs=1, batch_size=8, prefetch=0),
                    cond, _resident(fields), target_transform=channels_last, device="cpu")
    assert obs_trace.get_tracer() is None and obs_trace.capture_tracer() is None
    assert obs_trace.active() is None
    assert obs_trace.span("x") is obs_trace.NULL_SPAN
    assert obs_trace.device_range("x", "cpu") is obs_trace.NULL_SPAN


def test_annotation_stays_null_under_a_capture():
    prof = _capture()
    try:
        assert torchprof.annotation("x") is obs_trace.NULL_SPAN
        assert obs_trace.span("x") is not obs_trace.NULL_SPAN
        assert not obs_trace.enabled()
    finally:
        prof.stop()
    assert obs_trace.span("x") is obs_trace.NULL_SPAN
    assert obs_trace.capture_tracer() is not None      # still readable


# ---------------------------------------------------------------------------
# the training steps' phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["host", "device_resident"])
def test_capture_records_each_phase_once_a_step(kind):
    cond, fields = _study()
    if kind == "host":
        store, transform = RawArrayStore(fields, device="cpu"), None
    else:
        store, transform = _resident(fields), channels_last
    prof = _capture()
    try:
        train_surrogate(SurrogateConfig(**CFG),
                        TrainConfig(epochs=1, batch_size=8, max_steps=4, prefetch=0),
                        cond, store, target_transform=transform, device="cpu")
    finally:
        prof.stop()
    assert obs_trace.get_tracer() is None
    events = obs_trace.capture_tracer().events()
    steps = {e["args"]["step"]: e for e in _by_name(events, "train.step")}
    assert sorted(steps) == [1, 2, 3, 4]
    phases = PHASES + (("train.gather_decode",) if kind == "device_resident" else ())
    for name in phases:
        ranges = _by_name(events, name)
        assert [e["args"]["step"] for e in ranges] == [1, 2, 3, 4], name
        for r in ranges:
            parent = steps[r["args"]["step"]]
            assert r["ph"] == "R" and r["dur"] > 0 and r["parent"] == parent["id"]
            assert parent["ts"] <= r["ts"] <= parent["ts"] + parent["dur"]
    assert bool(_by_name(events, "train.gather_decode")) == (kind == "device_resident")


def test_capture_records_the_ensemble_dispatch_and_ranges():
    cond, fields = _study(16)
    prof = _capture()
    try:
        res = train_ensemble(SurrogateConfig(**CFG),
                             TrainConfig(epochs=1, batch_size=4, log_every=2), cond,
                             _resident(fields), (0, 1), target_transform=channels_last,
                             device="cpu")
    finally:
        prof.stop()
    assert res.steps == 4
    events = obs_trace.capture_tracer().events()
    dispatches = {e["args"]["step"]: e for e in _by_name(events, "ensemble.dispatch")}
    assert sorted(dispatches) == [1, 2, 3, 4]
    for name in ("ensemble.gather_decode", "ensemble.grad", "ensemble.optimizer"):
        ranges = _by_name(events, name)
        assert [e["args"]["step"] for e in ranges] == [1, 2, 3, 4], name
        assert all(r["parent"] == dispatches[r["args"]["step"]]["id"] for r in ranges)


# ---------------------------------------------------------------------------
# device ranges resolve without a synchronise
# ---------------------------------------------------------------------------

class _Event:
    """Stands in for a ``torch.cuda.Event``: done once ``done`` is set."""

    def __init__(self, ms=0.0):
        self.done, self.ms, self.waited = False, ms, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = not self.done
        self.done = True

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_a_device_range_resolves_by_query_or_when_read():
    tracer = obs_trace.Tracer()
    first = (_Event(1.0), _Event(3.5))
    second = (_Event(4.0), _Event(4.5))
    for name, (start, end) in (("a", first), ("b", second)):
        tracer._pending.append((name, 0.0, 1, 0, None, {"step": 1}, start, end))
    tracer._poll()                               # nothing finished: nothing waits
    assert not tracer._events and len(tracer._pending) == 2
    first[1].done = True
    tracer._poll()                               # a later range resolves the first
    (a,) = tracer._events
    assert (a["name"], a["dur"], a["args"]) == ("a", pytest.approx(2.5e-3), {"step": 1})
    assert not first[1].waited
    (_, b) = tracer.events()                     # reading resolves the rest
    assert b["name"] == "b" and b["dur"] == pytest.approx(0.5e-3) and second[1].waited


# ---------------------------------------------------------------------------
# parent ids in both exports, and the reports that read them
# ---------------------------------------------------------------------------

def _nested_run(tmp_path):
    tracer = obs_trace.configure(str(tmp_path), run="ids")
    with obs_trace.span("outer", step=7) as outer:
        with obs_trace.span("inner"):
            with obs_trace.device_range("phase", "cpu"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        obs_trace.instant("mark")
        obs_trace.counter("slots", active=1)
    events = {e["name"]: e for e in tracer.events()}
    return outer, events, obs_trace.shutdown()


def test_parent_ids_in_both_exports(tmp_path):
    import trace_report_torch
    outer, events, paths = _nested_run(tmp_path)
    assert events["outer"]["id"] == outer.id and events["outer"]["parent"] is None
    assert events["inner"]["parent"] == outer.id and events["inner"]["depth"] == 1
    assert events["phase"]["parent"] == events["inner"]["id"]
    assert events["phase"]["args"] == {"step": 7}
    assert events["mark"]["parent"] == events["slots"]["parent"] == outer.id
    lines = [json.loads(line) for line in open(paths["events"])]
    assert {(e["name"], e["type"], e["parent"]) for e in lines} >= {
        ("inner", "span", outer.id), ("phase", "range", events["inner"]["id"])}
    chrome = json.load(open(paths["trace"]))
    pair = [e for e in chrome["traceEvents"] if e["name"] == "phase"]
    assert [e["ph"] for e in pair] == ["b", "e"] and pair[0]["id"] == pair[1]["id"]
    (inner,) = [e for e in chrome["traceEvents"] if e["name"] == "inner"]
    assert (inner["record_id"], inner["parent"]) == (events["inner"]["id"], outer.id)
    for path in (paths["events"], paths["trace"]):
        rep = trace_report_torch.summarize(trace_report_torch.load_events(path))
        assert rep["stages"]["outer"]["self_s"] == pytest.approx(
            events["outer"]["dur"] - events["inner"]["dur"], abs=2e-6)
        assert rep["ranges"]["phase"]["count"] == 1
        assert rep["ranges"]["phase"]["total_s"] == pytest.approx(events["phase"]["dur"],
                                                                  abs=2e-6)


@pytest.mark.parametrize("export", ["events", "trace"])
def test_trace_report_still_reads_the_port_exports(tmp_path, export):
    import trace_report
    import trace_report_torch
    _, events, paths = _nested_run(tmp_path)
    rep = trace_report.summarize(trace_report.load_events(paths[export]))
    ours = trace_report_torch.summarize(trace_report_torch.load_events(paths[export]))
    assert set(rep["stages"]) == set(ours["stages"]) == {"outer", "inner"}
    for name in ("outer", "inner"):
        assert rep["stages"][name]["count"] == 1
        assert rep["stages"][name]["self_s"] == pytest.approx(
            ours["stages"][name]["self_s"], abs=2e-6)
    assert rep["instants"]["mark"]["count"] == 1 and rep["counters"] == ["slots"]
    assert "ranges" not in rep


def test_trace_report_torch_prints_the_ranges(tmp_path, capsys):
    import trace_report_torch
    _nested_run(tmp_path)
    assert trace_report_torch.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "outer" in out and "device range phase: x1" in out
    (tmp_path / "empty").mkdir()
    assert trace_report_torch.main([str(tmp_path / "empty")]) == 1


def test_the_capture_tracer_keeps_the_newest_records():
    for k in range(3):                      # three captures, one process
        prof = _capture()
        try:
            for i in range(4):
                obs_trace.instant("mark", capture=k, i=i)
        finally:
            prof.stop()
        obs_trace.instant("between")        # off: nothing records
    tracer = obs_trace.capture_tracer()
    assert [e["args"]["capture"] for e in tracer.events()] == [0] * 4 + [1] * 4 + [2] * 4
    small = obs_trace.Tracer(max_events=5, keep_newest=True)
    for i in range(8):
        small.instant("mark", i=i)
    assert [e["args"]["i"] for e in small.events()] == [3, 4, 5, 6, 7]
    assert small.dropped == 3 and small.chrome_trace()["otherData"]["dropped"] == 3
    first = obs_trace.Tracer(max_events=5)  # a configured tracer keeps the first
    for i in range(8):
        first.instant("mark", i=i)
    assert [e["args"]["i"] for e in first.events()] == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# the shard writer's waits
# ---------------------------------------------------------------------------

def test_writer_wait_in_a_tiny_produce(tmp_path):
    spec = EnsembleSpec(name="rt", ny=16, nx=8, nsnaps=6, nsteps=30)
    plan = ProductionPlan(scenarios=(ScenarioPlan("rt", spec, num_sims=2, seed=7),),
                          codec=CodecPlan(tolerance=1e-3), shard_size=4)
    prof = _capture()
    try:
        produce(plan, str(tmp_path), device="cpu")
    finally:
        prof.stop()
    events = obs_trace.capture_tracer().events()
    waits = _by_name(events, "datagen.writer_wait")
    assert [e["args"]["op"] for e in waits if e["args"]["op"] == "close"] == ["close"]
    assert all(e["dur"] >= 0 and e["cat"] == "datagen" for e in waits)
    assert not _by_name(events, "datagen.capture")      # the CPU path captures no graph


def test_writer_wait_spans_a_put_on_a_full_queue(tmp_path, monkeypatch):
    started, gate = threading.Event(), threading.Event()
    ingested = []

    def ingest(self, start, cf, ready):
        started.set()
        assert gate.wait(timeout=30)
        ingested.append(start)

    monkeypatch.setattr(ShardWriter, "_ingest", ingest)
    tracer = obs_trace.configure(run="writer")
    writer = ShardWriter(str(tmp_path), 4, 16, [], depth=1)
    chunk = types.SimpleNamespace(payload=torch.zeros(1))
    writer.put(0, chunk)
    assert started.wait(timeout=30)                 # the worker holds chunk 0
    writer.put(4, chunk)                            # fills the queue: no wait
    threading.Timer(0.05, gate.set).start()
    writer.put(8, chunk)                            # waits for the worker
    writer.close()
    assert ingested == [0, 4, 8] and not writer._thread.is_alive()
    waits = _by_name(tracer.events(), "datagen.writer_wait")
    assert [e["args"]["op"] for e in waits] == ["put", "close"]
    assert waits[0]["dur"] > 0.02
