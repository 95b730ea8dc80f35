"""``graph_replay_share.ensemble``: listed for the ensemble cell with a
program source; it reads the program's ``ensemble.replay`` spans in the
device stretch, and nothing in the CPU's tiny traced run, where the step
runs eagerly and captures no graph."""
import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.tiny import run_tiny

NAME = "graph_replay_share.ensemble"


def test_listed_for_the_ensemble_cell_with_a_program_source():
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert entry["source"] == "program_counter" and entry["workloads"] == ["rt-ensemble5"]
    assert entry["moves"] == "ensemble_samples_per_s" and entry["unit"] == "%"
    assert NAME in {m["name"] for m in harness.load_cell("rt-ensemble5").per_layer}


@pytest.mark.parametrize("replayed, want", [(4, 100.0), (3, 75.0), (0, None)])
def test_reads_the_replay_spans_in_the_device_stretch(replayed, want):
    from repro_torch.obs import trace
    tracer = trace.configure()
    try:
        with tracer.span("ensemble.replay"):     # before the stretch: not counted
            pass
        t_open = time.perf_counter()
        for _ in range(replayed):
            with tracer.span("ensemble.replay"):
                pass
        with tracer.span("ensemble.dispatch"):
            pass
        run = SimpleNamespace(window=SimpleNamespace(t_open=t_open, trace_end_step=4,
                                                     t_trace_end=time.perf_counter()))
        with tracer.span("ensemble.replay"):     # after it: not counted
            pass
        assert harness.load_reader(NAME)(run) == want
    finally:
        trace.shutdown(write=False)


def test_reads_nothing_in_the_cpu_tiny_run():
    result = run_tiny("rt-ensemble5", trace=True)
    assert result["correct"], result["checks"]
    assert "dispatch_ms_per_step.ensemble" in result["metrics"]
    assert NAME not in result["metrics"]
