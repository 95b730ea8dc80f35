"""The metrics that read the program's own records: each gives a positive
value in a traced tiny run of every cell that lists it, from records whose
host stamps fall in the device stretch; the CPU path captures no graph, so
``graph_capture_ms_per_member`` reads nothing there."""
import json

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, run_tiny

ROOT = harness.ROOT
READERS = ("forward_ms_per_step", "backward_ms_per_step", "optimizer_ms_per_step",
           "optimizer_ms_per_step.ensemble", "dispatch_ms_per_step.ensemble",
           "graph_capture_ms_per_member", "writer_wait_share")
ON_THE_CARD_ONLY = {"graph_capture_ms_per_member"}


def listed(cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in READERS and cell in m["workloads"]}


def test_every_reader_is_listed_with_a_program_source():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_counter" and entries[name]["workloads"]
    assert set().union(*(listed(c) for c in CELLS)) == set(READERS)


@pytest.mark.parametrize("cell", CELLS)
def test_program_records_read_in_a_traced_tiny_run(cell):
    result = run_tiny(cell, trace=True)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in listed(cell):
        if name in ON_THE_CARD_ONLY:
            assert name not in metrics
        else:
            assert metrics[name]["value"] > 0, name
    assert not set(READERS) - listed(cell) & set(metrics)
