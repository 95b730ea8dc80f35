"""Each cell at a tiny size on the CPU, through the plain paths: a run
ends, holds its window, reports its metrics and proves correct."""
import json

import pytest

from portbench.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_and_is_correct(cell, trace):
    result = run_tiny(cell, trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    if not trace:
        metrics = result["metrics"]
        assert metrics["setup_s"]["value"] > 0
        rate = {"pchip-datagen": "datagen_samples_per_s",
                "rt-ensemble5": "ensemble_samples_per_s"}.get(cell, "train_samples_per_s")
        assert metrics[rate]["value"] > 0
    else:
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


def test_same_seed_same_first_steps():
    a, b = run_tiny("pchip-resident"), run_tiny("pchip-resident")
    assert a["checks"] == b["checks"]
