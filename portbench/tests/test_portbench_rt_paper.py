"""The cell ``rt-paper-grid-resident`` (the paper's RT surrogate at
768x256): its manifest entries, its configuration against the program's
spec, and a tiny run of it on the CPU, traced and untraced, whose
comparison passes the program and fails the control and each fault."""
import json
import time

import pytest

from portbench import check, harness
from portbench.calibrate import readings
from portbench.tests.test_portbench_control import frozen, half_batch, wrong_sample
from portbench.tests.tiny import SEED, tiny_cell

CELL = "rt-paper-grid-resident"
TRAIN_LAYER = {"launches_per_step", "step_mfu", "device_idle_share.train", "peak_device_gb",
               "forward_ms_per_step", "backward_ms_per_step", "optimizer_ms_per_step"}
# what each cell reported before this cell was added
BEFORE = {
    "pchip-resident": ({"train_samples_per_s", "setup_s"},
                       TRAIN_LAYER | {"zfp_fa_decode_roofline"}),
    "pchip-hoststream": ({"train_samples_per_s", "setup_s"},
                         TRAIN_LAYER | {"fetch_wait_share", "store_read_ms_per_batch",
                                        "zfp_fr_decode_roofline"}),
    "rt-ensemble5": ({"ensemble_samples_per_s", "setup_s"},
                     {"cudnn_transpose_share", "launches_per_step.ensemble",
                      "step_mfu.ensemble", "zfp_fa_decode_roofline.ensemble",
                      "device_idle_share.ensemble", "peak_device_gb.ensemble",
                      "optimizer_ms_per_step.ensemble", "dispatch_ms_per_step.ensemble",
                      "graph_replay_share.ensemble"}),
    "pchip-datagen": ({"datagen_samples_per_s", "setup_s"},
                      {"zfp_fa_encode_roofline", "device_idle_share.datagen",
                       "graph_capture_ms_per_member", "writer_wait_share"}),
}


def _names(cell):
    return ({m["name"] for m in cell.end_to_end}, {m["name"] for m in cell.per_layer})


def test_the_cell_reports_the_training_metrics_and_the_solver_step():
    assert _names(harness.load_cell(CELL)) == (
        {"train_samples_per_s", "setup_s"},
        TRAIN_LAYER | {"zfp_fa_decode_roofline", "solver_us_per_rk3_step"})


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_other_cells_report_what_they_reported(name):
    assert _names(harness.load_cell(name)) == BEFORE[name]


def test_the_configuration_is_the_program_spec_at_the_paper_grid():
    from repro_torch.sim import ensemble
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "rt-paper-dcgan")
    cfg = harness.load_cell(CELL).config
    spec = getattr(ensemble, cfg["spec"])
    assert (cfg["ny"], cfg["nx"]) == (spec.ny, spec.nx) == (768, 256)
    assert cfg["published"] == {"ny": 768, "nx": 256} and entry["reduced"] == ["num_sims"]
    assert (cfg["nsnaps"], cfg["nsteps"], cfg["dt"]) == (spec.nsnaps, spec.nsteps, spec.dt)
    assert set(cfg["assumed"]) == {"dt", "nsteps", "num_sims"}


def test_the_solver_reader_reads_nothing_without_the_counters(monkeypatch):
    from repro_torch.obs import metrics
    monkeypatch.setattr(metrics, "get_registry", lambda: metrics.MetricsRegistry())
    assert harness.load_reader("solver_us_per_rk3_step")(None) is None


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_runs_and_is_correct(trace):
    result = harness.run_cell(tiny_cell(CELL), SEED, 0.3, trace, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    if trace:
        assert metrics["solver_us_per_rk3_step"]["value"] > 0
        for name in ("forward_ms_per_step", "backward_ms_per_step", "optimizer_ms_per_step"):
            assert metrics[name]["value"] > 0
    else:
        assert set(metrics) == {"train_samples_per_s", "setup_s"}
        assert all(m["value"] > 0 for m in metrics.values())


def test_control_fails_and_program_passes():
    c = tiny_cell(CELL)
    c.traffic.update(warmup_steps=0, trace_steps=0)
    harness.set_precision(c.config)
    r = readings(c, SEED, "cpu")
    assert check.passed(check.judge(r["program"], c.limits)), r["program"]
    assert not check.passed(check.judge(r["control"], c.limits)), r["control"]
    for fault, numbers in r["faults"].items():
        assert not check.passed(check.judge(numbers, c.limits)), (fault, numbers)


@pytest.mark.parametrize("fault", [frozen, half_batch, wrong_sample])
def test_fault_in_the_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = harness.run_cell(tiny_cell(CELL), SEED, 0.3, False, "cpu", time.perf_counter())
    assert not result["correct"], result["checks"]
