"""The cells ``granite-h-small-train-8k`` (granite-4.0-h-small at one
chip's share of an expert-parallel deployment) and ``rt-paper-datagen``
(RT production at 768x256): their manifest entries, the configuration
against the program's registry, the benchmark's plain reference against
the tests' one, and tiny runs on the CPU, traced and untraced, whose
comparison passes the program and fails the control and every fault."""
import copy
import importlib.util
import json
import time

import pytest
import torch

from portbench import check, harness, lm_counts
from portbench.calibrate import readings
from portbench.reference import granite as ref_model
from portbench.tests.tiny import SEED, tiny_cell

ROOT = harness.ROOT
LM, DATAGEN = "granite-h-small-train-8k", "rt-paper-datagen"
# the configuration's shapes kept, its widths cut, for the CPU
TINY_LM = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=32, shared_intermediate_size=48, vocab_size=512,
               router_experts=8, num_local_experts=3, expert_offset=2, num_experts_per_tok=3,
               mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16, attention_multiplier=0.25,
               param_dtype="float32")


def tiny_lm() -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(LM))
    cell.config.update(TINY_LM)
    cell.traffic.update(batch=2, seq=64, warmup_steps=1, trace_steps=2)
    return cell


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_entries():
    m = _manifest()
    conf = next(c for c in m["configs"] if c["name"] == "granite-4.0-h-small-ep8")
    assert conf["reduced"] == ["num_hidden_layers", "num_local_experts"]
    cells = {w["name"]: w for w in m["workloads"]}
    assert (cells[LM]["config"], cells[LM]["traffic"], cells[LM]["chips"]) == \
        ("granite-4.0-h-small-ep8", "lm-train-8k", 1)
    assert (cells[DATAGEN]["config"], cells[DATAGEN]["traffic"], cells[DATAGEN]["chips"]) == \
        ("rt-paper-dcgan", "datagen-rt-paper", 1)
    e2e = lambda name: {x["name"] for x in harness.load_cell(name).end_to_end}  # noqa: E731
    layer = lambda name: {x["name"] for x in harness.load_cell(name).per_layer}  # noqa: E731
    assert e2e(LM) == {"train_samples_per_s", "setup_s"}
    assert layer(LM) == {"step_mfu.lm", "mamba_ms_per_step", "moe_ms_per_step",
                         "optimizer_ms_per_step.lm", "moe_load_max_over_mean",
                         "forward_ms_per_step.lm", "backward_ms_per_step.lm",
                         "device_idle_share.train", "peak_device_gb"}
    assert e2e(DATAGEN) == {"datagen_samples_per_s", "setup_s"}
    # solver_us_per_rk3_step sums the whole production, set-up's and the
    # window's, and moves setup_s: not this cell's
    assert layer(DATAGEN) == {"zfp_fa_encode_roofline", "device_idle_share.datagen",
                              "graph_capture_ms_per_member", "writer_wait_share"}
    assert harness.load_cell(DATAGEN).limits == harness.load_cell("pchip-datagen").limits


def test_the_configuration_is_the_registry_at_its_cut():
    from portbench.runners.lm_train import arch_config
    from repro_torch.configs import get_config
    cfg = harness.load_cell(LM).config
    published = get_config(cfg["arch"])
    assert cfg["published"] == {"num_hidden_layers": published.num_layers,
                                "num_local_experts": published.num_experts} == \
        {"num_hidden_layers": 40, "num_local_experts": 72}
    assert tuple(cfg["layer_types"]) == published.layer_kinds
    arch = arch_config(cfg)
    assert arch == type(published)(**{**vars(published), "num_layers": 10,
                                      "layer_kinds": published.layer_kinds[:10],
                                      "experts_held": 9, "expert_offset": 0})
    assert (cfg["num_hidden_layers"], cfg["num_local_experts"], cfg["router_experts"]) == (10, 9, 72)
    assert arch.layer_kinds.count("attention") == 1
    assert round(lm_counts.forward_flops_per_token(cfg, 8192) / 1e9, 2) == 3.49


def test_the_two_references_agree():
    """The benchmark's reference (sequences one at a time, the chunked SSD,
    checkpointed layers) and the tests' (the whole batch, the step-by-step
    recurrence) on one tiny configuration: loss and every gradient."""
    from portbench.runners.lm_train import arch_config, draw_batch, leaves
    from repro_torch.models import lm
    spec = importlib.util.spec_from_file_location(
        "torch_granite_reference", ROOT / "tests" / "torch_granite_reference.py")
    tests_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests_ref)
    cfg = tiny_lm().config
    arch = arch_config(cfg)
    params = lm.init_lm(7, arch, device="cpu")
    batch = draw_batch(7, 0, 2, 64, cfg["vocab_size"], 1.1)
    model = ref_model.Model(cfg)
    p = {k: v.clone().requires_grad_(True) for k, v in leaves(params, arch).items()}
    n = batch["tokens"].numel()
    counts = [sum(c) for c in zip(*(model.counts(p, row) for row in batch["tokens"]))]
    loss = sum(model.seq_loss(p, row, lab, [c.float() / n for c in counts], n)
               for row, lab in zip(batch["tokens"], batch["labels"]))
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    tcfg = dict(cfg, layer_types=arch.layer_kinds)
    rloss, rgrads = tests_ref.loss_and_grads(tests_ref.per_layer(params, arch.layer_kinds),
                                             batch["tokens"], batch["labels"], tcfg)
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=1e-5)
    assert set(grads) == set(rgrads)
    for k, g in rgrads.items():
        assert float((grads[k] - g).abs().max()) <= 1e-3 * float(g.abs().max()), k


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_lm_cell_runs_and_is_correct(trace):
    result = harness.run_cell(tiny_lm(), SEED, 0.3, trace, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    if trace:
        for name in ("step_mfu.lm", "mamba_ms_per_step", "moe_ms_per_step",
                     "optimizer_ms_per_step.lm", "moe_load_max_over_mean",
                     "forward_ms_per_step.lm", "backward_ms_per_step.lm"):
            assert metrics[name]["value"] > 0, name
        assert metrics["moe_load_max_over_mean"]["value"] >= 1.0
    else:
        assert set(metrics) == {"train_samples_per_s", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_datagen_cell_runs_and_is_correct(trace):
    result = harness.run_cell(tiny_cell(DATAGEN), SEED, 0.3, trace, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    if trace:
        # on the CPU the device readers find nothing: the writer's spans remain
        assert set(result["metrics"]) == {"writer_wait_share"}
    else:
        assert set(result["metrics"]) == {"datagen_samples_per_s", "setup_s"}


@pytest.mark.parametrize("name", [LM, DATAGEN])
def test_control_and_every_fault_fail_a_number(name):
    cell = tiny_lm() if name == LM else tiny_cell(name)
    cell.traffic.update(warmup_steps=0, trace_steps=0)
    harness.set_precision(cell.config)
    r = readings(cell, SEED, "cpu")
    assert check.passed(check.judge(r["program"], cell.limits)), r["program"]
    assert not check.passed(check.judge(r["control"], cell.limits)), r["control"]
    if name == LM:
        assert set(r["faults"]) == set(ref_model.FAULTS)
    for fault, numbers in r["faults"].items():
        assert not check.passed(check.judge(numbers, cell.limits)), (fault, numbers)


def test_the_parent_program_fails_at_the_lookup(monkeypatch):
    """A program without the architecture fails as set-up starts, before
    any weight is drawn."""
    from portbench.runners import lm_train
    from repro_torch.configs import registry
    monkeypatch.delitem(registry._REGISTRY, "granite-4.0-h-small")
    with pytest.raises(KeyError):
        lm_train.arch_config(harness.load_cell(LM).config)
