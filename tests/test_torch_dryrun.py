"""The port's dry run and its collective accounting against the JAX package's.

``input_specs`` and ``analytic_memory_traffic`` equal the reference's for
every arch and applicable cell, at 256 and 512 devices.  ``CommAnalysis``
gives the known per-device bytes of each of the five collectives and the
per-device FLOPs of a sharded product (the device's shard, not the global
product), and counts a Python loop of L layers L times.  ``run_cell`` runs
train, prefill and decode of a reduced config of every family on (2, 2)
and (2, 2, 2) fake meshes and gives the reference's JSON keys with finite
terms; in a bf16 config the tensor-parallel reductions move bf16.
"""
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import SHAPE_CELLS as JAX_CELLS
from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_config as jax_get_config

from repro_torch.configs import ALL_ARCHS, SHAPE_CELLS, ShapeCell, get_config, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.comm_analysis import CommAnalysis
from repro_torch.launch.mesh import axis_links, init_fake_process_group

from torch_lm_reference import load as load_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_REPS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-130m", "hymba-1.5b",
               "internvl2-2b", "seamless-m4t-large-v2")
SMALL_CELLS = (ShapeCell("train_s", 64, 4, "train"), ShapeCell("prefill_s", 64, 4, "prefill"),
               ShapeCell("decode_s", 64, 4, "decode"))
# the reference's record (dryrun.py:348-385) and the port's renames
JAX_KEYS = ("arch", "cell", "mesh", "multi_pod", "n_chips", "pod_grad_compress_bits",
            "compile_seconds", "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "collective_bytes_uncorrected", "collectives",
            "xla_cost_analysis", "memory_analysis", "terms", "bottleneck", "model_flops",
            "params", "active_params", "useful_flops_ratio")
RENAMED = {"compile_seconds": "trace_seconds"}
NO_COUNTERPART = ("xla_cost_analysis",)


def test_the_cells_agree():
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in JAX_CELLS]


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_input_specs_as_the_reference(name):
    jdry = load_reference().dryrun
    jcfg, cfg = jax_get_config(name), get_config(name)
    for jcell, cell in zip(JAX_CELLS, SHAPE_CELLS):
        assert jax_cell_applicable(jcfg, jcell) == \
            dryrun.cell_applicable(cfg, cell)
        if not dryrun.cell_applicable(cfg, cell)[0]:
            continue
        want = jdry.input_specs(jcfg, jcell)
        got = dryrun.input_specs(cfg, cell)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (cell.name, k)
            assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), (cell.name, k)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_analytic_memory_traffic_as_the_reference(name):
    """Exactly the reference's float, every applicable cell, 256 and 512."""
    jdry = load_reference().dryrun
    jcfg, cfg = jax_get_config(name), get_config(name)
    for jcell, cell in zip(JAX_CELLS, SHAPE_CELLS):
        if not dryrun.cell_applicable(cfg, cell)[0]:
            continue
        for n in (256, 512):
            got = dryrun.analytic_memory_traffic(cfg, cell, n)
            assert got == jdry.analytic_memory_traffic(jcfg, jcell, n) and got > 0


@pytest.fixture
def mesh22():
    init_fake_process_group(4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _dt(mesh, local, pl):
    return DTensor.from_local(local, mesh, pl, run_check=False)


def test_the_five_collectives_count_their_operand_bytes(mesh22):
    """Per device: the local operand, in the dtype sent, under the axis it
    crosses.  The shard-to-shard redistribute is one all-to-all (the CPU
    mesh runs it as an all-gather), the permute one collective-permute."""
    loc = torch.empty(4, 8, dtype=torch.bfloat16, device="meta")
    nb = 4 * 8 * 2
    a = CommAnalysis(mesh22)
    with a:
        _dt(mesh22, loc, [Partial(), Replicate()]).redistribute(mesh22, [Replicate()] * 2)
        _dt(mesh22, loc, [Replicate(), Shard(0)]).redistribute(mesh22, [Replicate()] * 2)
        _dt(mesh22, loc, [Replicate(), Partial()]).redistribute(mesh22,
                                                                 [Replicate(), Shard(0)])
        _dt(mesh22, loc, [Replicate(), Shard(0)]).redistribute(mesh22,
                                                                [Replicate(), Shard(1)])
        funcol.permute_tensor(loc.reshape(-1), [1, 0], mesh22.get_group("data"))
    assert a.collectives == {"all-reduce": nb, "all-gather": nb, "reduce-scatter": nb,
                             "all-to-all": nb, "collective-permute": nb}
    assert a.by_axis["data"]["all-reduce"] == nb and a.by_axis["data"]["collective-permute"] == nb
    assert a.by_axis["model"]["all-gather"] == nb and a.by_axis["model"]["all-to-all"] == nb
    assert a.by_dtype == {"bfloat16": 5 * nb}
    assert [r[0] for r in a.records] == ["all-reduce", "all-gather", "reduce-scatter",
                                         "all-to-all", "collective-permute"]


def test_flops_are_the_devices_shard_not_the_global_product():
    """(32, 4096) @ (4096, 8192) on the (16, 16) mesh, rows over "data" and
    columns over "model": 2 * 2 * 4096 * 512 on each device (a counter above
    DTensor reads the global 2 * 32 * 4096 * 8192)."""
    init_fake_process_group(256)
    try:
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        x = _dt(mesh, torch.empty(2, 4096, device="meta"), [Shard(0), Replicate()])
        w = _dt(mesh, torch.empty(4096, 512, device="meta"), [Replicate(), Shard(1)])
        a = CommAnalysis(mesh)
        with a:
            y = x @ w
        assert tuple(y.to_local().shape) == (2, 512)
        assert a.flops == 2 * 2 * 4096 * 512
        assert a.dot_bytes == (2 * 4096 + 4096 * 512 + 2 * 512) * 4
        assert a.collective_bytes == 0
    finally:
        dist.destroy_process_group()


def test_a_python_loop_of_layers_counts_each_layer(mesh22):
    """Eager tracing runs every layer: L products and L all-reduces, no
    trip count to rescale (hlo_analysis.py:149-170)."""
    layers = 5
    x = _dt(mesh22, torch.empty(8, 64, device="meta"), [Shard(0), Replicate()])
    w1 = _dt(mesh22, torch.empty(64, 32, device="meta"), [Replicate(), Shard(1)])
    w2 = _dt(mesh22, torch.empty(32, 64, device="meta"), [Replicate(), Shard(0)])
    a = CommAnalysis(mesh22)
    with a:
        for _ in range(layers):
            x = (x @ w1 @ w2).redistribute(mesh22, [Shard(0), Replicate()])
    assert a.flops == layers * (2 * 8 * 64 * 32 + 2 * 8 * 32 * 64)
    assert a.collectives["all-reduce"] == layers * 8 * 64 * 4


def test_axis_links_of_the_production_meshes():
    """A 16-wide "model" axis spans two 8-GPU nodes; a (1, 8) mesh stays
    on NVLink."""
    assert axis_links((16, 16), ("data", "model")) == {"model": "internode",
                                                       "data": "internode"}
    assert axis_links((1, 8), ("data", "model")) == {"model": "nvlink", "data": "nvlink"}
    assert axis_links((2, 4), ("data", "model")) == {"model": "nvlink", "data": "nvlink"}


def _mesh(shape):
    init_fake_process_group(math.prod(shape))
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def check_run_cell(name, shape, tmp_path, monkeypatch):
    """Train, prefill and decode of the reduced config on a fake mesh: the
    reference's keys (compile_seconds renamed, xla_cost_analysis without a
    counterpart), finite terms, collectives on the mesh's axes."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    assert all(k in src for k in JAX_KEYS)
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    cfg = reduced_config(name)
    mesh = _mesh(shape)
    try:
        for cell in SMALL_CELLS:
            rec = dryrun.run_cell(name, cell, len(shape) == 3, cfg_override=cfg, mesh=mesh)
            want = {RENAMED.get(k, k) for k in JAX_KEYS if k not in NO_COUNTERPART}
            assert want <= set(rec), want - set(rec)
            assert set(rec["terms"]) == {"compute_s", "memory_s", "collective_s"}
            assert all(np.isfinite(v) and v >= 0 for v in rec["terms"].values())
            assert rec["flops_per_device"] > 0 and rec["collective_bytes_per_device"] > 0
            assert rec["n_chips"] == math.prod(shape)
            assert set(rec["collectives_by_axis"]) <= set(mesh.mesh_dim_names)
            assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
            assert (tmp_path / f"{name}_{cell.name}_{rec['mesh']}.json").exists()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", FAMILY_REPS)
def test_run_cell_gives_the_reference_record(name, tmp_path, monkeypatch):
    """Every family on the (2, 2) mesh (the (2, 2, 2) mesh:
    ``tests/test_torch_dryrun_pods.py``)."""
    check_run_cell(name, (2, 2), tmp_path, monkeypatch)


def test_row_parallel_reductions_move_bf16(monkeypatch, tmp_path):
    """The _reduce_barrier pin: in a bf16 config every activation-sized
    all-reduce over "model" carries bf16, forward and backward."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    cfg = dataclasses.replace(reduced_config("internlm2-1.8b"), param_dtype="bfloat16")
    mesh = _mesh((2, 2))
    seen = []
    real = dryrun.traced

    def spy(step, args, m):
        out, analysis, peak = real(step, args, m)
        seen.append(analysis)
        return out, analysis, peak

    monkeypatch.setattr(dryrun, "traced", spy)
    try:
        dryrun.run_cell("internlm2-1.8b", SMALL_CELLS[0], False, cfg_override=cfg,
                        mesh=mesh, save=False)
    finally:
        dist.destroy_process_group()
    act = 2 * 64 * cfg.d_model                  # one device's (B, S, D) activations
    big = [r for r in seen[0].records
           if r[0] == "all-reduce" and r[1] == "model" and r[3] >= act * 2]
    assert big and all(r[2] == torch.bfloat16 for r in big), big


def test_a_reduction_over_two_axes_is_two_all_reduces(mesh22):
    """ROADMAP Queue 3, D1: a (Partial, Partial) -> (Replicate, Replicate)
    redistribute over ("data", "model") runs one all-reduce per mesh dim,
    where GSPMD runs one over both; the accounting shows both."""
    loc = torch.empty(8, 16, device="meta")
    a = CommAnalysis(mesh22)
    with a:
        _dt(mesh22, loc, [Partial(), Partial()]).redistribute(mesh22, [Replicate()] * 2)
    assert [(r[0], r[1]) for r in a.records] == [("all-reduce", "data"),
                                                ("all-reduce", "model")] or \
        [(r[0], r[1]) for r in a.records] == [("all-reduce", "model"),
                                             ("all-reduce", "data")]
    assert a.collectives["all-reduce"] == 2 * 8 * 16 * 4


def test_microbatches_accumulate_the_full_batch_gradient():
    """``make_train_step(cfg, microbatches=2)`` averages the two halves'
    f32 gradients: on equal halves that is the full batch's step (loss to
    1e-5; parameters within 2 lr, Adam's step where a near-zero gradient's
    sign rounds the other way)."""
    from repro_torch.launch.train import adam_init_tree, make_batch
    from repro_torch.models import lm
    cfg = reduced_config("internlm2-1.8b")
    params = lm.init_lm(0, cfg, device="cpu")
    batch = make_batch(np.random.default_rng(3), cfg, 4, 32, "cpu")
    one = dryrun.make_train_step(cfg)(params, adam_init_tree(params), batch)
    two = dryrun.make_train_step(cfg, microbatches=2)(params, adam_init_tree(params), batch)
    np.testing.assert_allclose(float(two[2]), float(one[2]), rtol=1e-5)
    for k, v in one[0]["layers"].items():
        np.testing.assert_allclose(two[0]["layers"][k].numpy(), v.numpy(), rtol=0,
                                   atol=2e-4, err_msg=k)
