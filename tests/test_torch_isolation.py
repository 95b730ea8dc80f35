"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

An AST scan of every module under ``src/repro_torch/``, of
``chip_smoke.py`` and of the port's examples shows no import of ``jax``,
``repro``, ``benchmarks`` (whose ``common.py`` imports JAX) or ``triton``
at module level; the entry points raise without a GPU unless the caller
asks for the CPU.
"""
import ast
import importlib
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.compression import as_tensor, encode_tree, get_codec
from repro_torch.core.grad_compress import tree_collective_bytes
from repro_torch.data import DeviceResidentCompressedStore, channels_last
from repro_torch.configs import reduced_config
from repro_torch.core import find_tolerance, find_tolerance_batch
from repro_torch.core.ensemble import certify_tolerance, init_ensemble, train_ensemble
from repro_torch.datagen import ProductionPlan, ScenarioPlan, produce, resolve_store
from repro_torch.kernels import flash_attention, zfp_codec
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.models.surrogate import SurrogateConfig, init_surrogate
from repro_torch.serving import ServeEngine, SurrogateServeEngine
from repro_torch.sim import EnsembleSpec, generate_ensemble, run_simulation
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, predict_fields, train_surrogate

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_EXAMPLES = [ROOT / "examples" / f"{name}_torch.py" for name in
                 ("lm_pretrain", "quickstart", "train_surrogate", "compression_study")]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + PORT_EXAMPLES
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node


def test_scan_covers_every_package_of_the_port():
    scanned = {p.parent.name for p in PORT_FILES}
    assert {"compression", "kernels", "data", "train", "models", "sim",
            "obs", "distributed", "configs", "serving", "launch", "core",
            "metrics", "datagen"} <= scanned
    names = {p.name for p in PORT_FILES}
    assert {"metrics.py", "sharding.py", "shards.py", "loader.py", "lm.py", "engine.py",
            "scheduler.py", "loadgen.py", "trace.py", "serve.py",
            "flash_attention.py", "ensemble.py", "tolerance.py", "variability.py",
            "image.py", "physics.py", "solver.py", "plan.py", "produce.py",
            "writer.py", "checkpoint.py", "grad_compress.py", "torchprof.py",
            "surrogate_engine.py", "train.py", "study.py", "lm_pretrain_torch.py",
            "quickstart_torch.py", "train_surrogate_torch.py",
            "compression_study_torch.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    bad = [(name, node.lineno) for name, node in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_toolchain():
    """Every module imports with no nvcc, no triton and no card, and
    importing builds nothing."""
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert {"repro_torch.kernels.zfp_codec", "repro_torch.kernels.flash_attention",
            "repro_torch.launch.serve", "repro_torch.launch.train"} <= set(names)
    for name in names:
        importlib.import_module(name)
    assert not zfp_codec._libs and not flash_attention._libs


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda):
    samples = np.zeros((2, 6, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceResidentCompressedStore.from_samples(samples, [1e-3, 1e-3])
    store = DeviceResidentCompressedStore.from_samples(samples, [1e-3, 1e-3],
                                                       device="cpu")
    cfg = SurrogateConfig(height=16, width=16, base_channels=8)
    cond = np.zeros((2, cfg.cond_dim), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_surrogate(cfg, TrainConfig(batch_size=2, max_steps=1), cond, store)
    model, losses = train_surrogate(cfg, TrainConfig(batch_size=2, max_steps=1,
                                                     log_every=1),
                                    cond, store, target_transform=channels_last,
                                    device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0][1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_fields(model, cond)
    assert predict_fields(model, cond, device="cpu").shape == (2, 16, 16, 6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_fields(init_surrogate(cfg, device="cpu"), cond, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_surrogate(cfg)
    assert next(init_surrogate(cfg, device="cpu").parameters()).device.type == "cpu"


def test_lm_serving_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda):
    cfg = reduced_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 8)
    params = lm.init_lm(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launcher.main(["--requests", "1"])
    engine = ServeEngine(params, cfg, batch_slots=2, max_seq=16, device="cpu")
    assert engine.device.type == "cpu"


def test_surrogate_serving_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda):
    cfg = SurrogateConfig(height=32, width=16, base_channels=8)
    fleet = init_ensemble(cfg, (0, 1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SurrogateServeEngine(fleet, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launcher.main(["--mode", "surrogate", "--requests", "1"])
    engine = SurrogateServeEngine(fleet, cfg, batch_slots=2, device="cpu")
    assert engine.device.type == "cpu" and engine.num_members == 2
    assert len(serve_launcher.main(["--mode", "surrogate", "--requests", "2",
                                    "--device", "cpu"])) == 2


def test_certification_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda):
    samples = np.zeros((2, 6, 16, 16), np.float32)
    cfg = SurrogateConfig(height=16, width=16, base_channels=8)
    cond = np.zeros((2, cfg.cond_dim), np.float32)
    fields = samples.transpose(0, 2, 3, 1)
    for call in (lambda: find_tolerance(samples[0], 0.1),
                 lambda: find_tolerance_batch(samples, [0.1, 0.1]),
                 lambda: init_ensemble(cfg, (0, 1)),
                 lambda: certify_tolerance(cfg, TrainConfig(batch_size=2), cond, fields,
                                           eval_conditions=cond, eval_targets=fields)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    store = DeviceResidentCompressedStore.from_samples(samples, [1e-3, 1e-3],
                                                       device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ensemble(cfg, TrainConfig(batch_size=2, max_steps=1), cond, store, (0, 1),
                       target_transform=channels_last)
    res = train_ensemble(cfg, TrainConfig(batch_size=2, max_steps=1, log_every=1), cond,
                         store, (0, 1), target_transform=channels_last, device="cpu")
    assert res.steps == 1 and res.losses[0][1].shape == (2,)
    assert find_tolerance_batch(samples, [0.1, 0.1], device="cpu").tolerance.shape == (2,)


def test_datagen_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda, tmp_path):
    spec = EnsembleSpec(name="rt", ny=16, nx=8, nsnaps=3, nsteps=4)
    plan = ProductionPlan(scenarios=(ScenarioPlan("rt", spec, num_sims=1),),
                          shard_size=4)
    params = plan.scenarios[0].params()[0]
    for call in (lambda: run_simulation(params, ny=16, nx=8, nsteps=4, nsnaps=3),
                 lambda: generate_ensemble(spec, 1),
                 lambda: produce(plan, str(tmp_path / "card"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "card").exists()
    fields = run_simulation(params, ny=16, nx=8, nsteps=4, nsnaps=3, device="cpu")
    assert fields.device.type == "cpu" and fields.shape == (3, 16, 8, 6)
    assert produce(plan, str(tmp_path / "cpu"), device="cpu").finalized
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_store(str(tmp_path / "cpu"))
    store = resolve_store(str(tmp_path / "cpu"), device="cpu")
    assert store.get_batch(np.arange(2)).device.type == "cpu"


def test_compression_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda, tmp_path):
    """Array leaves and fields read back from arrays go to the card unless
    the caller asks for the CPU; tensors stay where they are."""
    w = np.random.default_rng(0).normal(size=(64, 96)).astype(np.float32)
    fr = get_codec("fixed_rate", bits_per_value=13)
    state = {"params": {"w": w}}
    p = ckpt.save_checkpoint(str(tmp_path), 1, state, lossy_bits=13, device="cpu")
    for call in (lambda: as_tensor(w),
                 lambda: encode_tree(fr, {"w": w}),
                 lambda: tree_collective_bytes({"w": w}, 8),
                 lambda: fr.field_from_arrays(fr.field_to_arrays(
                     fr.encode_batch(torch.from_numpy(w)[None])), w.shape),
                 lambda: ckpt.certify_param_tolerances({"w": w}, {"w": w + 1e-3},
                                                       min_size=1024),
                 lambda: ckpt.save_checkpoint(str(tmp_path / "card"), 1, state,
                                              lossy_bits=13),
                 lambda: ckpt.restore_checkpoint(p, state)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not (tmp_path / "card" / "LATEST").exists()
    assert as_tensor(w, "cpu").device.type == "cpu"
    enc, _ = encode_tree(fr, {"w": w}, device="cpu")
    assert enc[0].payload.device.type == "cpu"
    assert tree_collective_bytes({"w": torch.from_numpy(w)}, 8)[0] == w.nbytes
    assert tree_collective_bytes({"w": w}, None) == (w.nbytes, w.nbytes)
    out, _ = ckpt.restore_checkpoint(p, state, device="cpu")
    assert out["params"]["w"].device.type == "cpu"
    assert float(np.abs(out["params"]["w"].numpy() - w).max()) < 0.02
    out, _ = ckpt.restore_checkpoint(p, {"params": {"w": torch.from_numpy(w)}})
    assert out["params"]["w"].device.type == "cpu"
    assert ckpt.certify_param_tolerances({"w": w}, {"w": w + 1e-3}, min_size=1024,
                                         device="cpu")


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    return example


def test_lm_training_entry_points_need_a_gpu_unless_cpu_is_asked(no_cuda, tmp_path):
    example = _example("lm_pretrain_torch")
    args = ["--arch", "internlm2-1.8b", "--steps", "1"]
    for call in (lambda: train_launcher.main(args),
                 lambda: example.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not any(tmp_path.iterdir())
    assert len(train_launcher.main(args + ["--device", "cpu", "--seq", "16"])) == 1


def test_study_and_surrogate_examples_need_a_gpu_unless_cpu_is_asked(no_cuda, tmp_path):
    from repro_torch import study
    data_dir = str(tmp_path / "study")
    for call in (lambda: study.build_study(force=True, data_dir=data_dir),
                 lambda: study.build_study(data_dir=data_dir),
                 lambda: _example("quickstart_torch").main([]),
                 lambda: _example("train_surrogate_torch").main(
                     ["--ckpt-dir", str(tmp_path / "ck")]),
                 lambda: _example("compression_study_torch").main(
                     ["--data-dir", data_dir])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not any(tmp_path.iterdir())
    res = _example("quickstart_torch").main(["--device", "cpu"])
    assert res["device"] == "cpu" and all(c["bound_holds"] for c in res["compression"])
