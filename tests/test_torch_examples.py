"""The port's surrogate examples against the JAX examples, on the CPU.

Each JAX example and its port are loaded by file path, as
tests/test_torch_lm_train.py loads the pretrain examples, and run at
reduced arguments: the quickstart as written, train_surrogate at ``--sims
2 --epochs 4 --channels 8 --compressed`` (4 epochs of 3 steps, so one loss
is logged at step 10).  What does not depend on the models' random init
is printed alike: the simulated fields' range, the codec's max errors and
ratios, Algorithm 1's tolerance, ratio and iterations, the compressed
store's ratio.  The losses, from inits drawn by ``torch.Generator`` and by
``jax.random``, are finite and within ``LOSS_FACTOR`` of each other.  A
second run of train_surrogate on its checkpoint directory resumes and
trains nothing, with raw and with lossy (16-bit) checkpoints.  The
compression study runs end to end on a tiny port study, and its exact
resume holds.
"""
import ast
import importlib.util
import io
import json
import os
import pathlib
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from repro_torch import study
from repro_torch.models.surrogate import SurrogateConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SURROGATE_ARGS = ["--sims", "2", "--epochs", "4", "--channels", "8", "--compressed"]
LOSS_FACTOR = 2.0


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, *args, argv=None):
    """Call ``main``, with ``argv`` as ``sys.argv[1:]`` where given; returns
    (its result, what it printed)."""
    out, saved = io.StringIO(), sys.argv
    if argv is not None:
        sys.argv = ["example.py"] + argv
    try:
        with redirect_stdout(out):
            res = main(*args)
    finally:
        sys.argv = saved
    return res, out.getvalue()


def _line(text, start):
    hits = [ln.strip() for ln in text.splitlines() if ln.strip().startswith(start)]
    assert len(hits) == 1, (start, text)
    return hits[0]


def test_quickstart_prints_what_the_jax_example_prints():
    res, text = _run(_load("quickstart_torch").main, ["--device", "cpu"])
    _, jtext = _run(_load("quickstart").main)
    for start in ("fields:", "tol=0.1:", "tol=0.01:", "tolerance=", "store ratio"):
        got, want = _line(text, start), _line(jtext, start)
        if start == "store ratio":      # the decode throughput is a host reading
            got, want = got.split(",")[0], want.split(",")[0]
        assert got == want, start
    assert res["device"] == "cpu"
    assert [c["tolerance"] for c in res["compression"]] == [1e-1, 1e-2]
    assert all(c["bound_holds"] and c["max_err"] <= c["tolerance"]
               for c in res["compression"])
    assert res["algorithm1"]["iterations"] <= 2
    # the logged losses: the same steps, finite, of the same magnitude
    jlosses = ast.literal_eval(_line(jtext, "losses:").split(":", 1)[1].strip())
    assert [s for s, _ in res["losses"]] == [s for s, _ in jlosses] == [5, 10, 15, 20]
    for (_, got), (_, want) in zip(res["losses"], jlosses):
        assert np.isfinite(got) and want / LOSS_FACTOR <= got <= want * LOSS_FACTOR
    assert res["losses"][-1][1] < res["losses"][0][1]


@pytest.fixture(scope="module")
def surrogate_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("surrogate")
    example = _load("train_surrogate_torch")
    # the four runs simulate the same ensemble: simulate it once
    simulate, memo = example.generate_ensemble, {}

    def generate_once(*a, **kw):
        key = repr((a, kw))
        if key not in memo:
            memo[key] = simulate(*a, **kw)
        return memo[key]

    example.generate_ensemble = generate_once
    runs = {}
    for name, extra in (("raw_ckpt", []), ("lossy_ckpt", ["--lossy-ckpt-bits", "16"])):
        argv = SURROGATE_ARGS + extra + ["--ckpt-dir", str(root / name), "--device", "cpu"]
        runs[name] = [_run(example.main, argv) for _ in range(2)]
    _, runs["jax"] = _run(_load("train_surrogate").main,
                          argv=SURROGATE_ARGS + ["--ckpt-dir", str(root / "jax")])
    runs["root"] = root
    return runs


def test_train_surrogate_prints_what_the_jax_example_prints(surrogate_runs):
    jtext = surrogate_runs["jax"]
    (res, text), _ = surrogate_runs["raw_ckpt"]
    for start in ("ensemble:", "compressed store:"):
        got, want = _line(text, start), _line(jtext, start)
        if start == "ensemble:":        # the solver's seconds are a host reading
            got, want = got.split(" in ")[0], want.split(" in ")[0]
        assert got == want, start
    assert res["device"] == "cpu" and res["steps"] == list(range(1, 13))
    jloss = [float(x) for x in re.findall(r"loss ([\d.]+) -> ([\d.]+)", jtext)[0]]
    assert [s for s, _ in res["losses"]] == [10]
    got = res["losses"][0][1]
    assert np.isfinite(got) and jloss[1] / LOSS_FACTOR <= got <= jloss[1] * LOSS_FACTOR
    jpsnr = float(re.search(r"PSNR density: ([\d.]+) dB", jtext).group(1))
    jmass = float(re.search(r"mass rel err: ([\d.]+)", jtext).group(1))
    assert np.isfinite(res["psnr_db"]) and abs(res["psnr_db"] - jpsnr) < 3.0
    assert 0 <= res["mass_rel_err"] < 0.2 and 0 <= jmass < 0.2
    assert f"PSNR density: {res['psnr_db']:.1f} dB" in text


@pytest.mark.parametrize("name", ["raw_ckpt", "lossy_ckpt"])
def test_train_surrogate_resumes_from_its_checkpoint(surrogate_runs, name):
    (first, _), (again, text) = surrogate_runs[name]
    assert again["steps"] == [] and again["losses"] == []
    assert "fully resumed" in text
    latest = ckpt.latest_checkpoint(str(surrogate_runs["root"] / name))
    with open(os.path.join(latest, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 12
    if name == "raw_ckpt":      # the restored parameters are the trained ones
        assert again["psnr_db"] == first["psnr_db"]
        assert again["mass_rel_err"] == first["mass_rel_err"]
    else:                       # restored from 16-bit fixed-rate leaves
        assert manifest["lossy_bits"] == 16
        assert again["psnr_db"] == pytest.approx(first["psnr_db"], abs=0.05)


def test_compression_study_runs_on_a_tiny_port_study(tmp_path, monkeypatch):
    monkeypatch.setattr(study, "RT_MINI", study.dataclasses.replace(
        study.RT_MINI, ny=32, nx=16, nsteps=40, nsnaps=21))
    for k, v in dict(N_SIMS=4, N_TEST_SIMS=2, N_SEEDS=3,
                     LOSSY_MULTIPLES=(0.5, 1.0, 16.0)).items():
        monkeypatch.setattr(study, k, v)
    monkeypatch.setattr(study, "MODEL_CFG", SurrogateConfig(height=32, width=16,
                                                            base_channels=8))
    monkeypatch.setattr(study, "TRAIN_CFG", TrainConfig(epochs=2, batch_size=8, lr=1e-3))
    monkeypatch.setattr(study, "_STUDY", None)
    was = torch.are_deterministic_algorithms_enabled()
    res, text = _run(_load("compression_study_torch").main,
                     ["--device", "cpu", "--data-dir", str(tmp_path)])
    assert torch.are_deterministic_algorithms_enabled() == was
    assert "bit-identical params = True" in text and res["exact_resume"] is True
    assert res["device"] == "cpu"
    assert os.path.exists(tmp_path / "study.npz") and os.path.exists(tmp_path / "study.json")
    assert [v["multiple"] for v in res["verdicts"]] == [0.5, 1.0, 16.0]
    assert len(res["raw_psnr"]) == 3 and np.isfinite(res["lossy_psnr"]).all()
    assert res["batch_tolerances"].shape == (32,) and res["resident_same"] is True
    assert [c["multiple"] for c in res["candidates"]] == [0.5, 2.0, 16.0]
    assert res["produce"]["finalized"] and res["produce"]["shards"][0] == 2
    assert set(res["seconds"]) == {"study", "band_psnr", "sharded_store",
                                   "exact_resume", "device_resident", "certify",
                                   "produce"}
    monkeypatch.setattr(study, "_STUDY", None)


def test_get_codec_takes_the_jax_backends_and_ignores_them():
    """The quickstart asks for ``backend="jnp"`` as the JAX example does:
    the port accepts the JAX package's backend names and selects nothing
    with them (the tensors' device picks the route)."""
    from repro_torch.compression import BACKENDS, get_codec
    for backend in BACKENDS:
        assert get_codec("fixed_accuracy", backend=backend) == get_codec("fixed_accuracy")
        assert get_codec("fixed_rate", bits_per_value=12, backend=backend) == \
            get_codec("fixed_rate", bits_per_value=12)
    with pytest.raises(ValueError, match="backend"):
        get_codec("fixed_accuracy", backend="cuda")
