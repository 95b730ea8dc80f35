"""The port's checkpoints against the JAX package's, on the CPU.

Every case of ``tests/test_checkpoint_codec.py`` on the port (JAX's
backend-parity case becomes a check that the recorded backend is ignored),
the layout conversions (``params_to_jax`` and the Adam-state conversions,
each the exact inverse of the other direction), and checkpoints across the
packages for raw, ``lossy_bits=13``, certified fixed-accuracy and
residual-corrected saves: the ``.npz`` arrays of the same state equal bit
for bit, the manifests equal except ``time`` (and, for ``lossy_bits``, the
recorded backend: JAX's shorthand records ``"jnp"``), and a checkpoint
written by either package restores in the other to the bits that package's
own restore gives.  The residual codec's weights come from two ridge
solves that sum in different orders, so they and its restores are held to
a stated tolerance instead.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compression as jc
from repro.models.surrogate import SurrogateConfig as JaxConfig, init_surrogate as jax_init
from repro.train import checkpoint as jckpt
from repro.train.optimizer import AdamState as JaxAdamState

from repro_torch.compression import get_codec, tree_flatten_with_path
from repro_torch.data import RawArrayStore
from repro_torch.models.surrogate import (SurrogateConfig, adam_state_from_jax,
                                          adam_state_to_jax, params_from_jax,
                                          params_to_jax)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, train_surrogate
from repro_torch.train.optimizer import AdamState

torch.set_num_threads(2)

RESIDUAL_TOL = 1e-3
# the residual codec across packages: restored leaves within this fraction
# of the tolerance of each other, stored weights within WEIGHTS_ATOL
RESIDUAL_REL_TOL = 1e-2
WEIGHTS_ATOL = 1e-4


@pytest.fixture
def state():
    rng = np.random.default_rng(0)
    params = {"dense": {"w": torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32)),
                        "b": torch.from_numpy(rng.normal(size=(96,)).astype(np.float32))}}
    opt = {"m": {"dense": {k: v * 0.01 for k, v in params["dense"].items()}},
           "v": {"dense": {k: v * 1e-4 for k, v in params["dense"].items()}},
           "step": torch.tensor(3, dtype=torch.int32)}
    return {"params": params, "opt": opt}


def _flat(tree) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree_flatten_with_path(tree)[0]}


def _jflat(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            zip(jc.tree_leaf_keys(tree), jax.tree_util.tree_leaves(tree))}


def _max_err(a, b) -> float:
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    return max(float(np.abs(fa[k].astype(np.float32) - fb[k].astype(np.float32)).max())
               for k in fa)


# ---------------------------------------------------------------------------
# test_checkpoint_codec.py's cases on the port
# ---------------------------------------------------------------------------

def test_lossless_still_bit_exact(state, tmp_path):
    p = ckpt.save_checkpoint(str(tmp_path), 1, state)
    out, meta = ckpt.restore_checkpoint(p, state)
    assert _max_err(out, state) == 0.0
    assert "codec" not in meta
    assert meta["stored_bytes"] == meta["raw_bytes"]
    assert out["opt"]["step"].dtype == torch.int32


def test_lossy_bits_shorthand_records_codec_spec(state, tmp_path):
    p = ckpt.save_checkpoint(str(tmp_path), 1, state, lossy_bits=14)
    with open(os.path.join(p, "manifest.json")) as f:
        meta = json.load(f)
    assert meta["codec"]["spec"]["name"] == "fixed_rate"
    assert meta["codec"]["spec"]["params"]["bits_per_value"] == 14
    assert meta["stored_bytes"] < meta["raw_bytes"]
    out, _ = ckpt.restore_checkpoint(p, state)
    assert _max_err(out, state) < 1e-2
    assert torch.equal(out["params"]["dense"]["b"], state["params"]["dense"]["b"])
    assert int(out["opt"]["step"]) == 3


def test_codec_and_lossy_bits_mutually_exclusive(state, tmp_path):
    with pytest.raises(ValueError):
        ckpt.save_checkpoint(str(tmp_path), 1, state, lossy_bits=12,
                             codec=get_codec("fixed_rate", bits_per_value=12))


@pytest.mark.parametrize("recorded", ["jnp", "pallas"])
def test_recorded_backend_is_ignored(state, tmp_path, recorded):
    """JAX's case encodes on one backend and restores on both; the port has
    no backend, so a manifest naming either of JAX's restores to the same
    bits, and a backend JAX does not have is refused."""
    codec = get_codec("fixed_rate", bits_per_value=13)
    p = ckpt.save_checkpoint(str(tmp_path), 1, state, codec=codec)
    ref, _ = ckpt.restore_checkpoint(p, state)
    mpath = os.path.join(p, "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    meta["codec"]["spec"]["backend"] = recorded
    for tm in meta["codec"]["trees"].values():
        tm["codec"]["backend"] = recorded
    with open(mpath, "w") as f:
        json.dump(meta, f)
    out, _ = ckpt.restore_checkpoint(p, state)
    assert _max_err(out, ref) == 0.0
    assert _max_err(ref, state) < 0.02
    meta["codec"]["spec"]["backend"] = "cuda"
    with open(mpath, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="backend"):
        ckpt.restore_checkpoint(p, state)


def test_certified_tolerance_restore_within_bound(state, tmp_path):
    rng = np.random.default_rng(1)
    params2 = {"dense": {k: v + torch.from_numpy(
        (2e-3 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
        for k, v in state["params"]["dense"].items()}}
    tols = ckpt.certify_param_tolerances(state["params"], params2, min_size=1024)
    assert "dense/w" in tols and tols["dense/w"] > 0
    codec = get_codec("fixed_accuracy")
    st = {"params": params2, "opt": state["opt"]}
    p = ckpt.save_checkpoint(str(tmp_path), 2, st, codec=codec,
                             tolerances={"params": tols})
    out, meta = ckpt.restore_checkpoint(p, st)
    err = float((out["params"]["dense"]["w"] - params2["dense"]["w"]).abs().max())
    assert err <= tols["dense/w"]
    assert meta["codec"]["tolerances"]["params"]["dense/w"] == pytest.approx(tols["dense/w"])
    flags = {l["key"]: l["compressed"]
             for l in meta["codec"]["trees"]["params"]["leaves"]}
    assert flags["dense/w"] and not flags["dense/b"]


def test_certify_skips_zero_displacement(state):
    assert ckpt.certify_param_tolerances(state["params"], state["params"],
                                         min_size=1024) == {}


def test_residual_codec_checkpoint(state, tmp_path):
    codec = get_codec("fixed_accuracy+residual", tolerance=1e-3)
    p = ckpt.save_checkpoint(str(tmp_path), 1, state, codec=codec)
    out, meta = ckpt.restore_checkpoint(p, state)
    assert meta["codec"]["spec"]["name"] == "fixed_accuracy+residual"
    err = float((out["params"]["dense"]["w"] - state["params"]["dense"]["w"]).abs().max())
    assert err <= 2e-3 + 1e-6


def test_crashed_tmp_dir_not_resumed_and_not_counted(state, tmp_path):
    d = str(tmp_path)
    for step in (1, 2):
        ckpt.save_checkpoint(d, step, state, keep=2)
    crash = os.path.join(d, "step_0000000003.tmp")
    os.makedirs(crash)
    with open(os.path.join(crash, "manifest.json"), "w") as f:
        json.dump({"step": 3}, f)
    np.savez(os.path.join(crash, "arrays.npz"))
    os.remove(os.path.join(d, "LATEST"))
    latest = ckpt.latest_checkpoint(d)
    assert latest is not None and latest.endswith("step_0000000002")
    ckpt.save_checkpoint(d, 4, state, keep=2)
    kept = sorted(x for x in os.listdir(d)
                  if x.startswith("step_") and not x.endswith(".tmp"))
    assert kept == ["step_0000000002", "step_0000000004"]


def test_interrupted_save_is_replaced_on_retry(state, tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_0000000001.tmp"))
    p = ckpt.save_checkpoint(d, 1, state)
    assert os.path.basename(p) == "step_0000000001"
    out, _ = ckpt.restore_checkpoint(p, state)
    assert _max_err(out, state) == 0.0


def test_train_loop_certified_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    cfg = SurrogateConfig(height=16, width=16, base_channels=8)
    n = 16
    cond = rng.normal(size=(n, cfg.cond_dim)).astype(np.float32)
    fields = rng.normal(size=(n, 16, 16, 6)).astype(np.float32)
    codec = get_codec("fixed_accuracy")                 # no default tol:
    tcfg = TrainConfig(epochs=2, batch_size=8, ckpt_dir=str(tmp_path),
                       ckpt_every_steps=2, log_every=1, prefetch=0,
                       ckpt_codec=codec)                # -> certified mode
    model, losses = train_surrogate(cfg, tcfg, cond, RawArrayStore(fields, device="cpu"),
                                    device="cpu")
    assert [s for s, _ in losses] == [1, 2, 3, 4]
    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest is not None and latest.endswith("step_0000000004")
    with open(os.path.join(latest, "manifest.json")) as f:
        meta = json.load(f)
    assert meta["codec"]["spec"]["name"] == "fixed_accuracy"
    certified = meta["codec"].get("tolerances", {}).get("params", {})
    assert certified
    params = params_to_jax({n: p.detach() for n, p in model.named_parameters()})
    out, _ = ckpt.restore_checkpoint(latest, {"params": params})
    flat, restored = _flat(params), _flat(out["params"])
    for key, tol in certified.items():
        assert float(np.abs(restored[key] - flat[key]).max()) <= tol
    # the conv weights are certified in the JAX layout (HWIO)
    assert "up1_c/w" in certified and restored["up1_c/w"].shape == (3, 3, 32, 32)


# ---------------------------------------------------------------------------
# layout conversions
# ---------------------------------------------------------------------------

JCFG = JaxConfig(height=16, width=16, base_channels=8)


def _jax_state(seed: int = 0):
    """JAX surrogate params, a displaced copy and a JAX AdamState."""
    jp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), JCFG))
    rng = np.random.default_rng(seed + 1)
    jp2 = jax.tree.map(lambda x: (x + 2e-3 * rng.standard_normal(x.shape)
                                  ).astype(np.float32), jp)
    jopt = JaxAdamState(step=np.asarray(3, np.int32),
                        m=jax.tree.map(lambda x: (x * 0.01).astype(np.float32), jp2),
                        v=jax.tree.map(lambda x: (x * x * 1e-4).astype(np.float32), jp2))
    return jp, jp2, jopt


def test_params_and_adam_state_roundtrip_bit_exact():
    jp, _, jopt = _jax_state()
    back = params_to_jax(params_from_jax(jp))
    assert _flat(back).keys() == _jflat(jp).keys()
    for k, v in _jflat(jp).items():
        assert np.array_equal(_flat(back)[k], v), k
    port_opt = adam_state_from_jax(jopt)
    assert isinstance(port_opt, AdamState) and port_opt.step.dtype == torch.int32
    conv = adam_state_to_jax(port_opt)
    assert list(_flat(conv)) == jc.tree_leaf_keys(jopt)
    for k, v in _jflat(jopt).items():
        assert np.array_equal(_flat(conv)[k], v), k
    # and the other way round: state dict -> JAX layout -> state dict
    sd = params_from_jax(jp)
    again = params_from_jax(params_to_jax(sd))
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    opt2 = adam_state_from_jax(adam_state_to_jax(port_opt))
    assert torch.equal(opt2.step, port_opt.step)
    assert all(torch.equal(opt2.m[k], port_opt.m[k]) and torch.equal(opt2.v[k], port_opt.v[k])
               for k in port_opt.m)


def test_certify_param_tolerances_equals_jax():
    """Per-leaf certified tolerances on the surrogate's parameters (JAX
    layout) equal JAX's.  The displacement is a float64 mean summed in a
    different order (numpy's pairwise sum, torch's), so the tolerances are
    held to a relative 1e-12 (they are equal to the bit on these inputs);
    no leaf's accept/reject differs here at the
    ``l1 <= e`` boundary (each certified key is the same set)."""
    jp, jp2, _ = _jax_state()
    want = jckpt.certify_param_tolerances(jp, jp2)
    got = ckpt.certify_param_tolerances(params_to_jax(params_from_jax(jp)),
                                        params_to_jax(params_from_jax(jp2)))
    assert sorted(got) == sorted(want) and len(got) == 8
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

MODES = ["raw", "lossy13", "certified", "residual"]


def _save_kwargs(mode, pkg, jp, jp2):
    if mode == "raw":
        return {}
    if mode == "lossy13":
        return {"lossy_bits": 13}
    if mode == "residual":
        make = get_codec if pkg == "torch" else jc.get_codec
        return {"codec": make("fixed_accuracy+residual", tolerance=RESIDUAL_TOL)}
    if pkg == "torch":
        tols = ckpt.certify_param_tolerances(params_to_jax(params_from_jax(jp)),
                                             params_to_jax(params_from_jax(jp2)))
        return {"codec": get_codec("fixed_accuracy"), "tolerances": {"params": tols}}
    tols = jckpt.certify_param_tolerances(jp, jp2)
    return {"codec": jc.get_codec("fixed_accuracy"), "tolerances": {"params": tols}}


def _states():
    jp, jp2, jopt = _jax_state()
    jstate = {"params": jax.tree.map(jnp.asarray, jp2),
              "opt": jax.tree.map(jnp.asarray, jopt)}
    tstate = {"params": params_to_jax(params_from_jax(jp2)),
              "opt": adam_state_to_jax(adam_state_from_jax(jopt))}
    return jp, jp2, jstate, tstate


def _compare(got: dict, want: dict, mode: str, what: str):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        if mode == "residual":
            err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
            assert err <= RESIDUAL_REL_TOL * RESIDUAL_TOL, (what, k, err)
        else:
            assert np.array_equal(got[k], want[k]), (what, k)


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_across_packages(mode, tmp_path):
    jp, jp2, jstate, tstate = _states()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    extra = {"loader": {"epoch": 1, "step_in_epoch": 2, "seed": 7}}
    jpath = jckpt.save_checkpoint(jdir, 5, jstate, extra=extra,
                                  **_save_kwargs(mode, "jax", jp, jp2))
    tpath = ckpt.save_checkpoint(tdir, 5, tstate, extra=extra,
                                 **_save_kwargs(mode, "torch", jp, jp2))

    # the same files: arrays bit for bit, manifests but for time (and the
    # backend JAX's lossy_bits shorthand records)
    ja, ta = np.load(os.path.join(jpath, "arrays.npz")), np.load(os.path.join(tpath, "arrays.npz"))
    assert sorted(ja.files) == sorted(ta.files)
    if mode != "raw":
        assert any(".zfp/" in k for k in ta.files)
    for k in ja.files:
        if k.endswith(".zfp/weights"):
            np.testing.assert_allclose(ta[k], ja[k], rtol=0, atol=WEIGHTS_ATOL)
        else:
            assert ta[k].dtype == ja[k].dtype and np.array_equal(ta[k], ja[k]), k
    with open(os.path.join(jpath, "manifest.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tmeta = json.load(f)
    jmeta.pop("time"), tmeta.pop("time")
    if mode == "lossy13":
        assert jmeta["codec"]["spec"]["backend"] == "jnp"
        assert tmeta["codec"]["spec"]["backend"] == "pallas"
        for m in (jmeta, tmeta):
            m["codec"]["spec"]["backend"] = "-"
            for tm in m["codec"]["trees"].values():
                tm["codec"]["backend"] = "-"
    assert tmeta == jmeta

    # each package restores the other's checkpoint to its own restore's bits
    for path in (jpath, tpath):
        jout, _ = jckpt.restore_checkpoint(path, jstate)
        tout, tm = ckpt.restore_checkpoint(path, tstate)
        assert tm["extra"] == extra
        _compare(_flat(tout), _jflat(jout), mode, path)
    # and the lossy restores stay within their bounds
    tout, _ = ckpt.restore_checkpoint(jpath, tstate)
    err = _max_err(tout["params"], tstate["params"])
    assert {"raw": err == 0.0, "lossy13": 0 < err < 0.02,
            "certified": 0 < err <= 1e-2,
            "residual": 0 < err <= 2 * RESIDUAL_TOL + 1e-6}[mode], err
