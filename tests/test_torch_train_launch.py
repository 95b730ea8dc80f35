"""The port's LM training launcher against the JAX package's.

``repro_torch.launch.train.main`` runs on the CPU here (``--device cpu``):
steps, checkpoints every 5 steps, resume.  Its checkpoints are the JAX
package's format: one the port writes restores in
``repro.train.checkpoint.restore_checkpoint`` with the JAX launcher's
templates, and one the JAX launcher's state writes resumes the port's
launcher.  Restores keep the saved dtypes, so Adam's moments, f32 after the
first update, stay f32 though ``adam_init``'s template is bf16 for bf16
parameters.
"""
import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.train import checkpoint as jax_ckpt
from repro.train.optimizer import AdamConfig as JaxAdamConfig
from repro.train.optimizer import adam_init as jax_adam_init
from repro.train.optimizer import adam_update as jax_adam_update

from repro_torch.compression import tree_flatten_with_path
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ARCH = "internlm2-1.8b"
LR = 3e-4
ARGS = ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--seq", "32"]


def _leaves(tree):
    return dict(tree_flatten_with_path(tree)[0])


def _jax_leaves(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        losses = launch.main(argv)
    return losses, out.getvalue()


def _jax_state(cfg_over=None):
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(ARCH), **(cfg_over or {}))
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    opt_cfg = JaxAdamConfig(lr=LR, grad_clip=1.0)
    return jlm, jcfg, params, opt_cfg, jax_adam_init(params, opt_cfg)


def _jax_step(jlm, jcfg, opt_cfg):
    @jax.jit
    def step(params, opt, batch):        # the JAX launcher's step (train.py:77)
        loss, grads = jax.value_and_grad(jlm.lm_loss)(params, jcfg, batch)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        params, opt = jax_adam_update(grads, opt, params, opt_cfg)
        return params, opt, loss
    return step


def test_main_runs_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    losses, out = _run(ARGS + ["--steps", "6", "--ckpt-dir", ck])
    assert len(losses) == 6 and np.isfinite(losses).all() and "resumed" not in out
    assert os.path.basename(ckpt.latest_checkpoint(ck)) == "step_0000000005"
    losses, out = _run(ARGS + ["--steps", "3", "--ckpt-dir", ck])
    assert "resumed from step 5" in out and len(losses) == 3
    assert "step    5 loss" in out and "step    7 loss" in out
    assert os.path.basename(ckpt.latest_checkpoint(ck)) == "step_0000000005"
    # the first resumed step starts from the saved state, on default_rng(5)'s tokens
    cfg = reduced_config(ARCH)
    template = {"params": lm.init_lm(0, cfg, device="cpu"),
                "opt": launch.adam_init_tree(lm.init_lm(0, cfg, device="cpu"))}
    state, meta = ckpt.restore_checkpoint(ckpt.latest_checkpoint(ck), template, device="cpu")
    batch = launch.make_batch(np.random.default_rng(5), cfg, 2, 32, "cpu")
    _, _, loss = launch.train_step(state["params"], state["opt"], batch, cfg,
                                   AdamConfig(lr=LR, grad_clip=1.0))
    assert float(loss) == pytest.approx(losses[0], abs=5e-5)


def test_main_without_steps_past_a_checkpoint_saves_none(tmp_path):
    losses, _ = _run(ARGS + ["--steps", "3", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 3 and ckpt.latest_checkpoint(str(tmp_path / "ck")) is None


def test_dry_run_runs_the_ports_dry_run(monkeypatch):
    """``--dry-run`` runs the port's dry run of the ``--shape`` cell in a
    fresh process (the mesh from ``--multi-pod``) and exits with its code,
    as the JAX launcher does."""
    import subprocess
    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 3)
    with pytest.raises(SystemExit) as exit_:
        launch.main(["--arch", ARCH, "--dry-run", "--shape", "prefill_32k", "--multi-pod"])
    assert exit_.value.code == 3
    assert calls[0][1:] == ["-m", "repro_torch.launch.dryrun", "--arch", ARCH,
                            "--cell", "prefill_32k", "--mesh", "multi"]


def test_port_checkpoint_restores_in_jax(tmp_path):
    ck = str(tmp_path / "ck")
    _run(ARGS + ["--steps", "5", "--ckpt-dir", ck])
    path = ckpt.latest_checkpoint(ck)
    _, _, jparams, _, jopt = _jax_state()
    state, meta = jax_ckpt.restore_checkpoint(path, {"params": jparams, "opt": jopt})
    assert meta["step"] == 5 and int(state["opt"].step) == 5
    cfg = reduced_config(ARCH)
    params = lm.init_lm(0, cfg, device="cpu")
    mine, _ = ckpt.restore_checkpoint(path, {"params": params,
                                             "opt": launch.adam_init_tree(params)},
                                      device="cpu")
    for name in ("params", "opt"):
        got, want = _leaves(mine[name]), _jax_leaves(state[name])
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == torch.float32 or k == ".step", k
            assert np.array_equal(got[k].numpy(), np.asarray(v)), k


def test_jax_checkpoint_resumes_the_port_launcher(tmp_path):
    """The JAX launcher's state after 5 steps, saved by the JAX package,
    resumes the port's launcher at step 5, whose first loss is the JAX
    step's on the same state and tokens."""
    jlm, jcfg, jparams, opt_cfg, jopt = _jax_state()
    step = _jax_step(jlm, jcfg, opt_cfg)
    rng = np.random.default_rng(0)
    for _ in range(5):
        toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 32)), jnp.int32)
        jparams, jopt, _ = step(jparams, jopt, {"tokens": toks,
                                                "labels": jnp.roll(toks, -1, 1)})
    ck = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(ck, 5, {"params": jparams, "opt": jopt})
    rng = np.random.default_rng(5)
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 32)), jnp.int32)
    _, _, jloss = step(jparams, jopt, {"tokens": toks, "labels": jnp.roll(toks, -1, 1)})
    losses, out = _run(ARGS + ["--steps", "1", "--ckpt-dir", ck])
    assert "resumed from step 5" in out
    assert losses[0] == pytest.approx(float(jloss), rel=1e-5)


def test_restored_moments_keep_the_saved_f32_dtype(tmp_path):
    """bf16 parameters: adam_init's moments are bf16, the first update makes
    them f32, and a restore into the bf16 template keeps f32 -- in the port
    and in the JAX package.  Raw bf16 parameters round-trip bit for bit in
    the port."""
    cfg = dataclasses.replace(reduced_config(ARCH), param_dtype="bfloat16")
    params = lm.init_lm(0, cfg, device="cpu")
    opt = launch.adam_init_tree(params)
    batch = launch.make_batch(np.random.default_rng(0), cfg, 2, 32, "cpu")
    params, opt, _ = launch.train_step(params, opt, batch, cfg,
                                       AdamConfig(lr=LR, grad_clip=1.0))
    path = ckpt.save_checkpoint(str(tmp_path), 1, {"params": params, "opt": opt},
                                device="cpu")
    template = {"params": lm.init_lm(1, cfg, device="cpu")}
    template["opt"] = launch.adam_init_tree(template["params"])
    state, _ = ckpt.restore_checkpoint(path, template, device="cpu")
    for k, v in _leaves(state["opt"].m).items():
        assert v.dtype == torch.float32 and torch.equal(v, _leaves(opt.m)[k]), k
    for k, v in _leaves(state["params"]).items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, _leaves(params)[k]), k
    _, _, _, _, jopt = _jax_state({"param_dtype": "bfloat16"})
    assert {str(v.dtype) for v in _jax_leaves(jopt.m).values()} == {"bfloat16"}
    opt_only = ckpt.save_checkpoint(str(tmp_path / "opt"), 1, {"opt": opt}, device="cpu")
    jstate, _ = jax_ckpt.restore_checkpoint(opt_only, {"opt": jopt})
    for k, v in _jax_leaves(jstate["opt"].v).items():
        assert str(v.dtype) == "float32" and np.array_equal(
            np.asarray(v), _leaves(opt.v)[k].numpy()), k
