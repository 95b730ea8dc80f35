"""The port's dense-LM training against the JAX package's.

``lm_forward``, ``lm_loss`` and their gradients, the remat modes, the
launcher's step and the compressed-gradient example's step are held to the
JAX package's on the same parameters (the reference's ``init_lm`` carried
across with ``params_from_jax``) and the same tokens (numpy).  The
reference LM is imported through ``torch_lm_reference`` (ROADMAP Queue 3,
R1); the JAX example is loaded by file path the same way.

Tolerances: f32 losses to 1e-5 relative, f32 forward values to 1e-5 of the
tensor's max magnitude, gradients to 1e-4 of each tensor's max magnitude.
In bf16 the two packages round at other points (XLA fuses elementwise
chains; PyTorch rounds every op), so the forward is held to
``BF16_ULPS`` bf16 ulps of the tensor's largest magnitude (measured: at
most 2) and the loss to ``BF16_LOSS_RTOL`` (measured: at most 5e-4).  Adam turns a gradient near
zero whose sign differs by rounding into a step of about +-lr, so updated
parameters are held by quantiles, as ``tests/test_ensemble.py`` holds its
runs: almost every element tight, none off by more than 2 * lr a step.
"""
import dataclasses
import importlib.util
import io
import os
import pathlib
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.grad_compress import compress_decompress as jax_compress_decompress
from repro.train.optimizer import AdamConfig as JaxAdamConfig
from repro.train.optimizer import adam_init as jax_adam_init
from repro.train.optimizer import adam_update as jax_adam_update

from repro_torch.compression import tree_flatten_with_path, tree_map
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import train as launch
from repro_torch.models import lm
from repro_torch.models.nn import count_params
from repro_torch.train.optimizer import AdamConfig

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSE = ("internlm2-1.8b", "codeqwen1.5-7b", "qwen2.5-14b", "command-r-35b")
DTYPES = ("float32", "bfloat16")
F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ULPS = 4
BF16_LOSS_RTOL = 2e-3
LR = 3e-4
B, S = 2, 40                 # S not a multiple of the loss chunk: a dropped tail
CHUNK = 16                   # attention q-chunk: a padded last chunk at S = 40


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _leaves(tree):
    return dict(tree_flatten_with_path(tree)[0])


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = leaf
    return out


def _pair(name, dtype="float32", seed=0, **over):
    """(reference lm, JAX cfg, JAX params, port cfg, port params)."""
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(name), param_dtype=dtype,
                               attn_chunk=CHUNK, **over)
    cfg = dataclasses.replace(reduced_config(name), param_dtype=dtype,
                              attn_chunk=CHUNK, **over)
    jparams = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:        # the init's zero biases would test nothing
        rng = np.random.default_rng(seed + 100)
        for b in ("bq", "bk", "bv"):
            jparams["layers"][b] = (0.1 * rng.standard_normal(jparams["layers"][b].shape)
                                    ).astype(jparams["layers"][b].dtype)
    return (jlm, jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), cfg,
            lm.params_from_jax(jparams, "cpu"))


def _batch(seed=0, b=B, s=S, vocab=512):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want, rtol, what):
    g, w = _leaves(got), _jax_leaves(want)
    assert set(g) == set(w), (sorted(g), sorted(w))
    for k in w:
        ref = _np(w[k])
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(_np(g[k]), ref, rtol=0, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_lm_forward_matches_jax(name, dtype):
    jlm, jcfg, jparams, cfg, params = _pair(name, dtype)
    batch = _batch(1)
    jh, jaux = jlm.lm_forward(jparams, jcfg, _jb(batch))
    h, aux = lm.lm_forward(params, cfg, _tb(batch))
    assert h.dtype == getattr(torch, dtype) and h.shape == (B, S, cfg.d_model)
    assert aux.dtype == torch.float32 and aux.dim() == 0 and float(aux) == float(jaux) == 0
    want = _np(jh)
    top = np.abs(want).max()
    atol = (F32_RTOL * top if dtype == "float32"
            else BF16_ULPS * 2.0 ** (np.floor(np.log2(top)) - 7))
    np.testing.assert_allclose(_np(h), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_lm_loss_matches_jax(name, dtype):
    """S = 40 with 16-token loss chunks drops the last 8 tokens, and the
    16-query attention chunks pad the last one."""
    jlm, jcfg, jparams, cfg, params = _pair(name, dtype)
    batch = _batch(2)
    for chunk in (16, 512):
        want = float(jlm.lm_loss(jparams, jcfg, _jb(batch), chunk))
        got = lm.lm_loss(params, cfg, _tb(batch), chunk)
        assert got.dtype == torch.float32 and got.dim() == 0
        rtol = F32_RTOL if dtype == "float32" else BF16_LOSS_RTOL
        assert float(got) == pytest.approx(want, rel=rtol), chunk


def test_lm_loss_drops_the_tail_past_the_last_whole_chunk():
    _, _, _, cfg, params = _pair("internlm2-1.8b")
    batch = _batch(3)
    tail = {k: v.copy() for k, v in batch.items()}
    tail["labels"][:, 32:] = (tail["labels"][:, 32:] + 1) % cfg.vocab_size
    assert float(lm.lm_loss(params, cfg, _tb(batch), 16)) == \
        float(lm.lm_loss(params, cfg, _tb(tail), 16))
    assert float(lm.lm_loss(params, cfg, _tb(batch), 40)) != \
        float(lm.lm_loss(params, cfg, _tb(tail), 40))


@pytest.mark.parametrize("name", DENSE)
def test_gradients_match_jax(name):
    jlm, jcfg, jparams, cfg, params = _pair(name)
    batch = _batch(4)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, _jb(batch), 16)
    pairs, treedef = tree_flatten_with_path(params)
    leaves = [p.requires_grad_() for _, p in pairs]
    loss = lm.lm_loss(treedef.unflatten(leaves), cfg, _tb(batch), 16)
    grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=F32_RTOL)
    _assert_tree_close(grads, jgrads, GRAD_RTOL, "grad")
    assert all(float(g.abs().max()) > 0 for g in _leaves(grads).values())


def test_bf16_gradients_are_bf16_and_finite():
    _, _, _, cfg, params = _pair("internlm2-1.8b", "bfloat16")
    _, grads = launch.loss_and_grads(params, cfg, _tb(_batch(5)))
    for k, g in _leaves(grads).items():
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()), k


def test_remat_modes_give_equal_losses_and_gradients():
    results = []
    for remat in ("full", "dots", "none"):
        _, _, _, cfg, params = _pair("qwen2.5-14b", remat=remat)
        results.append(launch.loss_and_grads(params, cfg, _tb(_batch(6))))
    (l0, g0), rest = results[0], results[1:]
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        for k, g in _leaves(grads).items():
            assert torch.equal(g, _leaves(g0)[k]), k
    _, _, _, cfg, _ = _pair("qwen2.5-14b", remat="sometimes")
    with pytest.raises(ValueError, match="remat"):
        lm.lm_forward(params, cfg, _tb(_batch(6)))


def test_dots_remat_saves_the_projection_matmuls(monkeypatch):
    """Under "dots" the policy keeps the outputs of the matmuls without batch
    dims -- the 7 projections of every layer -- and recomputes the rest,
    attention's batched matmuls included."""
    decisions = []

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        decisions.append((op, decision))
        return decision

    policy = lm._save_dots
    monkeypatch.setattr(lm, "_save_dots", spy)
    _, _, _, cfg, params = _pair("internlm2-1.8b", remat="dots")
    launch.loss_and_grads(params, cfg, _tb(_batch(7)))
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * cfg.num_layers)
    assert any(op == torch.ops.aten.bmm.default for op, _ in decisions)


def test_training_never_reaches_the_serving_kernel(monkeypatch):
    """The training forward and its backward attend through the plain
    ``attention_train``: the kernel wrapper is never called."""
    def refuse(*a, **kw):
        raise AssertionError("ops.flash_attention reached from training")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    _, _, _, cfg, params = _pair("internlm2-1.8b")
    loss, grads = launch.loss_and_grads(params, cfg, _tb(_batch(8)))
    assert torch.isfinite(loss) and all(
        float(_leaves(grads)[f"layers/{w}"].abs().max()) > 0 for w in ("wq", "wk", "wv", "wo"))
    with pytest.raises(AssertionError, match="reached"):       # the serving path does
        lm.lm_prefill(params, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, 8)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("sq, chunk", [(12, 16), (12, 5), (16, 4)])
def test_attention_train_matches_jax(sq, chunk, window):
    jlm = load_reference().lm
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 8)).astype(np.float32)
    pos = np.tile(np.arange(sq, dtype=np.int32), (2, 1))
    want = jlm.attention(*map(jnp.asarray, (q, k, v, pos, pos)), window=window,
                         chunk=chunk)
    got = lm.attention_train(*map(torch.from_numpy, (q, k, v, pos, pos)),
                             window=window, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


def test_active_param_count_and_count_params_match_jax():
    jlm = load_reference().lm
    for name in DENSE:
        for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
            assert lm.active_param_count(get(name)) == jlm.active_param_count(jget(name)) \
                == lm.param_count(get(name))
        _, _, jparams, cfg, params = _pair(name)
        from repro.models.nn import count_params as jax_count_params
        assert count_params(params) == jax_count_params(jparams) == lm.param_count(cfg)
    for name in ("arctic-480b", "qwen3-moe-30b-a3b"):     # routed experts count k / E
        assert lm.active_param_count(get_config(name)) == \
            jlm.active_param_count(jax_get_config(name)) < lm.param_count(get_config(name))


# ---------------------------------------------------------------------------
# the launcher's step: 5 steps against JAX's
# ---------------------------------------------------------------------------

def _assert_params_by_quantile(got, want, steps, what):
    diffs = np.concatenate([np.abs(_np(_leaves(got)[k]) - _np(v)).ravel()
                            for k, v in _jax_leaves(want).items()])
    assert diffs.max() <= 2 * LR * steps, f"{what}: max |d| {diffs.max():.2e}"
    assert np.quantile(diffs, 0.99) < 1e-6, f"{what}: p99 {np.quantile(diffs, 0.99):.2e}"
    assert np.median(diffs) < 1e-7


def _jax_step(jlm, jcfg, jopt_cfg):
    @jax.jit
    def step(params, opt, batch):        # the JAX launcher's step (train.py:77)
        loss, grads = jax.value_and_grad(jlm.lm_loss)(params, jcfg, batch)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        params, opt = jax_adam_update(grads, opt, params, jopt_cfg)
        return params, opt, loss
    return step


@pytest.mark.parametrize("name", DENSE)
def test_train_steps_match_jax(name):
    jlm, jcfg, jparams, cfg, params = _pair(name)
    jopt_cfg, opt_cfg = JaxAdamConfig(lr=LR, grad_clip=1.0), AdamConfig(lr=LR, grad_clip=1.0)
    jopt, opt = jax_adam_init(jparams, jopt_cfg), launch.adam_init_tree(params)
    jstep = _jax_step(jlm, jcfg, jopt_cfg)
    rng = np.random.default_rng(0)
    for i in range(5):
        batch = launch.make_batch(rng, cfg, B, S, "cpu")
        jparams, jopt, jloss = jstep(jparams, jopt, {k: jnp.asarray(v.numpy())
                                                     for k, v in batch.items()})
        params, opt, loss = launch.train_step(params, opt, batch, cfg, opt_cfg)
        assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL), i
    assert int(opt.step) == int(jopt.step) == 5
    _assert_params_by_quantile(params, jparams, 5, name)


def test_bf16_moments_are_f32_after_the_first_step_as_in_jax():
    jlm, jcfg, jparams, cfg, params = _pair("internlm2-1.8b", "bfloat16")
    jopt_cfg, opt_cfg = JaxAdamConfig(lr=LR, grad_clip=1.0), AdamConfig(lr=LR, grad_clip=1.0)
    jopt, opt = jax_adam_init(jparams, jopt_cfg), launch.adam_init_tree(params)
    # the launcher's moments are f32 from step 0 (updated in place); JAX's
    # start bf16, and zeros are zeros in either dtype
    assert {t.dtype for t in _leaves(opt.m).values()} == {torch.float32}
    batch = launch.make_batch(np.random.default_rng(1), cfg, B, S, "cpu")
    jparams, jopt, _ = _jax_step(jlm, jcfg, jopt_cfg)(
        jparams, jopt, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params, opt, _ = launch.train_step(params, opt, batch, cfg, opt_cfg)
    for tree, jtree, dt in ((opt.m, jopt.m, torch.float32), (opt.v, jopt.v, torch.float32),
                            (params, jparams, torch.bfloat16)):
        for k, v in _jax_leaves(jtree).items():
            assert _leaves(tree)[k].dtype == dt and str(v.dtype) == str(dt)[6:], k


# ---------------------------------------------------------------------------
# the compressed-gradient example against the JAX example
# ---------------------------------------------------------------------------

def _load_example(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_example():
    return _load_example(ROOT / "examples" / "lm_pretrain_torch.py", "lm_pretrain_torch")


def _jax_example():
    """The JAX example, imported by file path with the reference LM in
    ``sys.modules`` for the import (R1), which is then left as it was."""
    jlm = load_reference().lm
    saved = {k: sys.modules.get(k) for k in ("repro.models.lm",)}
    sys.modules["repro.models.lm"] = jlm
    import repro.models as jmodels
    had = hasattr(jmodels, "lm")
    jmodels.lm = jlm
    try:
        return _load_example(ROOT / "examples" / "lm_pretrain.py", "jax_lm_pretrain")
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        if not had:
            del jmodels.lm


def test_compressed_step_matches_jax_compress_decompress(port_example):
    """ghat is JAX's ``compress_decompress`` of the port's gf bit for bit;
    the residual is gf - ghat in f32, and ghat + r recovers gf up to that
    subtraction's rounding."""
    _, _, _, cfg, params = _pair("internlm2-1.8b")
    opt_cfg = AdamConfig(lr=LR, grad_clip=1.0)
    step = port_example.make_step(cfg, opt_cfg, 12)
    opt = launch.adam_init_tree(params)
    residual = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        prev = tree_map(torch.clone, residual)     # the step writes r in place
        batch = launch.make_batch(rng, cfg, 2, 64, "cpu")
        _, grads = launch.loss_and_grads(params, cfg, batch)
        params, opt, residual, loss, ghat = step(params, opt, residual, batch)
        for k, g in _leaves(grads).items():
            gf = g.float() + _leaves(prev)[k]
            gh, r = _leaves(ghat)[k], _leaves(residual)[k]
            want = np.asarray(jax_compress_decompress(jnp.asarray(gf.numpy()), 12))
            assert np.array_equal(gh.numpy(), want), k
            assert torch.equal(r, gf - gh), k
            err = (gh.double() + r.double() - gf.double()).abs()
            assert bool((err <= 2.0 ** -24 * (gf.double() - gh.double()).abs()).all()), k


def test_example_runs_as_the_jax_example(port_example, tmp_path):
    """Both examples' main, 6 steps at 12 bits on the same token stream
    from different random inits: the printed losses agree to the spread of
    the inits, and each writes its lossy 14-bit checkpoint."""
    jex = _jax_example()
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["lm_pretrain.py", "--steps", "6", "--ckpt-dir", str(tmp_path / "jax")]
    try:
        with redirect_stdout(out):
            jex.main()
    finally:
        sys.argv = argv
    jlines = out.getvalue()
    losses = port_example.main(["--device", "cpu", "--steps", "6",
                                "--ckpt-dir", str(tmp_path / "port")])
    assert len(losses) == 6 and np.isfinite(losses).all()
    jfirst = float(jlines.split("step   0 loss ")[1].split()[0])
    assert abs(losses[0] - jfirst) < 0.2 and abs(losses[0] - np.log(512)) < 0.5
    for sub in ("jax", "port"):
        (step_dir,) = [d for d in os.listdir(tmp_path / sub) if d.startswith("step_")]
        assert step_dir == "step_0000000006"
