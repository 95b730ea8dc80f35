"""The port's VLM family (``internvl2-2b``) against the JAX package's
``repro/models/lm.py`` and ``repro/serving/engine.py``.

The reference is imported through ``torch_lm_reference`` (it does not
import under jax 0.9 otherwise; ROADMAP Queue 3, R1).  Weights come from
the reference's ``init_lm`` through ``params_from_jax``; tokens and image
embeddings are made with numpy from a seed.  The config is
``reduced_config("internvl2-2b")``: 2 layers, d 128, 2 q heads over 1 KV
head x 32, 16 image tokens of width 64 prepended to the text.

Tolerances are ``tests/test_torch_lm_train.py``'s: in f32 the two packages
differ only in summation order, so values are held to ``ATOL`` (1e-4),
forwards to ``F32_RTOL`` of the tensor's largest magnitude, losses to
``F32_RTOL`` and gradients to ``GRAD_RTOL`` of each tensor's largest
magnitude; in bf16 forwards and logits to ``BF16_ULPS`` bf16 ulps of the
tensor's largest magnitude and the loss to ``BF16_LOSS_RTOL``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models.nn import count_params as jax_count_params

from repro_torch.compression import tree_flatten_with_path
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.models.nn import count_params
from repro_torch.serving import ServeEngine
from repro_torch.serving.loadgen import lm_workload
from repro_torch.train.optimizer import AdamConfig

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

NAME = "internvl2-2b"
ATOL = 1e-4
F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ULPS = 4
BF16_LOSS_RTOL = 2e-3
DECODE_ATOL = 2e-5           # decode == forward, as tests/test_lm_archs.py:63
LR = 3e-4
MAX_SEQ = 96
F = 16                       # the reduced config's image tokens


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree):
    return dict(tree_flatten_with_path(tree)[0])


def _jax_leaves(tree):
    return {"/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(dtype="float32", seed=0, **over):
    """(reference lm, JAX cfg, JAX params, port cfg, port params)."""
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(NAME), param_dtype=dtype, **over)
    cfg = dataclasses.replace(reduced_config(NAME), param_dtype=dtype, **over)
    jparams = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return (jlm, jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), cfg,
            lm.params_from_jax(jparams, "cpu"))


def _bf16_atol(want) -> float:
    return BF16_ULPS * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _close(got, want, dtype="float32", what=""):
    want = _np(want)
    atol = ATOL if dtype == "float32" else _bf16_atol(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol, err_msg=what)


def _batch(seed, b=2, s=40, vocab=512, fd=64, image=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if image:
        out["frontend_embeds"] = rng.standard_normal((b, F, fd)).astype(np.float32)
    return out


def _jb(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items() if keys is None or k in keys}


def _tb(batch, keys=None):
    return {k: torch.from_numpy(v) for k, v in batch.items() if keys is None or k in keys}


INPUTS = ("tokens", "frontend_embeds")


# ---------------------------------------------------------------------------
# parameters and the frontend
# ---------------------------------------------------------------------------

def test_param_count_and_layout_match_reference():
    jlm = load_reference().lm
    for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
        assert lm.param_count(get(NAME)) == jlm.param_count(jget(NAME))
        assert lm.active_param_count(get(NAME)) == lm.param_count(get(NAME)) == \
            jlm.active_param_count(jget(NAME))
    assert lm.param_count(get_config(NAME)) == 1_891_244_032
    want = jlm.init_lm(jax.random.PRNGKey(0), jax_reduced_config(NAME))
    got = lm.init_lm(torch.Generator().manual_seed(0), reduced_config(NAME))
    assert set(got) == set(want) == {"embed", "final_norm", "lm_head", "layers",
                                     "frontend_proj"}
    wl, gl = _jax_leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        assert tuple(gl[k].shape) == w.shape and gl[k].dtype == torch.float32, k
    cfg = reduced_config(NAME)
    assert float(got["frontend_proj"].std()) == pytest.approx(cfg.frontend_dim ** -0.5,
                                                              rel=0.1)
    assert count_params(got) == lm.param_count(cfg) == jax_count_params(want)


def test_params_from_jax_carries_frontend_proj():
    _, _, jparams, _, params = _pair(seed=3)
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(jparams["frontend_proj"]))
    assert set(_leaves(params)) == set(_jax_leaves(jparams))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_prepends_the_projected_image(dtype):
    """The image embeddings (f32) are cast to the activations' dtype before
    the product with frontend_proj, prepended, and the positions run over
    image and text: the reference's values, and in bf16 exactly the
    rounded-first product (not the product rounded after)."""
    jlm, jcfg, jparams, cfg, params = _pair(dtype, seed=1)
    batch = _batch(1)
    jx, jpos = jlm._embed_inputs(jparams, jcfg, _jb(batch, INPUTS))
    x, pos = lm._embed_inputs(params, cfg, _tb(batch, INPUTS))
    assert x.dtype == getattr(torch, dtype) and x.shape == (2, F + 40, cfg.d_model)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert pos[0, -1] == F + 39
    _close(x, jx, dtype, "embeddings")
    fe = torch.from_numpy(batch["frontend_embeds"])
    proj = params["frontend_proj"]
    assert torch.equal(x[:, :F], fe.to(proj.dtype) @ proj)
    assert torch.equal(x[:, F:], params["embed"][torch.from_numpy(batch["tokens"]).long()])
    if dtype == "bfloat16":
        late = (fe @ proj.float()).to(torch.bfloat16)
        assert not torch.equal(x[:, :F], late)
    # without image embeddings nothing is prepended (the engine's text-only VLM)
    x, pos = lm._embed_inputs(params, cfg, _tb(batch, ("tokens",)))
    assert x.shape[1] == 40 and int(pos[0, -1]) == 39


# ---------------------------------------------------------------------------
# training forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_and_loss_match_reference(dtype):
    """The hidden rows cover image and text; the loss keeps the last S
    (after the final norm) for the S labels."""
    jlm, jcfg, jparams, cfg, params = _pair(dtype, attn_chunk=16)
    batch = _batch(2)
    jh, jaux = jlm.lm_forward(jparams, jcfg, _jb(batch, INPUTS))
    h, aux = lm.lm_forward(params, cfg, _tb(batch, INPUTS))
    assert h.dtype == getattr(torch, dtype) and h.shape == (2, F + 40, cfg.d_model)
    assert float(aux) == float(jaux) == 0
    want = _np(jh)
    atol = F32_RTOL * np.abs(want).max() if dtype == "float32" else _bf16_atol(want)
    np.testing.assert_allclose(_np(h), want, rtol=0, atol=atol)
    rtol = F32_RTOL if dtype == "float32" else BF16_LOSS_RTOL
    for chunk in (16, 512):
        jloss = float(jlm.lm_loss(jparams, jcfg, _jb(batch), chunk))
        loss = lm.lm_loss(params, cfg, _tb(batch), chunk)
        assert loss.dtype == torch.float32
        assert float(loss) == pytest.approx(jloss, rel=rtol), chunk
    # the label slice: the loss is the text rows' cross-entropy
    with torch.no_grad():
        logits = (h[:, F:].float() @ lm._head_weight(params, cfg).float())
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                           torch.from_numpy(batch["labels"]).long().ravel())
    if dtype == "float32":
        assert float(lm.lm_loss(params, cfg, _tb(batch), 40)) == pytest.approx(float(ce),
                                                                             rel=F32_RTOL)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_gradients_match_jax_value_and_grad(remat):
    """Every gradient, frontend_proj's included, against jax.value_and_grad
    under each remat mode."""
    jlm, jcfg, jparams, cfg, params = _pair(remat=remat, attn_chunk=16)
    batch = _batch(3)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, _jb(batch))
    loss, grads = train_launcher.loss_and_grads(params, cfg, _tb(batch))
    assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL)
    want = _jax_leaves(jgrads)
    assert set(_leaves(grads)) == set(want)
    for k, w in want.items():
        w = _np(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(_leaves(grads)[k]), w, rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=k)
    assert float(grads["frontend_proj"].abs().max()) > 0


def test_training_never_reaches_the_serving_kernel_and_serving_never_the_plain(monkeypatch):
    """lm_loss and its backward attend through attention_train only;
    lm_prefill and serve_step through ops.flash_attention only."""
    _, _, _, cfg, params = _pair()
    batch = _batch(4)

    def refuse(what):
        def f(*a, **kw):
            raise AssertionError(f"{what} reached")
        return f

    with monkeypatch.context() as m:
        m.setattr(ops, "flash_attention", refuse("ops.flash_attention"))
        loss, grads = train_launcher.loss_and_grads(params, cfg, _tb(batch))
        assert torch.isfinite(loss) and float(grads["frontend_proj"].abs().max()) > 0
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(lm, "attention_train", refuse("attention_train"))
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: (
        calls.append(kw["causal"]), real(*a, **kw))[1])
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32)
    lm.serve_step(params, cfg, cache, logits.argmax(-1).to(torch.int32), F + 40)
    assert calls == [True] * (2 * cfg.num_layers)


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True], ids=["equal", "prompt_lens"])
def test_prefill_and_decode_match_reference(padded):
    """lm_prefill of image + text (prompt_lens counting the image tokens),
    then four serve_steps with a scalar pos or per-slot positions: logits
    and caches."""
    jlm, jcfg, jparams, cfg, params = _pair()
    rng = np.random.default_rng(5)
    b, s = 3, 30
    batch = _batch(5, b=b, s=s)
    lens = np.array([F + 30, F + 7, F + 19], np.int32) if padded else None
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, _jb(batch, INPUTS), MAX_SEQ,
                                     cache_dtype=jnp.float32,
                                     prompt_lens=None if lens is None else jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert logits.shape == (b, cfg.vocab_size) and set(cache) == set(jcache) == {"k", "v"}
    _close(logits, jlogits, what="prefill logits")
    for k in cache:
        _close(cache[k], jcache[k], what=f"prefill {k}")
    pos = lens.copy() if padded else F + s
    for _ in range(4):
        cur = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur),
                                         jnp.asarray(pos) if padded else pos)
        logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur),
                                      torch.from_numpy(pos) if padded else pos)
        _close(logits, jlogits, what="decode logits")
        pos = pos + 1
    for k in cache:
        _close(cache[k], jcache[k], what=f"decode {k}")


def test_prompt_lens_counts_the_image_tokens():
    """A right-padded row's logits equal its prompt's prefill alone: its
    length is its image tokens plus its text."""
    _, _, _, cfg, params = _pair(seed=2)
    batch = _batch(6, b=2, s=20)
    short = {"tokens": batch["tokens"][1:, :9], "frontend_embeds": batch["frontend_embeds"][1:]}
    logits_b, cache_b = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), 48,
                                      cache_dtype=torch.float32,
                                      prompt_lens=torch.tensor([F + 20, F + 9]))
    logits_s, cache_s = lm.lm_prefill(params, cfg, _tb(short), 48, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits_b[1]), _np(logits_s[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(cache_b["k"][:, 1, :F + 9]), _np(cache_s["k"][:, 0, :F + 9]),
                               rtol=0, atol=1e-5)


def test_bf16_prefill_and_decode_match_reference():
    """bf16 weights, the engine's f32 cache: logits in bf16 ulps."""
    jlm, jcfg, jparams, cfg, params = _pair("bfloat16", seed=1)
    batch = _batch(7, b=2, s=24)
    lens = np.array([F + 24, F + 11], np.int32)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, _jb(batch, INPUTS), MAX_SEQ,
                                     cache_dtype=jnp.float32, prompt_lens=jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32, prompt_lens=torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "prefill logits")
    cur = np.array([3, 7], np.int32)
    jlogits, _ = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), jnp.asarray(lens))
    logits, _ = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "decode logits")


def test_decode_matches_forward():
    """The image and the first text token prefilled, the rest decoded
    teacher-forced one token a step == the full forward over image + text
    (limit 2e-5, as tests/test_lm_archs.py:63)."""
    cfg = dataclasses.replace(reduced_config(NAME), attn_chunk=16)
    _, _, _, _, params = _pair(seed=4)
    b, s = 2, 20
    batch = _tb(_batch(8, b=b, s=s), INPUTS)
    with torch.no_grad():
        hidden, _ = lm.lm_forward(params, cfg, batch)
        full = hidden @ lm._head_weight(params, cfg)
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": batch["tokens"][:, :1],
                                                "frontend_embeds": batch["frontend_embeds"]},
                                  F + s, cache_dtype=torch.float32)
    errs = [float((logits - full[:, F]).abs().max())]
    for t in range(1, s):
        logits, cache = lm.serve_step(params, cfg, cache, batch["tokens"][:, t], F + t)
        errs.append(float((logits - full[:, F + t]).abs().max()))
    assert max(errs) < DECODE_ATOL, f"decode diverges from forward: {max(errs)}"


# ---------------------------------------------------------------------------
# the serving engine and the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
def test_engine_serves_the_reference_tokens(mode):
    """Both engines serve a VLM from tokens alone (the JAX engine's prefill
    passes only tokens): the same greedy tokens and counts."""
    ref = load_reference()
    jcfg = jax_reduced_config(NAME)
    jparams = ref.lm.init_lm(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    kw = dict(batch_slots=3, max_seq=48)
    e_ref = ref.engine.ServeEngine(jparams, jcfg, **kw)
    e_port = ServeEngine(params, reduced_config(NAME), device="cpu", **kw)
    wl = dict(prompt_lens=(3, 9, 14), new_tokens=(0, 1, 3, 6))
    done_ref = getattr(e_ref, mode)(ref.loadgen.lm_workload(512, 8, seed=2, **wl))
    done_port = getattr(e_port, mode)(lm_workload(512, 8, seed=2, **wl))
    assert len(done_port) == len(done_ref) == 8
    for a, b in zip(done_port, done_ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.output, b.output)
    counts = ("tokens", "prefill_tokens", "decode_steps", "delivered_slot_steps")
    assert {k: e_port.stats[k] for k in counts} == {k: e_ref.stats[k] for k in counts}


def test_launchers_serve_and_train_on_the_cpu(capsys, tmp_path):
    done = serve_launcher.main(["--device", "cpu", "--arch", NAME, "--requests", "3"])
    assert len(done) == 3 and all(r.output is not None for r in done)
    losses = train_launcher.main(["--arch", NAME, "--device", "cpu", "--steps", "3",
                                  "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    out = capsys.readouterr().out
    assert "lm: 3 completed" in out and "device cpu" in out


def test_launcher_batch_and_steps_match_jax():
    """make_batch adds zero f32 image embeddings (B, frontend_seq,
    frontend_dim), as the JAX launcher does; three of the launcher's steps
    against the JAX launcher's step on those batches: losses to F32_RTOL,
    parameters by quantile (Adam moves an element by about +-lr a step)."""
    from repro.train.optimizer import AdamConfig as JaxAdamConfig
    from repro.train.optimizer import adam_init as jax_adam_init
    from repro.train.optimizer import adam_update as jax_adam_update
    jlm, jcfg, jparams, cfg, params = _pair(attn_chunk=16)
    rng = np.random.default_rng(0)
    batch = train_launcher.make_batch(rng, cfg, 2, 24, "cpu")
    assert batch["frontend_embeds"].shape == (2, F, cfg.frontend_dim)
    assert batch["frontend_embeds"].dtype == torch.float32
    assert not bool(batch["frontend_embeds"].any())
    jopt_cfg, opt_cfg = JaxAdamConfig(lr=LR, grad_clip=1.0), AdamConfig(lr=LR, grad_clip=1.0)
    jopt, opt = jax_adam_init(jparams, jopt_cfg), train_launcher.adam_init_tree(params)

    @jax.jit
    def jstep(p, o, bt):                 # the JAX launcher's step (train.py:77)
        loss, grads = jax.value_and_grad(jlm.lm_loss)(p, jcfg, bt)
        grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
        p, o = jax_adam_update(grads, o, p, jopt_cfg)
        return p, o, loss

    for i in range(3):
        batch = train_launcher.make_batch(rng, cfg, 2, 24, "cpu")
        jparams, jopt, jloss = jstep(jparams, jopt, {k: jnp.asarray(v.numpy())
                                                     for k, v in batch.items()})
        params, opt, loss = train_launcher.train_step(params, opt, batch, cfg, opt_cfg)
        assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL), i
    diffs = np.concatenate([np.abs(_np(_leaves(params)[k]) - _np(v)).ravel()
                            for k, v in _jax_leaves(jparams).items()])
    assert diffs.max() <= 2 * LR * 3 and np.quantile(diffs, 0.99) < 1e-6
