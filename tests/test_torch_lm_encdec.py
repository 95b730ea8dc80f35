"""The port's encoder-decoder family (``seamless-m4t-large-v2``) against the
JAX package's ``repro/models/lm.py`` and ``repro/serving/engine.py``.

The reference is imported through ``torch_lm_reference`` (it does not
import under jax 0.9 otherwise; ROADMAP Queue 3, R1).  Weights come from
the reference's ``init_lm`` through ``params_from_jax``; tokens and
encoder frames are made with numpy from a seed.  The config is
``reduced_config("seamless-m4t-large-v2")``: 2 encoder and 2 decoder
layers, d 128, 2 q heads over 2 KV heads x 32, frames of width 64 through
``frontend_proj`` into the encoder.  Decoder prompts both longer and
shorter than the encoder input are served, so the cross-attention runs
with more queries than keys and with fewer.

Tolerances are ``tests/test_torch_lm_train.py``'s: in f32 the two packages
differ only in summation order, so values are held to ``ATOL`` (1e-4),
forwards to ``F32_RTOL`` of the tensor's largest magnitude, losses to
``F32_RTOL`` and gradients to ``GRAD_RTOL`` of each tensor's largest
magnitude; in bf16 forwards and logits to ``BF16_ULPS`` bf16 ulps of the
tensor's largest magnitude and the loss to ``BF16_LOSS_RTOL``.
"""
import dataclasses
import math
import pathlib

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
from repro_torch.train.optimizer import AdamConfig

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = "seamless-m4t-large-v2"
ATOL = 1e-4
F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ULPS = 4
BF16_LOSS_RTOL = 2e-3
DECODE_ATOL = 2e-5           # decode == forward, as tests/test_lm_archs.py:63
LR = 3e-4
MAX_SEQ = 64
CROSS = ("ln_x", "xwq", "xwk", "xwv", "xwo")
INPUTS = ("tokens", "encoder_embeds")


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


def _batch(seed, b=2, s=40, se=24, vocab=512, fd=64):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "encoder_embeds": rng.standard_normal((b, se, fd)).astype(np.float32)}


def _jb(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items() if keys is None or k in keys}


def _tb(batch, keys=None):
    return {k: torch.from_numpy(v) for k, v in batch.items() if keys is None or k in keys}


# ---------------------------------------------------------------------------
# parameters, cache, layers
# ---------------------------------------------------------------------------

def test_param_count_and_layout_match_reference():
    jlm = load_reference().lm
    for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
        assert lm.param_count(get(NAME)) == jlm.param_count(jget(NAME))
        assert lm.active_param_count(get(NAME)) == lm.param_count(get(NAME)) == \
            jlm.active_param_count(jget(NAME))
    assert lm.param_count(get_config(NAME)) == 2_035_832_832
    want = jlm.init_lm(jax.random.PRNGKey(0), jax_reduced_config(NAME))
    got = lm.init_lm(torch.Generator().manual_seed(0), reduced_config(NAME))
    assert set(got) == set(want) == {"embed", "final_norm", "lm_head", "layers",
                                     "enc_layers", "enc_norm", "frontend_proj"}
    wl, gl = _jax_leaves(want), _leaves(got)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        assert tuple(gl[k].shape) == w.shape and gl[k].dtype == torch.float32, k
    assert set(CROSS) <= set(got["layers"]) and not set(CROSS) & set(got["enc_layers"])
    cfg = reduced_config(NAME)
    h, hd = cfg.num_heads, cfg.hdim
    assert float(got["layers"]["xwo"].std()) == pytest.approx((h * hd) ** -0.5, rel=0.1)
    assert float(got["layers"]["xwq"].std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert bool((got["layers"]["ln_x"] == 1).all()) and bool((got["enc_norm"] == 1).all())
    assert count_params(got) == lm.param_count(cfg) == jax_count_params(want)


def test_params_from_jax_carries_the_encoder():
    _, _, jparams, _, params = _pair(seed=3)
    assert set(_leaves(params)) == set(_jax_leaves(jparams))
    for k, w in _jax_leaves(jparams).items():
        if k.split("/")[0] in ("enc_layers", "enc_norm", "frontend_proj") or \
                k.split("/")[-1] in CROSS:
            np.testing.assert_array_equal(_leaves(params)[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("enc_seq", [0, 12])
def test_init_cache_matches_reference(enc_seq):
    jlm = load_reference().lm
    want = jlm.init_cache(jax_reduced_config(NAME), 3, 20, jnp.float32, enc_seq=enc_seq)
    got = lm.init_cache(reduced_config(NAME), 3, 20, torch.float32, device="cpu",
                        enc_seq=enc_seq)
    assert set(got) == set(want) == ({"k", "v", "xk", "xv"} if enc_seq else {"k", "v"})
    for k in got:
        assert tuple(got[k].shape) == want[k].shape and not bool(got[k].any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_matches_reference(dtype):
    jlm, jcfg, jparams, cfg, params = _pair(dtype, seed=1)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 13, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(13, dtype=np.int32), (2, 1))
    jlp = jax.tree_util.tree_map(lambda a: a[1], jparams["enc_layers"])
    lp = lm._layer(params, 1, "enc_layers")
    want = jlm.encoder_layer(jlp, jnp.asarray(x, jcfg.param_dtype), jcfg, jnp.asarray(pos))
    tx, tpos = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos)
    got = lm.encoder_layer(lp, tx, cfg, tpos)
    _close(got, want, dtype, "encoder layer")
    # the serving form (the kernel's plain version here) computes the same
    _close(lm.encoder_layer(lp, tx, cfg, tpos, serving=True), want, dtype, "serving")


@pytest.mark.parametrize("se", [7, 30], ids=["fewer_keys", "more_keys"])
def test_cross_attention_layer_prefill_and_decode_match_reference(se):
    """One decoder layer with the cross cache: the prefill writes xk/xv
    (from enc_out) and attends to them; a decode step reads them."""
    jlm, jcfg, jparams, cfg, params = _pair(seed=2)
    rng = np.random.default_rng(2)
    b, s = 2, 11
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    enc = (rng.standard_normal((b, se, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    lp = lm._layer(params, 0)
    jcache = jax.tree_util.tree_map(lambda a: a[0], jlm.init_cache(jcfg, b, 16, jnp.float32,
                                                                   enc_seq=se))
    cache = {k: v[0] for k, v in lm.init_cache(cfg, b, 16, torch.float32, device="cpu",
                                               enc_seq=se).items()}
    jy, jcache, _ = jlm.decoder_layer(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                      enc_out=jnp.asarray(enc), cache=jcache, cache_pos=0)
    y, out, _ = lm.decoder_layer(lp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                                 enc_out=torch.from_numpy(enc), cache=cache, cache_pos=0)
    _close(y, jy, what="prefill layer")
    assert set(out) == set(jcache) == {"k", "v", "xk", "xv"}
    for k in out:
        assert out[k].data_ptr() == cache[k].data_ptr()          # written in place
        _close(out[k], jcache[k], what=f"prefill {k}")
    x1 = x[:, :1]
    dpos = np.array([[s], [s]], np.int32)
    jy, jcache, _ = jlm.decoder_layer(jlp, jnp.asarray(x1), jcfg, jnp.asarray(dpos),
                                      cache=jcache, cache_pos=s)
    y, out, _ = lm.decoder_layer(lp, torch.from_numpy(x1), cfg, torch.from_numpy(dpos),
                                 cache=cache, cache_pos=s)
    _close(y, jy, what="decode layer")
    for k in out:
        _close(out[k], jcache[k], what=f"decode {k}")
    # without a cache (training): the same layer output as the reference's
    jy, _, _ = jlm.decoder_layer(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 enc_out=jnp.asarray(enc))
    y, _, _ = lm.decoder_layer(lp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                               enc_out=torch.from_numpy(enc))
    _close(y, jy, what="training layer")


def test_cross_cache_is_read_rounded_to_q_dtype():
    """A bf16 model decoding from the f32 cross cache reads it as
    cache.astype(q.dtype), as the reference does."""
    jlm, jcfg, jparams, cfg, params = _pair("bfloat16", seed=5)
    batch = _batch(5, s=12, se=10)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, _jb(batch, INPUTS), 20,
                                     cache_dtype=jnp.float32)
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), 20, cache_dtype=torch.float32)
    assert cache["xk"].dtype == torch.float32
    _close(cache["xk"], jcache["xk"], "bfloat16", "xk")
    cur = np.array([1, 2], np.int32)
    jlogits, _ = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), 12)
    logits, _ = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), 12)
    _close(logits, jlogits, "bfloat16", "decode logits")


# ---------------------------------------------------------------------------
# training forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_and_loss_match_reference(dtype):
    jlm, jcfg, jparams, cfg, params = _pair(dtype, attn_chunk=16)
    batch = _batch(2)
    jh, jaux = jlm.lm_forward(jparams, jcfg, _jb(batch, INPUTS))
    h, aux = lm.lm_forward(params, cfg, _tb(batch, INPUTS))
    assert h.dtype == getattr(torch, dtype) and h.shape == (2, 40, cfg.d_model)
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


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_gradients_match_jax_value_and_grad(remat):
    """Every gradient against jax.value_and_grad under each remat mode; the
    encoder's reach it only through the decoder's cross-attention."""
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
    for k in ("enc_layers/wq", "enc_layers/w_up", "enc_norm", "frontend_proj",
              "layers/xwk", "layers/xwo"):
        assert float(_leaves(grads)[k].abs().max()) > 0, k


def test_training_never_reaches_the_serving_kernel_and_serving_never_the_plain(monkeypatch):
    """lm_loss and its backward attend through attention_train only;
    lm_prefill and serve_step through ops.flash_attention only: the
    encoder's layers and the cross-attention non-causal, the decoder's
    self-attention causal."""
    _, _, _, cfg, params = _pair()
    batch = _batch(4)

    def refuse(what):
        def f(*a, **kw):
            raise AssertionError(f"{what} reached")
        return f

    with monkeypatch.context() as m:
        m.setattr(ops, "flash_attention", refuse("ops.flash_attention"))
        loss, _ = train_launcher.loss_and_grads(params, cfg, _tb(batch))
        assert torch.isfinite(loss)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(lm, "attention_train", refuse("attention_train"))
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: (
        calls.append(kw["causal"]), real(*a, **kw))[1])
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32)
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    assert calls == [False] * n_enc + [True, False] * n_dec
    calls.clear()
    lm.serve_step(params, cfg, cache, logits.argmax(-1).to(torch.int32), 40)
    assert calls == [True, False] * n_dec


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("se", [9, 48], ids=["prompt_longer", "prompt_shorter"])
@pytest.mark.parametrize("padded", [False, True], ids=["equal", "prompt_lens"])
def test_prefill_and_decode_match_reference(padded, se):
    """lm_prefill (the encoder, then decoder prompts of 30 tokens over se
    frames), then four serve_steps with a scalar pos or per-slot positions:
    logits and every cache leaf, the cross cache included."""
    jlm, jcfg, jparams, cfg, params = _pair()
    rng = np.random.default_rng(6)
    b, s = 3, 30
    batch = _batch(6, b=b, s=s, se=se)
    lens = np.array([30, 7, 19], np.int32) if padded else None
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, _jb(batch, INPUTS), MAX_SEQ,
                                     cache_dtype=jnp.float32,
                                     prompt_lens=None if lens is None else jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert set(cache) == set(jcache) == {"k", "v", "xk", "xv"}
    assert cache["xk"].shape == (cfg.num_layers, b, se, cfg.num_kv_heads, cfg.hdim)
    _close(logits, jlogits, what="prefill logits")
    for k in cache:
        _close(cache[k], jcache[k], what=f"prefill {k}")
    pos = lens.copy() if padded else s
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


def test_serve_step_with_enc_out_writes_the_cross_cache():
    """serve_step(enc_out=) recomputes the cross keys and values from
    enc_out and writes them into the cache, as the reference's decode does
    where it is given enc_out."""
    jlm, jcfg, jparams, cfg, params = _pair(seed=7)
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jcache = jlm.init_cache(jcfg, 2, 8, jnp.float32, enc_seq=5)
    cache = lm.init_cache(cfg, 2, 8, torch.float32, device="cpu", enc_seq=5)
    cur = np.array([4, 9], np.int32)
    jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), 0,
                                     enc_out=jnp.asarray(enc))
    logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), 0,
                                  enc_out=torch.from_numpy(enc))
    _close(logits, jlogits, what="logits")
    for k in cache:
        _close(cache[k], jcache[k], what=k)
    assert bool(cache["xk"].any())


def test_bf16_prefill_and_decode_match_reference():
    """bf16 weights and the dry run's f32 cache: logits in bf16 ulps."""
    jlm, jcfg, jparams, cfg, params = _pair("bfloat16", seed=1)
    batch = _batch(8, b=2, s=24, se=40)
    lens = np.array([24, 11], np.int32)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, _jb(batch, INPUTS), MAX_SEQ,
                                     cache_dtype=jnp.float32, prompt_lens=jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, _tb(batch, INPUTS), MAX_SEQ,
                                  cache_dtype=torch.float32, prompt_lens=torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "prefill logits")
    cur = np.array([3, 7], np.int32)
    jlogits, _ = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), jnp.asarray(lens))
    logits, _ = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "decode logits")


@pytest.mark.parametrize("s, se", [(24, 10), (12, 40)], ids=["prompt_longer",
                                                            "prompt_shorter"])
def test_decode_matches_forward(s, se):
    """The encoder and the first decoder token prefilled, the rest decoded
    teacher-forced one token a step == the full forward (limit 2e-5, as
    tests/test_lm_archs.py:63); the decoder sequence longer than the
    encoder input and shorter."""
    cfg = dataclasses.replace(reduced_config(NAME), attn_chunk=16)
    _, _, _, _, params = _pair(seed=4)
    batch = _tb(_batch(9, b=2, s=s, se=se), INPUTS)
    with torch.no_grad():
        hidden, _ = lm.lm_forward(params, cfg, batch)
        full = hidden @ lm._head_weight(params, cfg)
    first = s // 2                       # a prefill of more tokens than frames or fewer
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": batch["tokens"][:, :first],
                                                "encoder_embeds": batch["encoder_embeds"]},
                                  s, cache_dtype=torch.float32)
    errs = [float((logits - full[:, first - 1]).abs().max())]
    for t in range(first, s):
        logits, cache = lm.serve_step(params, cfg, cache, batch["tokens"][:, t], t)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < DECODE_ATOL, f"decode diverges from forward: {max(errs)}"


# ---------------------------------------------------------------------------
# the engines and the launchers
# ---------------------------------------------------------------------------

def test_engines_and_serve_launchers_refuse_it_the_same_way():
    """Neither package's ServeEngine serves an encoder-decoder (it goes
    through the decode dry run): the same ValueError; the port's serving
    launcher exits with the JAX launcher's message and the command of the
    port's decode dry run."""
    ref = load_reference()
    jcfg = jax_reduced_config(NAME)
    with pytest.raises(ValueError) as want:
        ref.engine.ServeEngine(ref.lm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    with pytest.raises(ValueError) as got:
        ServeEngine(lm.init_lm(0, reduced_config(NAME), device="cpu"), reduced_config(NAME),
                    device="cpu")
    assert str(got.value) == str(want.value) and "dry-run" in str(got.value)
    with pytest.raises(SystemExit) as exit_:
        serve_launcher.main(["--device", "cpu", "--arch", NAME])
    message = str(exit_.value)
    jax_message = "use the decode dry-run for enc-dec serving"
    assert f'raise SystemExit("{jax_message}")' in \
        (ROOT / "src" / "repro" / "launch" / "serve.py").read_text()
    # the port's message adds the port's decode dry run
    assert message == (f"{jax_message} (python -m repro_torch.launch.dryrun --arch {NAME} "
                       "--cell decode_32k)")


def test_train_launcher_runs_on_the_cpu(capsys, tmp_path):
    losses = train_launcher.main(["--arch", NAME, "--device", "cpu", "--steps", "3",
                                  "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "device cpu" in capsys.readouterr().out


def test_launcher_batch_and_steps_match_jax():
    """make_batch adds zero f32 encoder frames (B, S, frontend_dim), as the
    JAX launcher does; three of the launcher's steps against the JAX
    launcher's step on those batches: losses to F32_RTOL, parameters by
    quantile (Adam moves an element by about +-lr a step)."""
    from repro.train.optimizer import AdamConfig as JaxAdamConfig
    from repro.train.optimizer import adam_init as jax_adam_init
    from repro.train.optimizer import adam_update as jax_adam_update
    jlm, jcfg, jparams, cfg, params = _pair(attn_chunk=16)
    rng = np.random.default_rng(0)
    batch = train_launcher.make_batch(rng, cfg, 2, 24, "cpu")
    assert batch["encoder_embeds"].shape == (2, 24, cfg.frontend_dim)
    assert batch["encoder_embeds"].dtype == torch.float32
    assert not bool(batch["encoder_embeds"].any()) and "frontend_embeds" not in batch
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
