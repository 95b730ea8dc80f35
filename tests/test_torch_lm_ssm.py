"""The port's SSM (Mamba2 SSD) and hybrid (Hymba) LM families against the
JAX package's ``repro/models/lm.py`` and ``repro/serving/engine.py``.

The reference is imported through ``torch_lm_reference`` (it does not
import under jax 0.9 otherwise; ROADMAP Queue 3, R1).  Weights come from
the reference's ``init_lm`` through ``params_from_jax``; every input is
made with numpy from a seed.  The configs are ``reduced_config``'s
``mamba2-130m`` (2 layers, d 128, 4 SSM heads x 16, state 16) and
``hymba-1.5b`` (the same SSM beside 3 q heads over 1 KV head, window 64,
layer 0 global).

Tolerances: in f32 the two packages differ only in summation order, so
modules, logits and caches are held to ``ATOL`` (1e-4), losses to
``F32_RTOL`` of the loss and gradients to ``GRAD_RTOL`` of each tensor's
largest magnitude, as ``tests/test_torch_lm_train.py`` holds the dense
family.  ``_causal_conv`` is the same sum of the same products in the same
order, so it is held bit for bit in f32 and bf16 against the reference run
op by op.  Where the JAX function is compiled (its ``lax.scan`` over
layers and chunks), XLA keeps bf16 chains in f32 where PyTorch rounds
every op: bf16 is held to ``BF16_ULPS`` bf16 ulps of the tensor's largest
magnitude and the loss to ``BF16_LOSS_RTOL``.  One hybrid layer differs by
1 ulp of its output's largest magnitude (its SSM branch, as mamba2's), and
the second layer amplifies its input's rounding: over the two layers the
hybrid is held to ``BF16_ULPS_HYBRID`` (measured 8.0-9.0 on two seeds,
with or without XLA's excess precision; mamba2 at most 4).
"""
import dataclasses
import importlib.util
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
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import lm
from repro_torch.models.nn import count_params
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.loadgen import lm_workload

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("mamba2-130m", "hymba-1.5b")
ATOL = 1e-4
F32_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_ULPS = 4
BF16_ULPS_HYBRID = 12
BF16_LOSS_RTOL = 2e-3
MAX_SEQ = 96


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaves(tree):
    return dict(tree_flatten_with_path(tree)[0])


def _jax_leaves(tree):
    return {"/".join(str(p.key) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(name, dtype="float32", seed=0, **over):
    """(reference lm, JAX cfg, JAX params, port cfg, port params)."""
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(name), param_dtype=dtype, **over)
    cfg = dataclasses.replace(reduced_config(name), param_dtype=dtype, **over)
    jparams = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    return (jlm, jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), cfg,
            lm.params_from_jax(jparams, "cpu"))


def _bf16_atol(want, name="mamba2-130m") -> float:
    ulps = BF16_ULPS_HYBRID if name == "hymba-1.5b" else BF16_ULPS
    return ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _close(got, want, dtype="float32", what="", name="mamba2-130m"):
    want = _np(want)
    atol = ATOL if dtype == "float32" else _bf16_atol(want, name)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol, err_msg=what)


def _tokens(rng, b, s, vocab):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _batch(seed, b=2, s=40, vocab=512):
    toks = _tokens(np.random.default_rng(seed), b, s, vocab)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


# ---------------------------------------------------------------------------
# parameters, counts, cache
# ---------------------------------------------------------------------------

def test_param_count_matches_reference():
    jlm = load_reference().lm
    for name in FAMILIES:
        for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
            assert lm.param_count(get(name)) == jlm.param_count(jget(name))
            assert lm.active_param_count(get(name)) == jlm.active_param_count(jget(name))
        _, _, jparams, cfg, params = _pair(name)
        assert count_params(params) == jax_count_params(jparams) == lm.param_count(cfg)
    assert lm.param_count(get_config("mamba2-130m")) == 128_958_912
    assert lm.param_count(get_config("hymba-1.5b")) == 1_640_768_896


@pytest.mark.parametrize("name", FAMILIES)
def test_init_has_the_reference_layout_and_f32_ssm_leaves(name):
    """The port's init in bf16: the reference's leaves and shapes, the
    reference's dtypes (ssm_A, ssm_D, ssm_dt_bias f32) and its fixed
    values."""
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(name), param_dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(name), param_dtype="bfloat16")
    want = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    got = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k, w in _jax_leaves(want).items():
        g = _leaves(got)[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k
    for k in ("ssm_A", "ssm_D", "ssm_dt_bias", "ssm_norm", "ln1", "ln2"):
        np.testing.assert_allclose(_np(got["layers"][k]), _np(want["layers"][k]),
                                   rtol=1e-6, err_msg=k)
    assert float(got["layers"]["ssm_conv_w"].float().std()) == pytest.approx(
        cfg.ssm_conv ** -0.5, rel=0.15)
    assert float(got["layers"]["ssm_in"].float().std()) == pytest.approx(
        cfg.d_model ** -0.5, rel=0.1)
    assert ("wq" in got["layers"]) == cfg.hybrid and ("w_up" in got["layers"]) == cfg.hybrid
    # params_from_jax keeps each leaf's dtype
    carried = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, want), "cpu")
    for k, w in _jax_leaves(want).items():
        assert str(_leaves(carried)[k].dtype).split(".")[-1] == str(w.dtype), k


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", FAMILIES)
def test_init_cache_matches_reference(name, dtype):
    """conv in the cache dtype, ssm always f32, k/v for the hybrid only."""
    jlm = load_reference().lm
    want = jlm.init_cache(jax_reduced_config(name), 3, 20, dtype)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = lm.init_cache(reduced_config(name), 3, 20, tdtype, device="cpu")
    assert set(got) == set(want) == ({"k", "v", "conv", "ssm"} if name == "hymba-1.5b"
                                     else {"conv", "ssm"})
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
        assert not bool(got[k].any()), k
    assert got["ssm"].dtype == torch.float32 and got["conv"].dtype == tdtype


# ---------------------------------------------------------------------------
# the SSD and its pieces
# ---------------------------------------------------------------------------

def test_segsum_matches_reference_and_its_gradient_is_finite():
    jlm = load_reference().lm
    da = -np.abs(np.random.default_rng(0).standard_normal((2, 3, 7))).astype(np.float32)
    want = np.asarray(jlm._segsum(jnp.asarray(da)))
    t = torch.from_numpy(da).requires_grad_()
    got = lm._segsum(t)
    assert got.shape == (2, 3, 7, 7)
    upper = np.triu(np.ones((7, 7), bool), 1)
    assert np.all(np.isneginf(_np(got)[..., upper])) and np.all(np.isneginf(want[..., upper]))
    np.testing.assert_allclose(_np(got)[..., ~upper], want[..., ~upper], rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad(torch.exp(got).sum(), t)
    jg = jax.grad(lambda x: jnp.sum(jnp.exp(jlm._segsum(x))))(jnp.asarray(da))
    assert bool(torch.isfinite(g).all())
    np.testing.assert_allclose(_np(g), _np(jg), rtol=0, atol=1e-5)


def _ssd_inputs(seed, b=2, s=16, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(np.float32)
    a_log = np.log(np.linspace(1, 16, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xh, dt, a_log, bm, cm, state


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "init_state"])
@pytest.mark.parametrize("s", [5, 8, 16], ids=["S<chunk", "S=chunk", "S=2chunk"])
def test_ssd_scan_matches_reference(s, with_state):
    """Chunks of 8 (one shorter chunk, one chunk, two chunks), from zeros
    or from a carried state: y and the final state."""
    jlm = load_reference().lm
    xh, dt, a_log, bm, cm, state = _ssd_inputs(1, s=s)
    init = state if with_state else None
    jy, jst = jlm.ssd_scan(*map(jnp.asarray, (xh, dt, a_log, bm, cm)), chunk=8,
                           init_state=None if init is None else jnp.asarray(init))
    y, st = lm.ssd_scan(*map(torch.from_numpy, (xh, dt, a_log, bm, cm)), chunk=8,
                        init_state=None if init is None else torch.from_numpy(init))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    _close(y, jy, what="y")
    _close(st, jst, what="state")


def test_ssd_scan_refuses_what_the_reference_cannot_reshape():
    """S above the chunk and not a multiple of it: JAX's reshape fails; the
    port names the rule instead of padding."""
    jlm = load_reference().lm
    xh, dt, a_log, bm, cm, _ = _ssd_inputs(2, s=12)
    with pytest.raises(TypeError):
        jlm.ssd_scan(*map(jnp.asarray, (xh, dt, a_log, bm, cm)), chunk=8)
    with pytest.raises(ValueError, match="multiple of it"):
        lm.ssd_scan(*map(torch.from_numpy, (xh, dt, a_log, bm, cm)), chunk=8)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_is_the_reference_bit_for_bit(dtype, with_state):
    jlm = load_reference().lm
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = (rng.standard_normal((4, 12)) * 0.5).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jst = jlm._causal_conv(jnp.asarray(x, jt), jnp.asarray(w, jt),
                               jnp.asarray(st, jt) if with_state else None)
    y, new = lm._causal_conv(torch.from_numpy(x).to(tt), torch.from_numpy(w).to(tt),
                             torch.from_numpy(st).to(tt) if with_state else None)
    assert y.dtype == tt and new.shape == (2, 3, 12)
    np.testing.assert_array_equal(_np(y), _np(jy))
    np.testing.assert_array_equal(_np(new), _np(jst))


def test_softplus_is_jax_softplus():
    """To an f32 ulp; XLA on the CPU flushes subnormal results to zero
    (softplus(-88) = 6e-39), hence an absolute floor of the smallest normal
    f32."""
    x = np.concatenate([np.linspace(-30, 30, 2001), [0.0, -0.0, 1e-8, 88.0, -88.0]]) \
        .astype(np.float32)
    np.testing.assert_allclose(_np(lm.softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))), rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


def _block_inputs(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    k, c = cfg.ssm_conv, cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state
    conv = rng.standard_normal((b, k - 1, c)).astype(np.float32)
    ssm = (rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
           * 0.1).astype(np.float32)
    return x, conv, ssm


def test_ssm_block_with_a_pad_mask_leaves_each_row_a_solo_state():
    """Mixed lengths in one right-padded call: the reference's outputs at
    the real tokens and its states, and each row's conv window and SSM
    state equal to the port's own solo call on that row's real tokens."""
    jlm, jcfg, jparams, cfg, params = _pair("mamba2-130m")
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    lp = {k: v[0] for k, v in params["layers"].items()}
    lens = np.array([12, 5, 9])
    x, _, _ = _block_inputs(cfg, 4, 3, 12)
    mask = np.arange(12)[None] < lens[:, None]
    jy, (jconv, jssm) = jlm.ssm_block(jlp, jnp.asarray(x), jcfg, pad_mask=jnp.asarray(mask))
    y, (conv, ssm) = lm.ssm_block(lp, torch.from_numpy(x), cfg,
                                  pad_mask=torch.from_numpy(mask))
    _close(y[torch.from_numpy(mask)], np.asarray(jy)[mask], what="y")
    _close(conv, jconv, what="conv")
    _close(ssm, jssm, what="ssm")
    for row, n in enumerate(lens):
        sy, (sconv, sssm) = lm.ssm_block(lp, torch.from_numpy(x[row:row + 1, :n]), cfg)
        _close(conv[row:row + 1], sconv, what=f"row {row} conv")
        _close(ssm[row:row + 1], sssm, what=f"row {row} ssm")
        _close(y[row:row + 1, :n], sy, what=f"row {row} y")


def test_ssm_block_decode_branch_matches_reference_and_continues_the_scan():
    jlm, jcfg, jparams, cfg, params = _pair("mamba2-130m")
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    lp = {k: v[0] for k, v in params["layers"].items()}
    x, conv, ssm = _block_inputs(cfg, 5, 2, 7)
    jy, (jconv, jssm) = jlm.ssm_block(jlp, jnp.asarray(x[:, :1]), jcfg,
                                      conv_state=jnp.asarray(conv), ssm_state=jnp.asarray(ssm))
    y, (nconv, nssm) = lm.ssm_block(lp, torch.from_numpy(x[:, :1]), cfg,
                                    conv_state=torch.from_numpy(conv),
                                    ssm_state=torch.from_numpy(ssm))
    _close(y, jy, what="y")
    _close(nconv, jconv, what="conv")
    _close(nssm, jssm, what="ssm")
    # six tokens scanned, then the seventh decoded == seven tokens scanned
    full, (fconv, fssm) = lm.ssm_block(lp, torch.from_numpy(x), cfg)
    _, (c6, s6) = lm.ssm_block(lp, torch.from_numpy(x[:, :6]), cfg)
    last, (c7, s7) = lm.ssm_block(lp, torch.from_numpy(x[:, 6:]), cfg, conv_state=c6,
                                  ssm_state=s6)
    _close(last, full[:, 6:], what="decoded y")
    _close(c7, fconv, what="decoded conv")
    _close(s7, fssm, what="decoded ssm")


def test_hybrid_local_layers_attend_in_the_window_and_global_ones_without(monkeypatch):
    """Layer 0 is global, layer 1 local (window 64): the serving kernel and
    the training attention get the window of each layer."""
    _, _, _, cfg, params = _pair("hymba-1.5b")
    seen = []
    real_serve, real_train = lm.attention, lm.attention_train
    monkeypatch.setattr(lm, "attention", lambda *a, **kw: (
        seen.append(("serve", kw["window"])), real_serve(*a, **kw))[1])
    monkeypatch.setattr(lm, "attention_train", lambda *a, **kw: (
        seen.append(("train", kw["window"])), real_train(*a, **kw))[1])
    toks = torch.from_numpy(_tokens(np.random.default_rng(6), 1, 8, cfg.vocab_size))
    _, cache = lm.lm_prefill(params, cfg, {"tokens": toks}, 16, cache_dtype=torch.float32)
    lm.serve_step(params, cfg, cache, toks[:, 0], 8)
    lm.lm_forward(params, cfg, {"tokens": toks})
    assert seen == [(kind, w) for kind in ("serve", "serve", "train")
                    for w in (None, cfg.attn_window)]


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True], ids=["equal", "prompt_lens"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name, padded):
    """lm_prefill over 80 tokens (past hymba's window of 64), then four
    serve_steps with a scalar pos or per-slot positions: logits and every
    cache leaf."""
    jlm, jcfg, jparams, cfg, params = _pair(name)
    rng = np.random.default_rng(7)
    b, s = 3, 80
    toks = _tokens(rng, b, s, cfg.vocab_size)
    lens = np.array([80, 37, 70], np.int32) if padded else None
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ,
                                     cache_dtype=jnp.float32,
                                     prompt_lens=None if lens is None else jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert logits.dtype == torch.float32 and logits.shape == (b, cfg.vocab_size)
    _close(logits, jlogits, what="prefill logits")
    assert set(cache) == set(jcache)
    for k in cache:
        _close(cache[k], jcache[k], what=f"prefill {k}")
    pos = lens.copy() if padded else s
    for _ in range(4):
        cur = _tokens(rng, b, 1, cfg.vocab_size)[:, 0]
        jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur),
                                         jnp.asarray(pos) if padded else pos)
        logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur),
                                      torch.from_numpy(pos) if padded else pos)
        _close(logits, jlogits, what="decode logits")
        pos = pos + 1
    for k in cache:
        _close(cache[k], jcache[k], what=f"decode {k}")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_matches_forward(name):
    """Step-by-step decode from an empty cache == the full causal forward,
    as ``tests/test_lm_archs.py:63`` holds the reference (limit 2e-5); the
    hybrid over 72 tokens, so its window of 64 bites."""
    cfg = dataclasses.replace(reduced_config(name), attn_chunk=16)
    _, _, _, _, params = _pair(name)
    b, s = 2, 24 if name == "mamba2-130m" else 72
    toks = torch.from_numpy(_tokens(np.random.default_rng(8), b, s, cfg.vocab_size))
    with torch.no_grad():
        hidden, _ = lm.lm_forward(params, cfg, {"tokens": toks})
        full = hidden @ lm._head_weight(params, cfg)
    cache = lm.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    errs = []
    for t in range(s):
        logits, cache = lm.serve_step(params, cfg, cache, toks[:, t], t)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 2e-5, f"decode diverges from forward: {max(errs)}"


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_prefill_and_decode_match_reference(name):
    """bf16 weights and the engine's f32 cache: logits in bf16 ulps, the
    SSM state f32 and within the same ulps of its largest magnitude."""
    jlm, jcfg, jparams, cfg, params = _pair(name, "bfloat16", seed=1)
    rng = np.random.default_rng(9)
    toks = _tokens(rng, 2, 72, cfg.vocab_size)
    lens = np.array([72, 40], np.int32)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ,
                                     cache_dtype=jnp.float32, prompt_lens=jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "prefill logits", name)
    cur = _tokens(rng, 2, 1, cfg.vocab_size)[:, 0]
    jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur),
                                     jnp.asarray(lens))
    logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur),
                                  torch.from_numpy(lens))
    _close(logits, jlogits, "bfloat16", "decode logits", name)
    assert cache["ssm"].dtype == torch.float32
    # the conv window is returned in the activations' dtype, as the reference's
    assert cache["conv"].dtype == torch.bfloat16 == getattr(torch, str(jcache["conv"].dtype))
    for k in ("ssm", "conv"):
        _close(cache[k], jcache[k], "bfloat16", k, name)


def test_f32_model_in_a_bf16_cache_keeps_the_conv_window_unrounded():
    """The reference returns the conv window in the activations' dtype
    whatever the cache's: an f32 model decoding from a bf16 cache matches
    it to f32 limits."""
    jlm, jcfg, jparams, cfg, params = _pair("mamba2-130m", seed=2)
    rng = np.random.default_rng(10)
    toks = _tokens(rng, 2, 9, cfg.vocab_size)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, 16)
    assert cache["conv"].dtype == torch.float32 and jcache["conv"].dtype == jnp.float32
    cur = _tokens(rng, 2, 1, cfg.vocab_size)[:, 0]
    jlogits, _ = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), 9)
    logits, _ = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), 9)
    _close(logits, jlogits)


# ---------------------------------------------------------------------------
# training: forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_lm_forward_and_loss_match_reference(name, dtype):
    """S = 80: hymba's window bites and the 16-token loss chunks drop
    nothing; 512-token chunks take the whole sequence."""
    jlm, jcfg, jparams, cfg, params = _pair(name, dtype, attn_chunk=32)
    batch = _batch(11, s=80)
    jh, jaux = jlm.lm_forward(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])})
    h, aux = lm.lm_forward(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])})
    assert h.dtype == getattr(torch, dtype) and float(aux) == float(jaux) == 0
    want = _np(jh)
    atol = F32_RTOL * np.abs(want).max() if dtype == "float32" else _bf16_atol(want, name)
    np.testing.assert_allclose(_np(h), want, rtol=0, atol=atol)
    for chunk in (16, 512):
        jloss = float(jlm.lm_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                  chunk))
        loss = lm.lm_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                          chunk)
        assert loss.dtype == torch.float32
        rtol = F32_RTOL if dtype == "float32" else BF16_LOSS_RTOL
        assert float(loss) == pytest.approx(jloss, rel=rtol), chunk


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax_value_and_grad(name):
    """The launcher's loss and every gradient against ``jax.value_and_grad``,
    to GRAD_RTOL of each tensor's largest magnitude; the pure SSM's unused
    ln2 gets zeros, as under jax.grad."""
    jlm, jcfg, jparams, cfg, params = _pair(name, attn_chunk=32)
    batch = _batch(12, s=80)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = train_launcher.loss_and_grads(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL)
    want = _jax_leaves(jgrads)
    assert set(_leaves(grads)) == set(want)
    for k, w in want.items():
        w = _np(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(_np(_leaves(grads)[k]), w, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    if name == "mamba2-130m":
        assert not bool(grads["layers"]["ln2"].any()) and not np.any(want["layers/ln2"])
    for k in ("ssm_in", "ssm_conv_w", "ssm_A", "ssm_D", "ssm_dt_bias", "ssm_out"):
        assert float(grads["layers"][k].abs().max()) > 0, k


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_modes_give_equal_losses_and_gradients(name):
    results = []
    for remat in ("full", "dots", "none"):
        _, _, _, cfg, params = _pair(name, remat=remat)
        results.append(train_launcher.loss_and_grads(
            params, cfg, {k: torch.from_numpy(v) for k, v in _batch(13).items()}))
    (l0, g0), rest = results[0], results[1:]
    for loss, grads in rest:
        assert torch.equal(loss, l0)
        for k, g in _leaves(grads).items():
            assert torch.equal(g, _leaves(g0)[k]), k


def test_dots_remat_saves_the_ssm_projections(monkeypatch):
    """Under "dots" the policy keeps the outputs of the matmuls without batch
    dims, ``ssm_in`` and ``ssm_out`` of every mamba2 layer, as JAX's
    checkpoint_dots_with_no_batch_dims does, and recomputes the SSD's
    batched matmuls."""
    from torch.utils.checkpoint import CheckpointPolicy
    decisions = []
    policy = lm._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        decisions.append((op, decision))
        return decision

    monkeypatch.setattr(lm, "_save_dots", spy)
    _, _, _, cfg, params = _pair("mamba2-130m", remat="dots")
    train_launcher.loss_and_grads(params, cfg,
                                  {k: torch.from_numpy(v) for k, v in _batch(14).items()})
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (2 * cfg.num_layers)
    assert any(op == torch.ops.aten.bmm.default for op, _ in decisions)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

_WORKLOAD = {"mamba2-130m": dict(prompt_lens=(3, 5, 9), new_tokens=(0, 1, 3, 6)),
             "hymba-1.5b": dict(prompt_lens=(3, 9, 70), new_tokens=(0, 1, 3, 6))}


@pytest.fixture(scope="module")
def family_engines():
    """Per family: the reference engine and the port's on the same reduced
    weights."""
    ref = load_reference()
    out = {}
    for name in FAMILIES:
        jcfg = jax_reduced_config(name)
        jparams = ref.lm.init_lm(jax.random.PRNGKey(0), jcfg)
        params = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        cfg = reduced_config(name)
        out[name] = (lambda jp=jparams, jc=jcfg, **kw: ref.engine.ServeEngine(jp, jc, **kw),
                     lambda p=params, c=cfg, **kw: ServeEngine(p, c, device="cpu", **kw),
                     cfg)
    return out


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_serves_the_reference_tokens(family_engines, name, mode):
    ref = load_reference()
    make_ref, make_port, cfg = family_engines[name]
    kw = dict(batch_slots=3, max_seq=MAX_SEQ)
    e_ref, e_port = make_ref(**kw), make_port(**kw)
    done_ref = getattr(e_ref, mode)(ref.loadgen.lm_workload(cfg.vocab_size, 8, seed=2,
                                                            **_WORKLOAD[name]))
    done_port = getattr(e_port, mode)(lm_workload(cfg.vocab_size, 8, seed=2,
                                                  **_WORKLOAD[name]))
    assert len(done_port) == len(done_ref) == 8
    for a, b in zip(done_port, done_ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.output, b.output)
    counts = ("tokens", "prefill_tokens", "decode_steps", "delivered_slot_steps")
    assert {k: e_port.stats[k] for k in counts} == {k: e_ref.stats[k] for k in counts}


def _solo(make_port, reqs, max_seq):
    return [make_port(batch_slots=1, max_seq=max_seq).run(
        [Request(r.prompt.copy(), r.max_new_tokens)])[0].output for r in reqs]


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
@pytest.mark.parametrize("name", FAMILIES)
def test_mixed_batch_matches_solo(family_engines, name, mode):
    """A short prompt batched with longer ones gives exactly the tokens it
    gives alone (``tests/test_serving.py:119-152``)."""
    _, make_port, cfg = family_engines[name]
    reqs = lm_workload(cfg.vocab_size, 6, seed=4, prompt_lens=_WORKLOAD[name]["prompt_lens"],
                       new_tokens=(1, 3, 6))
    solo = _solo(make_port, reqs, MAX_SEQ)
    done = getattr(make_port(batch_slots=4, max_seq=MAX_SEQ), mode)(
        [Request(r.prompt.copy(), r.max_new_tokens) for r in reqs])
    key = lambda r: (tuple(r.prompt.tolist()), r.max_new_tokens)    # noqa: E731
    got = {key(d): d.output.tolist() for d in done}
    assert got == {key(r): s.tolist() for r, s in zip(reqs, solo)}


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_prompt_lens_matches_solo(family_engines, name):
    """Right-padded lm_prefill: the short row's logits and its caches equal
    an unpadded prefill of its prompt, and a decode step from the padded
    cache stays on the solo path (``tests/test_serving.py:155``)."""
    _, make_port, cfg = family_engines[name]
    params = make_port(batch_slots=1, max_seq=8).params
    rng = np.random.default_rng(0)
    short = _tokens(rng, 1, 4, cfg.vocab_size)[0]
    long_ = _tokens(rng, 1, 70, cfg.vocab_size)[0]
    toks = np.zeros((2, 70), np.int32)
    toks[0, :4], toks[1] = short, long_
    lens = torch.tensor([4, 70])
    logits_b, cache_b = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, 80,
                                      cache_dtype=torch.float32, prompt_lens=lens)
    logits_s, cache_s = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(short[None])},
                                      80, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits_b[0]), _np(logits_s[0]), rtol=1e-5, atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(cache_b[k][:, 0]), _np(cache_s[k][:, 0]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    nxt = logits_b.argmax(-1).to(torch.int32)
    step, _ = lm.serve_step(params, cfg, cache_b, nxt, lens.to(torch.int32))
    solo = make_port(batch_slots=1, max_seq=16).run([Request(short, max_new_tokens=2)])[0]
    assert int(step[0].argmax()) == int(solo.output[1])


@pytest.mark.parametrize("name", FAMILIES)
def test_zero_new_tokens_are_returned_on_both_paths(family_engines, name):
    _, make_port, cfg = family_engines[name]
    rng = np.random.default_rng(2)
    for runner in ("run", "run_lockstep"):
        reqs = [Request(_tokens(rng, 1, 5, cfg.vocab_size)[0], max_new_tokens=m)
                for m in (0, 3, 0, 1)]
        eng = make_port(batch_slots=2, max_seq=32)
        done = getattr(eng, runner)(reqs)
        assert len(done) == 4 and sorted(d.output.shape[0] for d in done) == [0, 0, 1, 3]
        assert eng.stats["tokens"] == 4


@pytest.mark.parametrize("name", FAMILIES)
def test_outputs_do_not_depend_on_slot_assignment(family_engines, name):
    """``tests/test_serving.py:228``: greedy outputs are a function of the
    request, not of the slot count, the submission order or the slot."""
    _, make_port, cfg = family_engines[name]
    reqs = lm_workload(cfg.vocab_size, 6, seed=3, prompt_lens=(3, 5, 9),
                       new_tokens=(1, 3, 6))
    key = lambda d: (tuple(d.prompt.tolist()), d.max_new_tokens)    # noqa: E731
    want = {key(d): d.output.tolist() for d in make_port(batch_slots=4, max_seq=32).run(
        [Request(r.prompt.copy(), r.max_new_tokens) for r in reqs])}
    for slots, order in ((1, 1), (2, -1), (3, 1)):
        done = make_port(batch_slots=slots, max_seq=32).run(
            [Request(r.prompt.copy(), r.max_new_tokens) for r in reqs[::order]])
        assert {key(d): d.output.tolist() for d in done} == want


def test_engine_keeps_the_ssm_state_f32_in_a_bf16_cache():
    """The engine's cache scatter casts each leaf to the live cache's
    dtype; the SSM state was made f32 and stays f32 whatever cache_dtype
    is, as the reference's init_cache keeps it."""
    cfg = dataclasses.replace(reduced_config("hymba-1.5b"), param_dtype="bfloat16")
    params = lm.init_lm(0, cfg, device="cpu")
    seen = []
    eng = ServeEngine(params, cfg, batch_slots=2, max_seq=32, device="cpu",
                      cache_dtype=torch.bfloat16)
    real = eng._decode_step

    def spy(cache, cur, pos):
        seen.append({k: v.dtype for k, v in cache.items()})
        return real(cache, cur, pos)

    eng._decode_step = spy
    done = eng.run(lm_workload(cfg.vocab_size, 3, seed=1, new_tokens=(3,)))
    assert len(done) == 3 and seen
    assert all(d["ssm"] == torch.float32 and d["k"] == torch.bfloat16 for d in seen)


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_launchers_serve_and_train_both_families_on_the_cpu(name, capsys, tmp_path):
    done = serve_launcher.main(["--device", "cpu", "--arch", name, "--requests", "4"])
    assert len(done) == 4 and all(r.output is not None for r in done)
    done = serve_launcher.main(["--device", "cpu", "--arch", name, "--requests", "3",
                                "--lockstep"])
    assert len(done) == 3
    out = capsys.readouterr().out
    assert "lm: 4 completed" in out and "lm/lockstep: 3 completed" in out
    losses = train_launcher.main(["--arch", name, "--device", "cpu", "--steps", "3",
                                  "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "device cpu" in capsys.readouterr().out


def test_pretrain_example_runs_mamba2_on_the_cpu(tmp_path, capsys):
    """Compressed gradients (the codec's plain versions here) and a lossy
    checkpoint of the SSM family."""
    spec = importlib.util.spec_from_file_location(
        "lm_pretrain_torch", ROOT / "examples" / "lm_pretrain_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    losses = example.main(["--arch", "mamba2-130m", "--device", "cpu", "--steps", "3",
                           "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "lossy checkpoint" in capsys.readouterr().out
