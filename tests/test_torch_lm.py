"""The port's dense LM against the JAX package's ``repro/models/lm.py``.

The reference is imported through ``torch_lm_reference`` (it does not
import under jax 0.9 otherwise; ROADMAP Queue 3, R1).  Weights come from
the reference's ``init_lm`` through ``params_from_jax``; tokens are made
with numpy.  Three reduced dense configs cover the family's features:
``internlm2-1.8b`` (GQA), ``codeqwen1.5-7b`` (qkv bias, given random
values here) and ``command-r-35b`` (tied embeddings).  Everything runs in
f32, where the only differences are summation orders: logits and caches
are held to atol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config

from repro_torch.configs import ALL_ARCHS, get_config, reduced_config
from repro_torch.models import lm

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

ATOL = 1e-4
DENSE = ("internlm2-1.8b", "codeqwen1.5-7b", "command-r-35b")
NOT_DENSE = ("seamless-m4t-large-v2", "internvl2-2b")
MAX_SEQ = 32


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _model_pair(name, seed=0):
    """(reference lm, JAX cfg, JAX params, port cfg, port params)."""
    jlm = load_reference().lm
    jcfg = jax_reduced_config(name)
    jparams = jax.tree_util.tree_map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed), jcfg))
    if jcfg.qkv_bias:        # the init's zero biases would test nothing
        rng = np.random.default_rng(seed + 100)
        for b in ("bq", "bk", "bv"):
            jparams["layers"][b] = (0.1 * rng.standard_normal(
                jparams["layers"][b].shape)).astype(np.float32)
    jparams_j = jax.tree_util.tree_map(jnp.asarray, jparams)
    return jlm, jcfg, jparams_j, reduced_config(name), lm.params_from_jax(jparams, "cpu")


def _tokens(rng, b, s, vocab):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def test_configs_are_the_reference_configs():
    assert ALL_ARCHS == JAX_ARCHS
    for name in ALL_ARCHS:
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name))
        assert dataclasses.asdict(reduced_config(name)) == \
            dataclasses.asdict(jax_reduced_config(name))


def test_param_count_matches_reference():
    jlm = load_reference().lm
    for name in DENSE + ("qwen2.5-14b",):
        assert lm.param_count(get_config(name)) == jlm.param_count(jax_get_config(name))
        assert lm.param_count(reduced_config(name)) == \
            jlm.param_count(jax_reduced_config(name))
    assert lm.param_count(get_config("internlm2-1.8b")) == 1_889_110_016


@pytest.mark.parametrize("name", DENSE)
def test_init_has_the_reference_layout(name):
    jlm = load_reference().lm
    want = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0),
                                              jax_reduced_config(name)))
    got = lm.init_lm(torch.Generator().manual_seed(0), reduced_config(name))
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in ("embed", "final_norm") + (("lm_head",) if "lm_head" in want else ()):
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32
    for k, v in want["layers"].items():
        assert tuple(got["layers"][k].shape) == v.shape, k
    cfg = reduced_config(name)
    assert float(got["layers"]["wq"].std()) == pytest.approx(cfg.d_model ** -0.5, rel=0.1)
    assert float(got["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert bool((got["layers"]["ln1"] == 1).all())
    again = lm.init_lm(0, cfg, device="cpu")
    assert torch.equal(again["layers"]["w_up"], got["layers"]["w_up"])


def test_params_from_jax_round_trip():
    _, _, jparams, _, params = _model_pair("command-r-35b")
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        {k: v for k, v in params.items()}))
    for path, leaf in flat_j:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)), jnp.bfloat16)
    t = lm.params_from_jax({"w": np.asarray(bf)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(bf, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_swiglu_match_reference(dtype):
    jlm = load_reference().lm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32) * 3
    g = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    tt, jt = getattr(torch, dtype), getattr(jnp, dtype)
    atol = ATOL if dtype == "float32" else 3e-2
    np.testing.assert_allclose(
        _np(lm.rmsnorm(torch.from_numpy(g).to(tt), torch.from_numpy(x).to(tt), 1e-6)),
        _np(jlm.rmsnorm(jnp.asarray(g, jt), jnp.asarray(x, jt), 1e-6)), atol=atol)
    got = lm.rope(torch.from_numpy(x).to(tt), torch.from_numpy(pos), 1e4)
    assert got.dtype == tt
    np.testing.assert_allclose(_np(got), _np(jlm.rope(jnp.asarray(x, jt), jnp.asarray(pos),
                                                      1e4)), atol=atol * 10)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((32, 64), (32, 64),
                                                                    (64, 32))]
    np.testing.assert_allclose(
        _np(lm.swiglu(torch.from_numpy(h), *map(torch.from_numpy, ws))),
        _np(jlm.swiglu(jnp.asarray(h), *map(jnp.asarray, ws))), atol=ATOL)


@pytest.mark.parametrize("name", DENSE)
def test_attn_block_matches_reference(name):
    jlm, jcfg, jparams, cfg, params = _model_pair(name)
    rng = np.random.default_rng(2)
    b, s = 3, 6
    x = (rng.standard_normal((b, s, cfg.d_model)) * 0.5).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    lp = {k: v[0] for k, v in params["layers"].items()}
    positions = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    # no cache (training / encoder form)
    jy, _ = jlm.attn_block(jlp, jnp.asarray(x), jcfg, jnp.asarray(positions))
    y, _ = lm.attn_block(lp, torch.from_numpy(x), cfg, torch.from_numpy(positions))
    np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL)
    # scalar cache position (prefill at 0, then a chunk at 6)
    ck = np.zeros((b, MAX_SEQ, cfg.num_kv_heads, cfg.hdim), np.float32)
    jkv = (jnp.asarray(ck), jnp.asarray(ck))
    kv = (torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy()))
    for start in (0, s):
        pos = positions + start
        jy, jkv = jlm.attn_block(jlp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 kv_cache=jkv, cache_pos=start)
        y, kv = lm.attn_block(lp, torch.from_numpy(x), cfg, torch.from_numpy(pos),
                              kv_cache=kv, cache_pos=start)
        np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL)
        for a, ja in zip(kv, jkv):
            np.testing.assert_allclose(_np(a), _np(ja), atol=ATOL)
    # per-slot positions, one token each
    cpos = np.array([12, 3, 20], np.int32)
    x1 = x[:, :1]
    jy, jkv = jlm.attn_block(jlp, jnp.asarray(x1), jcfg, jnp.asarray(cpos[:, None]),
                             kv_cache=jkv, cache_pos=jnp.asarray(cpos))
    y, kv = lm.attn_block(lp, torch.from_numpy(x1), cfg, torch.from_numpy(cpos[:, None]),
                          kv_cache=kv, cache_pos=torch.from_numpy(cpos))
    np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL)
    for a, ja in zip(kv, jkv):
        np.testing.assert_allclose(_np(a), _np(ja), atol=ATOL)


@pytest.mark.parametrize("name", DENSE)
@pytest.mark.parametrize("padded", [False, True], ids=["equal", "prompt_lens"])
def test_prefill_and_decode_match_reference(name, padded):
    """lm_prefill, then serve_step with a scalar pos (equal prompts) or a
    per-slot vector pos (right-padded prompts), logits and caches."""
    jlm, jcfg, jparams, cfg, params = _model_pair(name)
    rng = np.random.default_rng(3)
    b, s = 3, 9
    toks = _tokens(rng, b, s, cfg.vocab_size)
    lens = np.array([9, 4, 6], np.int32) if padded else None
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ,
                                     cache_dtype=jnp.float32,
                                     prompt_lens=None if lens is None else jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert logits.dtype == torch.float32 and logits.shape == (b, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]), atol=ATOL)
    pos = lens.copy() if padded else s
    for _ in range(3):
        cur = _tokens(rng, b, 1, cfg.vocab_size)[:, 0]
        jp = jnp.asarray(pos) if padded else pos
        jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur), jp)
        tp = torch.from_numpy(pos) if padded else pos
        logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur), tp)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL)
        pos = pos + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache[k]), _np(jcache[k]), atol=ATOL)


def test_bf16_cache_prefill_matches_reference():
    """The reference prefill's default bf16 cache: keys and values are
    rounded on their way into the cache and attention reads them back."""
    jlm, jcfg, jparams, cfg, params = _model_pair("internlm2-1.8b", seed=1)
    toks = _tokens(np.random.default_rng(5), 2, 7, cfg.vocab_size)
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ)
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ)
    assert cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL)
    np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]), atol=1e-2)


@pytest.mark.parametrize("param_dtype,cache_dtype,fresh", [
    ("bfloat16", torch.float32, True),     # the serving engine's prefill
    ("bfloat16", torch.bfloat16, True),
    ("float32", torch.float32, True),
    ("float32", torch.bfloat16, False),    # f32 k rounded by a bf16 cache
])
def test_attn_block_at_position_0_attends_to_the_fresh_kv(monkeypatch, param_dtype,
                                                          cache_dtype, fresh):
    """From cache_pos 0 attention gets the fresh k, v (in k's dtype) where
    the cache holds them without loss: bit for bit the cache views' values,
    and the same output.  Elsewhere, and at any other position, it reads the
    cache views."""
    cfg = dataclasses.replace(reduced_config("internlm2-1.8b"), param_dtype=param_dtype)
    params = lm.init_lm(0, cfg, device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    b, s, dt = 2, 5, getattr(torch, param_dtype)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to(dt)
    positions = torch.arange(s, dtype=torch.int32).expand(b, s)
    shape = (b, MAX_SEQ, cfg.num_kv_heads, cfg.hdim)
    ck, cv = torch.zeros(shape, dtype=cache_dtype), torch.zeros(shape, dtype=cache_dtype)
    real, seen = lm.attention, []

    def spy(q, k, v, **kw):
        seen.append((k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(lm, "attention", spy)
    y, _ = lm.attn_block(lp, x, cfg, positions, kv_cache=(ck, cv), cache_pos=0)
    k, v = seen[-1]
    assert (k.data_ptr() != ck.data_ptr()) == fresh and k.shape == (b, s) + shape[2:]
    if fresh:
        assert k.dtype == dt and v.dtype == dt
    for got, cache in ((k, ck), (v, cv)):
        assert torch.equal(got.to(dt), cache[:, :s].to(dt))
    # the output is the one attention over the cache views gives
    monkeypatch.setattr(lm, "attention", lambda q, k, v, **kw: real(
        q, ck[:, :k.shape[1]], cv[:, :v.shape[1]], **kw))
    y_views, _ = lm.attn_block(lp, x, cfg, positions, kv_cache=(ck, cv), cache_pos=0)
    assert torch.equal(y, y_views)
    monkeypatch.setattr(lm, "attention", spy)
    lm.attn_block(lp, x, cfg, positions + s, kv_cache=(ck, cv), cache_pos=s)
    k, v = seen[-1]
    assert k.data_ptr() == ck.data_ptr() and k.shape[1] == 2 * s


@pytest.mark.parametrize("name", NOT_DENSE)
def test_other_families_raise_naming_the_roadmap(name):
    """The VLM and encoder-decoder families, which raised naming their
    ROADMAP item until they were ported, now run: init_lm, init_cache,
    param_count and lm_prefill on the reduced config, with the reference's
    count and cache layout (their values are held to the reference in
    tests/test_torch_lm_vlm.py and tests/test_torch_lm_encdec.py)."""
    jlm = load_reference().lm
    cfg, jcfg = reduced_config(name), jax_reduced_config(name)
    params = lm.init_lm(0, cfg, device="cpu")
    assert lm.param_count(cfg) == jlm.param_count(jcfg) == \
        sum(t.numel() for t in jax.tree_util.tree_leaves(params))
    enc_seq = 5 if cfg.encoder_layers else 0
    cache = lm.init_cache(cfg, 1, 8, device="cpu", enc_seq=enc_seq)
    want = jlm.init_cache(jcfg, 1, 8, enc_seq=enc_seq)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in want.items()}
    batch = {"tokens": torch.zeros(1, 2, dtype=torch.int32)}
    if cfg.encoder_layers:
        batch["encoder_embeds"] = torch.ones(1, enc_seq, cfg.frontend_dim)
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.ones(1, cfg.frontend_seq, cfg.frontend_dim)
    logits, cache = lm.lm_prefill(params, cfg, batch, cfg.frontend_seq + 8)
    assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert set(cache) == set(want)


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_count_matches_reference_for_every_arch(name):
    """Every config of the registry, full and reduced: the port's count is
    the reference's, and so is the count of active parameters."""
    jlm = load_reference().lm
    for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
        assert lm.param_count(get(name)) == jlm.param_count(jget(name))
        assert lm.active_param_count(get(name)) == jlm.active_param_count(jget(name))
