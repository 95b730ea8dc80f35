"""The port's MoE LM family against the JAX package's ``repro/models/lm.py``
and ``repro/serving/engine.py``.

The reference is imported through ``torch_lm_reference`` (it does not
import under jax 0.9 otherwise; ROADMAP Queue 3, R1).  Weights come from
the reference's ``init_lm`` through ``params_from_jax``; every input is
made with numpy from a seed.  The configs are ``reduced_config``'s
``qwen3-moe-30b-a3b`` (2 layers, d 128, 4 q heads over 1 KV head, 8
experts of ff 64, top 4, ``moe_group`` 64) and ``arctic-480b`` (7 q heads
over 1, 8 experts of ff 152, top 2, the dense residual MLP at 128).

Tolerances.  ``moe_block`` alone, on the same inputs, differs from the
reference only in summation order: f32 to ``F32_RTOL`` of ``max|y|``, its
load-balance loss to ``AUX_RTOL``; bf16 to ``BF16_ULPS`` bf16 ulps of the
output's largest magnitude.  Through a whole model it is otherwise: the
reference's dispatch rounds every token, routing weight and their
cotangents to bf16, so an f32 difference upstream of a layer (attention
and norms sum in other orders) moves a rounded value by one bf16 ulp
wherever it sits at a rounding midpoint.  The reference differs from
itself so, jitted against op by op (``jax.disable_jit``;
``test_the_reference_differs_from_itself_by_bf16_roundings``).  So f32
hidden states and caches are held to ``F32_MOE_ULPS`` bf16 ulps of each
tensor's largest magnitude, losses to ``F32_RTOL``.  Gradients are held to
``MOE_GRAD_RTOL`` of each tensor's largest magnitude, between what sound
code reads and what a fault reads: over seeds 12-18 of ``_batch`` on both
configs the reference against itself read at most 3.0e-3 and the port
against the reference 4.7e-3, while the port with its expert products in
bf16 (an f32 config computed as a bf16 one) read at least 1.49e-2
(``test_the_reference_gradients_differ_from_themselves``,
``test_bf16_expert_products_fail_the_gradient_limit``).  In bf16 the
router's scores are themselves bf16 products, and a near tie flips an
expert at a few percent of the tokens, the reference against itself
included.  The port is held to the reference run op by op (where each op
rounds to bf16, as PyTorch's do): at least ``BF16_ROWS`` of the tokens
within ``BF16_ULPS_FORWARD`` ulps, the loss to ``BF16_LOSS_RTOL``.
Routing itself is compared exactly: the selected experts equal
``jax.lax.top_k``'s, ties included; and served tokens equal the reference
engine's.
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
from torch.utils.checkpoint import CheckpointPolicy

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
FAMILIES = ("qwen3-moe-30b-a3b", "arctic-480b")
F32_RTOL = 1e-5
AUX_RTOL = 1e-6
F32_MOE_ULPS = 1
MOE_GRAD_RTOL = 8e-3
BF16_ULPS = 2
BF16_ULPS_FORWARD = 4
BF16_ROWS = 0.97
BF16_LOSS_RTOL = 2e-3
MAX_SEQ = 96
B, S = 2, 96                # 192 tokens: three groups of moe_group = 64


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


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


def _layer0(jparams, params):
    return (jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]),
            {k: v[0] for k, v in params["layers"].items()})


def _bf16_atol(want, ulps) -> float:
    return ulps * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _close_rel(got, want, rtol, what=""):
    """|got - want| within ``rtol`` of want's largest magnitude."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def _grad_spread(got, want) -> float:
    """The worst over leaves of max |got - want| / max |want|."""
    return max(float(np.abs(_np(got[k]) - _np(w)).max() / np.abs(_np(w)).max())
               for k, w in want.items())


def _close_ulps(got, want, ulps, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=_bf16_atol(want, ulps),
                               err_msg=what)


def _tokens(rng, b, s, vocab):
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _batch(seed, b=B, s=S, vocab=512):
    toks = _tokens(np.random.default_rng(seed), b, s, vocab)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _block_input(cfg, seed, b, s, toward=None, lp=None):
    """(b, s, D) f32 activations; with ``toward`` every token leans to
    that expert's router column, so its queue overflows the capacity."""
    x = np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if toward is not None:
        col = _np(lp["router"])[:, toward]
        x += 4.0 * col / np.linalg.norm(col) ** 2
    return x


def _jax_routing(jlm, jlp, x, jcfg):
    """The reference's experts per token and the tokens it drops, computed
    with its own ops (lm.py:332-358)."""
    e, k = jcfg.num_experts, jcfg.experts_per_token
    n = x.shape[0] * x.shape[1]
    g = min(jcfg.moe_group, n)
    cap = max(int(math.ceil(g * k / e * jcfg.capacity_factor)), 4)
    logits = jnp.einsum("gnd,de->gne", jnp.asarray(x).reshape(n // g, g, -1),
                        jlp["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits.astype(jnp.bfloat16).astype(jnp.float32), -1)
    _, ids = jax.lax.top_k(probs, k)
    eoh = jax.nn.one_hot(ids, e, dtype=jnp.int32)
    pos = (jnp.cumsum(eoh.reshape(n // g, g * k, e), 1).reshape(eoh.shape) - eoh)
    dropped = int(jnp.sum(jnp.sum(pos * eoh, -1) >= cap))
    return np.asarray(ids), dropped


# ---------------------------------------------------------------------------
# parameters and counts
# ---------------------------------------------------------------------------

def test_param_counts_match_reference():
    jlm = load_reference().lm
    for name in FAMILIES:
        for get, jget in ((get_config, jax_get_config), (reduced_config, jax_reduced_config)):
            assert lm.param_count(get(name)) == jlm.param_count(jget(name))
            assert lm.active_param_count(get(name)) == jlm.active_param_count(jget(name))
        _, _, jparams, cfg, params = _pair(name)
        assert count_params(params) == jax_count_params(jparams) == lm.param_count(cfg)
    assert lm.param_count(get_config("qwen3-moe-30b-a3b")) == 30_532_110_336
    assert lm.active_param_count(get_config("qwen3-moe-30b-a3b")) == 3_353_018_368
    assert lm.param_count(get_config("arctic-480b")) == 478_584_357_888
    assert lm.param_count(dataclasses.replace(get_config("arctic-480b"), num_layers=2)) \
        == 27_780_221_952


@pytest.mark.parametrize("name", FAMILIES)
def test_init_has_the_reference_layout_and_scales(name):
    """bf16: the reference's leaves, shapes and dtypes; N(0, 1/E) experts
    (fan-in is each leaf's first axis, E, as the reference takes it),
    N(0, 1/D) router; params_from_jax carries every MoE leaf across
    bit for bit."""
    jlm = load_reference().lm
    jcfg = dataclasses.replace(jax_reduced_config(name), param_dtype="bfloat16")
    cfg = dataclasses.replace(reduced_config(name), param_dtype="bfloat16")
    want = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    got = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k, w in _jax_leaves(want).items():
        g = _leaves(got)[k]
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype), k
    layers = got["layers"]
    assert {"router", "e_gate", "e_up", "e_down"} <= set(layers)
    assert ("w_gate" in layers) == bool(cfg.moe_dense_ff)
    for leaf in ("e_gate", "e_up", "e_down"):
        assert float(layers[leaf].float().std()) == pytest.approx(
            cfg.num_experts ** -0.5, rel=0.1), leaf
    assert float(layers["router"].float().std()) == pytest.approx(cfg.d_model ** -0.5,
                                                                   rel=0.1)
    carried = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, want), "cpu")
    for k, w in _jax_leaves(want).items():
        c = _leaves(carried)[k]
        assert c.dtype == torch.bfloat16 and np.array_equal(
            c.view(torch.int16).numpy(), np.asarray(w).view(np.int16)), k


def test_init_draws_each_leaf_in_slabs(monkeypatch):
    """No f32 draw is larger than ``_DRAW_SLAB`` values, each leaf is made
    in the config's dtype, and the values keep their scale across slabs."""
    monkeypatch.setattr(lm, "_DRAW_SLAB", 1000)
    sizes = []
    real = torch.randn

    def spy(*args, **kw):
        out = real(*args, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", spy)
    cfg = dataclasses.replace(reduced_config("qwen3-moe-30b-a3b"), param_dtype="bfloat16")
    params = lm.init_lm(0, cfg, device="cpu")
    assert max(sizes) == 1000 and len(sizes) > 100
    assert all(t.dtype == torch.bfloat16 for t in _leaves(params).values())
    e_gate = params["layers"]["e_gate"].float()
    assert float(e_gate.std()) == pytest.approx(cfg.num_experts ** -0.5, rel=0.05)
    assert float(e_gate[1].std()) == pytest.approx(cfg.num_experts ** -0.5, rel=0.05)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _tied_rows(kind):
    rng = np.random.default_rng(1)
    if kind == "all_tied":
        p = np.full((4, 128), 1 / 128, np.float32)
        p[1, 100] = 0.5                                  # one above the ties
        return p
    if kind == "partly_tied":
        p = rng.integers(0, 6, (64, 128)).astype(np.float32) / 8
        return p
    logits = rng.standard_normal((4096, 128)).astype(np.float32)
    snapped = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    return np.asarray(jax.nn.softmax(jnp.asarray(snapped), -1))


@pytest.mark.parametrize("kind", ["all_tied", "partly_tied", "bf16_snapped_softmax"])
def test_top_k_is_jax_top_k_ties_included(kind):
    p = _tied_rows(kind)
    jv, ji = jax.lax.top_k(jnp.asarray(p), 8)
    v, i = lm.top_k(torch.from_numpy(p), 8)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    if kind == "all_tied":
        assert i[0].tolist() == list(range(8)) and i[1].tolist() == [100] + list(range(7))


@pytest.mark.parametrize("router", ["zeros", "two_values"])
def test_tied_routers_choose_the_reference_experts(router):
    """A router whose scores tie for every token (zeros: experts 0..k-1)
    or in blocks: the block's output is the reference's, which it would
    not be with another tie order."""
    jlm, jcfg, jparams, cfg, params = _pair("qwen3-moe-30b-a3b")
    jlp, lp = _layer0(jparams, params)
    r = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    if router == "two_values":
        r[:, 2::3] = 0.05
    jlp = {**jlp, "router": jnp.asarray(r)}
    lp = {**lp, "router": torch.from_numpy(r)}
    x = np.abs(_block_input(cfg, 2, 1, 16))
    ids, _ = _jax_routing(jlm, jlp, x, jcfg)
    if router == "zeros":
        assert (ids == np.arange(cfg.experts_per_token)).all()
    jy, jaux = jlm.moe_block(jlp, jnp.asarray(x), jcfg)
    y, aux = lm.moe_block(lp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=0,
                               atol=F32_RTOL * np.abs(_np(jy)).max())
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

# (name, B, S, expert the tokens lean to): one group; three groups with an
# overflowing expert (tokens dropped at the default capacity); Arctic's
# dense residual with drops
BLOCK_CASES = [("qwen3-moe-30b-a3b", 1, 40, None), ("qwen3-moe-30b-a3b", 3, 64, 0),
               ("arctic-480b", 2, 64, 5)]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=["one_group", "groups_drop",
                                                   "arctic_residual"])
def test_moe_block_matches_reference_f32(case):
    name, b, s, toward = case
    jlm, jcfg, jparams, cfg, params = _pair(name)
    jlp, lp = _layer0(jparams, params)
    x = _block_input(cfg, 3, b, s, toward, lp)
    ids, dropped = _jax_routing(jlm, jlp, x, jcfg)
    assert (dropped > 0) == (toward is not None)
    jy, jaux = jlm.moe_block(jlp, jnp.asarray(x), jcfg)
    y, aux = lm.moe_block(lp, torch.from_numpy(x), cfg)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32 and aux.dim() == 0
    want = _np(jy)
    np.testing.assert_allclose(_np(y), want, rtol=0, atol=F32_RTOL * np.abs(want).max())
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)


@pytest.mark.parametrize("case", BLOCK_CASES, ids=["one_group", "groups_drop",
                                                   "arctic_residual"])
def test_moe_block_matches_reference_bf16(case):
    name, b, s, toward = case
    jlm, jcfg, jparams, cfg, params = _pair(name, "bfloat16", seed=1)
    jlp, lp = _layer0(jparams, params)
    x = _block_input(cfg, 4, b, s, toward, {k: v.float() for k, v in lp.items()})
    jy, jaux = jlm.moe_block(jlp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, aux = lm.moe_block(lp, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    want = _np(jy)
    np.testing.assert_allclose(_np(y), want, rtol=0, atol=_bf16_atol(want, BF16_ULPS))
    assert float(aux) == pytest.approx(float(jaux), rel=AUX_RTOL)


def test_moe_block_gradients_match_jax_grad():
    """Every input's gradient of <y, c> + aux against jax.grad, f32 with
    drops: the router's through the bf16 snap, the tokens' through the
    bf16 dispatch, the routing weights' through the bf16 combine.  A
    combine cotangent at a bf16 rounding midpoint, summed in another order
    by each package, rounds to neighbouring bf16 values: held to
    MOE_GRAD_RTOL of each gradient's largest magnitude."""
    jlm, jcfg, jparams, cfg, params = _pair("qwen3-moe-30b-a3b")
    jlp, lp = _layer0(jparams, params)
    names = ("router", "e_gate", "e_up", "e_down")
    x = _block_input(cfg, 5, 3, 64, 1, lp)
    c = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jf(ws, xx):
        y, aux = jlm.moe_block({**jlp, **ws}, xx, jcfg)
        return jnp.sum(y * c) + aux

    jg, jgx = jax.grad(jf, argnums=(0, 1))({n: jlp[n] for n in names}, jnp.asarray(x))
    ws = {n: lp[n].clone().requires_grad_() for n in names}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = lm.moe_block({**lp, **ws}, xt, cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum() + aux,
                                [*ws.values(), xt])
    for what, g, w in zip(names + ("x",), grads, [*(jg[n] for n in names), jgx]):
        _close_rel(g, w, MOE_GRAD_RTOL, what)


def test_snap_rounds_the_cotangent_through_bf16():
    """``.to(bf16).float()`` rounds the cotangent to bf16 on its way back,
    as the transpose of JAX's convert_element_type pair does."""
    x = np.random.default_rng(7).standard_normal(64).astype(np.float32)
    c = (1 + np.random.default_rng(8).random(64) * 1e-2).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad((t.to(torch.bfloat16).float() * torch.from_numpy(c)).sum(), t)
    jg = jax.grad(lambda v: jnp.sum(v.astype(jnp.bfloat16).astype(jnp.float32) * c))(
        jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert not np.array_equal(g.numpy(), c)
    np.testing.assert_array_equal(g.numpy(), _np(torch.from_numpy(c).to(torch.bfloat16)))


@pytest.mark.parametrize("n", [40, 64, 96, 128, 150, 192])
def test_both_packages_refuse_the_same_group_reshape(n):
    """B*S above moe_group and not a multiple of it: JAX's reshape fails;
    the port names the rule."""
    jlm, jcfg, jparams, cfg, params = _pair("qwen3-moe-30b-a3b")
    jlp, lp = _layer0(jparams, params)
    x = _block_input(cfg, 9, 1, n)
    ok = n <= cfg.moe_group or n % cfg.moe_group == 0
    if ok:
        jlm.moe_block(jlp, jnp.asarray(x), jcfg)
        lm.moe_block(lp, torch.from_numpy(x), cfg)
    else:
        with pytest.raises(TypeError):
            jlm.moe_block(jlp, jnp.asarray(x), jcfg)
        with pytest.raises(ValueError, match="multiple of it"):
            lm.moe_block(lp, torch.from_numpy(x), cfg)


# ---------------------------------------------------------------------------
# training: forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_lm_forward_aux_and_loss_match_reference(name, dtype):
    """f32: hidden states against the jitted reference to F32_MOE_ULPS, the
    summed load-balance loss and the loss (cross-entropy + 0.01 aux) to
    F32_RTOL.  bf16: against the reference run op by op, BF16_ROWS of the
    tokens' hidden states within BF16_ULPS_FORWARD ulps, the loss to
    BF16_LOSS_RTOL (see the module docstring)."""
    jlm, jcfg, jparams, cfg, params = _pair(name, dtype, attn_chunk=40)
    batch = _batch(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    h, aux = lm.lm_forward(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])})
    assert h.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    losses = [lm.lm_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, c)
              for c in (32, 512)]
    if dtype == "float32":
        jh, jaux = jlm.lm_forward(jparams, jcfg, {"tokens": jbatch["tokens"]})
        _close_ulps(h, jh, F32_MOE_ULPS)
        assert float(aux) > 0 and float(aux) == pytest.approx(float(jaux), rel=F32_RTOL)
        for c, loss in zip((32, 512), losses):
            assert float(loss) == pytest.approx(float(jlm.lm_loss(jparams, jcfg, jbatch, c)),
                                                rel=F32_RTOL), c
        return
    with jax.disable_jit():
        jh, jaux = jlm.lm_forward(jparams, jcfg, {"tokens": jbatch["tokens"]})
        jlosses = [float(jlm.lm_loss(jparams, jcfg, jbatch, c)) for c in (32, 512)]
    want = _np(jh)
    rows = np.abs(_np(h) - want).max(-1) <= _bf16_atol(want, BF16_ULPS_FORWARD)
    assert rows.mean() >= BF16_ROWS, rows.mean()
    assert float(aux) == pytest.approx(float(jaux), rel=BF16_LOSS_RTOL)
    for loss, jloss in zip(losses, jlosses):
        assert float(loss) == pytest.approx(jloss, rel=BF16_LOSS_RTOL)


def test_the_reference_differs_from_itself_by_bf16_roundings():
    """Why model-level values are held in bf16 ulps: the reference jitted
    against itself run op by op (``jax.disable_jit``), same inputs.  Its
    f32 hidden states differ by more than 1e-4 of their largest magnitude
    (within F32_MOE_ULPS bf16 ulps of it); its bf16 hidden states differ by
    more than BF16_ULPS_FORWARD ulps at a few percent of the tokens (an
    expert flipped at a near tie)."""
    for name, dtype in (("arctic-480b", "float32"), ("qwen3-moe-30b-a3b", "bfloat16")):
        jlm, jcfg, jparams, _, _ = _pair(name, dtype, attn_chunk=40)
        toks = jnp.asarray(_batch(11)["tokens"])
        jit, _ = jlm.lm_forward(jparams, jcfg, {"tokens": toks})
        with jax.disable_jit():
            op_by_op, _ = jlm.lm_forward(jparams, jcfg, {"tokens": toks})
        want, got = _np(op_by_op), _np(jit)
        if dtype == "float32":
            assert np.abs(got - want).max() > 1e-4 * np.abs(want).max()
            _close_ulps(got, want, F32_MOE_ULPS)
        else:
            rows = np.abs(got - want).max(-1) <= _bf16_atol(want, BF16_ULPS_FORWARD)
            assert 0.9 < rows.mean() < 1.0, rows.mean()


def _reference_grads(name, batch, jit=True):
    jlm, jcfg, jparams, cfg, params = _pair(name, attn_chunk=40)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if jit:
        return jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jbatch)[1], cfg, params
    with jax.disable_jit():
        return jax.value_and_grad(jlm.lm_loss)(jparams, jcfg, jbatch)[1], cfg, params


@pytest.mark.parametrize("name", FAMILIES)
def test_the_reference_gradients_differ_from_themselves(name):
    """Why gradients are held to MOE_GRAD_RTOL and not the dense family's
    1e-4: the reference's gradients jitted against op by op, same inputs,
    differ by more than 1e-4 of a tensor's largest magnitude, within
    MOE_GRAD_RTOL."""
    batch = _batch(12)
    jit, _, _ = _reference_grads(name, batch)
    op_by_op, _, _ = _reference_grads(name, batch, jit=False)
    spread = _grad_spread(_jax_leaves(jit), _jax_leaves(op_by_op))
    assert 1e-4 < spread <= MOE_GRAD_RTOL, spread


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_expert_products_fail_the_gradient_limit(name, monkeypatch):
    """The limit finds a fault: the f32 config with its expert products
    computed in bf16 (the expert leaves cast down on their way into
    moe_block) is further than MOE_GRAD_RTOL from the reference."""
    batch = _batch(12)
    jgrads, cfg, params = _reference_grads(name, batch)
    block = lm.moe_block
    monkeypatch.setattr(lm, "moe_block", lambda lp, x, c: block(
        {**lp, **{k: lp[k].to(torch.bfloat16) for k in ("e_gate", "e_up", "e_down")}}, x, c))
    _, grads = train_launcher.loss_and_grads(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _grad_spread(_leaves(grads), _jax_leaves(jgrads)) > MOE_GRAD_RTOL


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax_value_and_grad(name, remat):
    """The launcher's loss (cross-entropy + 0.01 aux) and every gradient
    against ``jax.value_and_grad`` under the same remat, the loss to
    F32_RTOL and each gradient to MOE_GRAD_RTOL of its tensor's largest
    magnitude; the router and experts move."""
    jlm, jcfg, jparams, cfg, params = _pair(name, attn_chunk=40, remat=remat)
    batch = _batch(12)
    jloss, jgrads = jax.value_and_grad(jlm.lm_loss)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = train_launcher.loss_and_grads(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=F32_RTOL)
    want = _jax_leaves(jgrads)
    assert set(_leaves(grads)) == set(want)
    for k, w in want.items():
        _close_rel(_leaves(grads)[k], w, MOE_GRAD_RTOL, k)
    for k in ("router", "e_gate", "e_up", "e_down"):
        assert float(grads["layers"][k].abs().max()) > 0, k


def test_dots_remat_saves_the_router_and_projections(monkeypatch):
    """Under "dots" the policy keeps the products without batch dims (the
    attention projections, the router and Arctic's dense residual) and
    recomputes the batched dispatch, expert and combine products, as JAX's
    checkpoint_dots_with_no_batch_dims does."""
    decisions = []
    policy = lm._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        decisions.append((op, decision))
        return decision

    monkeypatch.setattr(lm, "_save_dots", spy)
    for name, per_layer in (("qwen3-moe-30b-a3b", 5), ("arctic-480b", 8)):
        decisions.clear()
        _, _, _, cfg, params = _pair(name, remat="dots")
        train_launcher.loss_and_grads(params, cfg,
                                      {k: torch.from_numpy(v) for k, v in _batch(14).items()})
        saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
        assert saved == [torch.ops.aten.mm.default] * (per_layer * cfg.num_layers), name
        bmm = [d for op, d in decisions if op == torch.ops.aten.bmm.default]
        assert bmm and all(d == CheckpointPolicy.PREFER_RECOMPUTE for d in bmm), name


# ---------------------------------------------------------------------------
# serving: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True], ids=["equal", "prompt_lens"])
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name, padded):
    """lm_prefill over 3 x 64 tokens (three groups; pads routed too), then
    four serve_steps with a scalar pos or per-slot positions, at the
    default capacity: logits and every cache leaf, to F32_MOE_ULPS."""
    jlm, jcfg, jparams, cfg, params = _pair(name)
    rng = np.random.default_rng(7)
    b, s = 3, 64
    toks = _tokens(rng, b, s, cfg.vocab_size)
    lens = np.array([64, 21, 50], np.int32) if padded else None
    jlogits, jcache = jlm.lm_prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, MAX_SEQ,
                                     cache_dtype=jnp.float32,
                                     prompt_lens=None if lens is None else jnp.asarray(lens))
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, MAX_SEQ,
                                  cache_dtype=torch.float32,
                                  prompt_lens=None if lens is None else torch.from_numpy(lens))
    assert logits.dtype == torch.float32 and logits.shape == (b, cfg.vocab_size)
    _close_ulps(logits, jlogits, F32_MOE_ULPS, "prefill logits")
    assert set(cache) == set(jcache) == {"k", "v"}
    for k in cache:
        _close_ulps(cache[k], jcache[k], F32_MOE_ULPS, f"prefill {k}")
    pos = lens.copy() if padded else s
    for _ in range(4):
        cur = _tokens(rng, b, 1, cfg.vocab_size)[:, 0]
        jlogits, jcache = jlm.serve_step(jparams, jcfg, jcache, jnp.asarray(cur),
                                         jnp.asarray(pos) if padded else pos)
        logits, cache = lm.serve_step(params, cfg, cache, torch.from_numpy(cur),
                                      torch.from_numpy(pos) if padded else pos)
        _close_ulps(logits, jlogits, F32_MOE_ULPS, "decode logits")
        pos = pos + 1
    for k in cache:
        _close_ulps(cache[k], jcache[k], F32_MOE_ULPS, f"decode {k}")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_and_prefill_match_forward(name):
    """With lossless dispatch (capacity_factor 8, as
    ``tests/test_lm_archs.py:59-80``): step-by-step decode from an empty
    cache == the full causal forward within the reference's 2e-4, and the
    prefill's last-token logits == the forward's."""
    cfg = dataclasses.replace(reduced_config(name), attn_chunk=16, capacity_factor=8.0)
    _, _, _, _, params = _pair(name)
    b, s = 2, 24
    toks = torch.from_numpy(_tokens(np.random.default_rng(8), b, s, cfg.vocab_size))
    with torch.no_grad():
        hidden, _ = lm.lm_forward(params, cfg, {"tokens": toks})
        full = hidden @ lm._head_weight(params, cfg)
    logits, _ = lm.lm_prefill(params, cfg, {"tokens": toks}, s, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(logits), _np(full[:, -1]), rtol=0, atol=2e-5)
    cache = lm.init_cache(cfg, b, s, dtype=torch.float32, device="cpu")
    errs = []
    for t in range(s):
        logits, cache = lm.serve_step(params, cfg, cache, toks[:, t], t)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, f"decode diverges from forward: {max(errs)}"


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

# run's equal-length groups and lockstep's padded batches of 3 slots all
# satisfy the group rule (<= 64 tokens, or 192 = 3 x 64)
WORKLOAD = dict(prompt_lens=(5, 16, 64), new_tokens=(0, 1, 3, 6))


@pytest.fixture(scope="module")
def moe_engines():
    """Per family: the reference engine and the port's on the same reduced
    weights (default capacity), and a port engine factory at a capacity
    factor of E / k (lossless dispatch)."""
    ref = load_reference()
    out = {}
    for name in FAMILIES:
        jcfg = jax_reduced_config(name)
        jparams = ref.lm.init_lm(jax.random.PRNGKey(0), jcfg)
        params = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        cfg = reduced_config(name)
        lossless = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                                       / cfg.experts_per_token)
        out[name] = (lambda jp=jparams, jc=jcfg, **kw: ref.engine.ServeEngine(jp, jc, **kw),
                     lambda p=params, c=cfg, **kw: ServeEngine(p, c, device="cpu", **kw),
                     lambda p=params, c=lossless, **kw: ServeEngine(p, c, device="cpu", **kw),
                     cfg)
    return out


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
@pytest.mark.parametrize("name", FAMILIES)
def test_engine_serves_the_reference_tokens(moe_engines, name, mode):
    """At the default capacity, where idle slots and pad rows compete for
    the experts' places: the port's engine feeds them what the reference's
    does, so every token equals the reference's."""
    ref = load_reference()
    make_ref, make_port, _, cfg = moe_engines[name]
    kw = dict(batch_slots=3, max_seq=MAX_SEQ)
    e_ref, e_port = make_ref(**kw), make_port(**kw)
    done_ref = getattr(e_ref, mode)(ref.loadgen.lm_workload(cfg.vocab_size, 8, seed=2,
                                                            **WORKLOAD))
    done_port = getattr(e_port, mode)(lm_workload(cfg.vocab_size, 8, seed=2, **WORKLOAD))
    assert len(done_port) == len(done_ref) == 8
    for a, b in zip(done_port, done_ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.output, b.output)
    counts = ("tokens", "prefill_tokens", "decode_steps", "delivered_slot_steps")
    assert {k: e_port.stats[k] for k in counts} == {k: e_ref.stats[k] for k in counts}


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
@pytest.mark.parametrize("name", FAMILIES)
def test_lossless_batch_matches_solo(moe_engines, name, mode):
    """With capacity_factor E / k no token is dropped, so a request's tokens
    are the same alone or batched (``tests/test_serving.py:119-152``)."""
    _, _, make_lossless, cfg = moe_engines[name]
    reqs = lm_workload(cfg.vocab_size, 6, seed=4, prompt_lens=(5, 16, 64),
                       new_tokens=(1, 3, 6))
    solo = [make_lossless(batch_slots=1, max_seq=MAX_SEQ).run(
        [Request(r.prompt.copy(), r.max_new_tokens)])[0].output for r in reqs]
    done = getattr(make_lossless(batch_slots=3, max_seq=MAX_SEQ), mode)(
        [Request(r.prompt.copy(), r.max_new_tokens) for r in reqs])
    key = lambda r: (tuple(r.prompt.tolist()), r.max_new_tokens)    # noqa: E731
    assert {key(d): d.output.tolist() for d in done} == \
        {key(r): s.tolist() for r, s in zip(reqs, solo)}


def test_engines_refuse_a_prefill_group_off_the_rule(moe_engines):
    """Three prompts of 30 tokens prefill as one group of 90 tokens: the
    reference's reshape fails, and the port raises its ValueError."""
    make_ref, make_port, _, cfg = moe_engines["qwen3-moe-30b-a3b"]
    rng = np.random.default_rng(3)
    prompts = [_tokens(rng, 1, 30, cfg.vocab_size)[0] for _ in range(3)]
    with pytest.raises(TypeError):
        make_ref(batch_slots=3, max_seq=40).run([Request(p, 2) for p in prompts])
    with pytest.raises(ValueError, match="moe_group"):
        make_port(batch_slots=3, max_seq=40).run([Request(p, 2) for p in prompts])


# ---------------------------------------------------------------------------
# entry points on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_launchers_serve_and_train_the_moe_family_on_the_cpu(name, capsys, tmp_path):
    done = serve_launcher.main(["--device", "cpu", "--arch", name, "--requests", "4"])
    assert len(done) == 4 and all(r.output is not None for r in done)
    done = serve_launcher.main(["--device", "cpu", "--arch", name, "--requests", "3",
                                "--lockstep"])
    assert len(done) == 3
    out = capsys.readouterr().out
    assert "lm: 4 completed" in out and "lm/lockstep: 3 completed" in out
    losses = train_launcher.main(["--arch", name, "--device", "cpu", "--steps", "3",
                                  "--seq", "64", "--ckpt-dir", str(tmp_path / "ck")])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "device cpu" in capsys.readouterr().out


def test_pretrain_example_runs_qwen3_moe_on_the_cpu(tmp_path, capsys):
    """Compressed gradients (the codec's plain versions here) and a lossy
    checkpoint of the MoE family, the experts' leaves among them."""
    spec = importlib.util.spec_from_file_location(
        "lm_pretrain_torch", ROOT / "examples" / "lm_pretrain_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    losses = example.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--steps", "3",
                           "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "lossy checkpoint" in capsys.readouterr().out
