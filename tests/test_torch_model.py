"""The port's surrogate layers, model and Adam against the JAX package.

Weights come from the JAX init through ``params_from_jax``; inputs are made
with numpy.  Float convolutions sum in another order in XLA and in
PyTorch, so forward values and gradients are held to stated f32 tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import nn as jnn
from repro.models.surrogate import (FieldNormalizer as JaxNormalizer,
                                    SurrogateConfig as JaxConfig,
                                    apply_surrogate as jax_apply,
                                    init_surrogate as jax_init,
                                    l1_loss as jax_l1,
                                    make_conditions as jax_make_conditions)
from repro.train.optimizer import (AdamConfig as JaxAdamConfig,
                                   adam_init as jax_adam_init,
                                   adam_update as jax_adam_update)

from repro_torch.models import nn
from repro_torch.models.surrogate import (FieldNormalizer, SurrogateConfig,
                                          apply_surrogate, init_surrogate,
                                          l1_loss, make_conditions,
                                          params_from_jax)
from repro_torch.train.optimizer import AdamConfig, adam_init, adam_update

torch.set_num_threads(2)

CFG = dict(height=16, width=16, base_channels=8)
FWD_ATOL = 2e-5     # f32 convolutions, different summation order
GRAD_RTOL = 2e-4    # relative to each gradient leaf's max magnitude


@pytest.fixture
def rng():
    """This file's own generator, fresh for every test.  The session-wide
    one in conftest.py hands each test whatever state the files run before
    it in the same worker left behind, so inputs changed with the order."""
    return np.random.default_rng(0)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_nhwc, (0, 3, 1, 2))))


def _model_pair(seed=0, cfg=CFG):
    jcfg = JaxConfig(**cfg)
    jparams = jax_init(jax.random.PRNGKey(seed), jcfg)
    model = init_surrogate(SurrogateConfig(**cfg), seed=seed, device="cpu")
    model.load_state_dict(params_from_jax(jparams))
    return jcfg, jparams, model


def test_init_matches_jax_shapes_and_scale():
    jcfg, jparams, _ = _model_pair()
    model = init_surrogate(SurrogateConfig(**CFG), seed=3, device="cpu")
    converted = params_from_jax(jparams)
    state = model.state_dict()
    assert set(state) == set(converted)
    for k, v in converted.items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    # He-normal: std sqrt(2 / fan_in) of the (largest) transposed conv
    w = state["up0_t.w"]
    assert float(w.std()) == pytest.approx(np.sqrt(2.0 / (16 * w.shape[0])), rel=0.1)


def test_conv2d_transpose_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)       # NHWC
    w = rng.standard_normal((4, 4, 4, 6)).astype(np.float32)       # HWIO
    b = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(jnn.conv2d_transpose({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                           jnp.asarray(x)))
    p = params_from_jax({"up0_t": {"w": w, "b": b}})
    got = nn.conv2d_transpose({"w": p["up0_t.w"], "b": p["up0_t.b"]}, _nchw(x))
    assert got.shape == (2, 6, 6, 10)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=FWD_ATOL)


def test_conv2d_and_layernorm_match_jax(rng):
    x = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)
    w = rng.standard_normal((3, 3, 7, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x)))
    p = params_from_jax({"up0_c": {"w": w, "b": b}})
    got = nn.conv2d({"w": p["up0_c.w"], "b": p["up0_c.b"]}, _nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=FWD_ATOL)
    g = rng.standard_normal(7).astype(np.float32)
    bb = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(jnn.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(bb)},
                                    jnp.asarray(x)))
    got = nn.layernorm({"g": torch.from_numpy(g), "b": torch.from_numpy(bb)}, _nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=FWD_ATOL)
    v = np.array([-1.0, 0.0, 2.0], np.float32)
    assert np.array_equal(nn.leaky_relu(torch.from_numpy(v)).numpy(),
                          np.asarray(jnn.leaky_relu(jnp.asarray(v))))


def test_forward_matches_jax(rng):
    jcfg, jparams, model = _model_pair()
    cond = rng.standard_normal((5, jcfg.cond_dim)).astype(np.float32)
    want = np.asarray(jax_apply(jparams, jcfg, jnp.asarray(cond)))
    with torch.no_grad():
        got = apply_surrogate(model, torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (5, 16, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_l1_loss_and_gradients_match_jax(rng):
    jcfg, jparams, model = _model_pair(seed=1)
    cond = rng.standard_normal((4, jcfg.cond_dim)).astype(np.float32)
    target = rng.standard_normal((4, 16, 16, 6)).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(jax_l1)(jparams, jcfg, jnp.asarray(cond),
                                               jnp.asarray(target))
    with torch.no_grad():
        pred = apply_surrogate(model, torch.from_numpy(cond)).numpy()
    gap = float(np.abs(pred - target).min())
    assert gap > 10 * FWD_ATOL, (
        f"min |pred - target| = {gap:.2e}: L1's gradient is sign(pred - target), so "
        f"a residual within 10 * FWD_ATOL of zero could flip between the packages "
        f"and the gradient comparison would be ill-posed; draw other inputs")
    loss = l1_loss(model, torch.from_numpy(cond), torch.from_numpy(target))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=name)


@pytest.mark.parametrize("opts", [{}, {"weight_decay": 0.01, "grad_clip": 0.5}])
def test_adam_update_matches_jax(rng, opts):
    shapes = {"a": (3, 4), "b": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jcfg, cfg = JaxAdamConfig(lr=1e-3, **opts), AdamConfig(lr=1e-3, **opts)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jax_adam_init(jp, jcfg), adam_init(tp, cfg)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        jp, jstate = jax_adam_update({k: jnp.asarray(g) for k, g in grads.items()},
                                     jstate, jp, jcfg)
        tp, tstate = adam_update({k: torch.from_numpy(g) for k, g in grads.items()},
                                 tstate, tp, cfg)
    assert int(tstate.step) == int(jstate.step) == 5
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-7,
                                   atol=0)
        np.testing.assert_allclose(tstate.v[k].numpy(), np.asarray(jstate.v[k]),
                                   rtol=1e-6, atol=0)


def test_conditions_and_normalizer_match_jax(rng):
    pv = rng.standard_normal((3, 6)).astype(np.float32)
    assert np.array_equal(make_conditions(pv, 5), jax_make_conditions(pv, 5))
    fields = rng.standard_normal((4, 8, 8, 6)).astype(np.float32)
    norm, jnorm = FieldNormalizer.fit(fields), JaxNormalizer.fit(fields)
    got = norm.normalize(torch.from_numpy(fields)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnorm.normalize(jnp.asarray(fields))),
                               rtol=1e-6, atol=1e-6)
    back = norm.denormalize(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, fields, rtol=1e-5, atol=1e-5)


NARROW = dict(height=16, width=8, base_channels=8)     # width // 16 == 0


def test_conv2d_transpose_of_an_empty_extent_matches_jax(rng):
    """A zero-width input comes out one wide and holds only the bias, as the
    JAX layer's lhs-dilated convolution gives it; gradients reach the bias
    and are zero for the weights."""
    w = rng.standard_normal((4, 4, 8, 3)).astype(np.float32)       # HWIO
    b = rng.standard_normal(3).astype(np.float32)
    for shape in ((2, 1, 0, 8), (2, 0, 0, 8), (2, 0, 3, 8)):
        x = np.zeros(shape, np.float32)
        want = np.asarray(jnn.conv2d_transpose({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                               jnp.asarray(x)))
        p = {k: v.requires_grad_() for k, v in
             zip(("w", "b"), (lambda d: (d["up0_t.w"], d["up0_t.b"]))(
                 params_from_jax({"up0_t": {"w": w, "b": b}})))}
        got = nn.conv2d_transpose(p, _nchw(x))
        assert got.permute(0, 2, 3, 1).shape == want.shape
        assert np.array_equal(got.detach().permute(0, 2, 3, 1).numpy(), want)
        got.sum().backward()
        assert float(p["w"].grad.abs().max()) == 0
        assert np.array_equal(p["b"].grad.numpy(), np.full(3, got[:, 0].numel(), np.float32))


def test_narrow_surrogate_forward_and_train_step_match_jax(rng):
    """SurrogateConfig(width=8): its dense layer has zero outputs and the
    four stages widen 0 -> 1 -> 2 -> 4 -> 8, in both packages."""
    from repro.train.loop import _train_step as jax_train_step
    from repro_torch.train.source import make_update
    jcfg, jparams, model = _model_pair(seed=2, cfg=NARROW)
    cond = rng.standard_normal((4, jcfg.cond_dim)).astype(np.float32)
    target = rng.standard_normal((4, 16, 8, 6)).astype(np.float32)
    want = np.asarray(jax_apply(jparams, jcfg, jnp.asarray(cond)))
    with torch.no_grad():
        got = apply_surrogate(model, torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (4, 16, 8, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)

    jopt_cfg, opt_cfg = JaxAdamConfig(lr=1e-3), AdamConfig(lr=1e-3)
    jp, _, jloss = jax_train_step(jparams, jax_adam_init(jparams, jopt_cfg),
                                  jnp.asarray(cond), jnp.asarray(target), jcfg, jopt_cfg)
    _, loss = make_update(model, opt_cfg)(
        adam_init(dict(model.named_parameters()), opt_cfg),
        torch.from_numpy(cond), torch.from_numpy(target))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jp))
    diffs = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                            for n, p in model.named_parameters()])
    # Adam's first step moves each element by about +-lr: a gradient near
    # zero whose sign differs by rounding moves it by 2 lr
    assert diffs.max() <= 2e-3 and np.quantile(diffs, 0.99) < 1e-6
