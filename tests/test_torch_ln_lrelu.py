"""The surrogate's layer norm + LeakyReLU block (``models/nn.py``
``layernorm_leaky_relu``) and its CUDA kernel pair (``kernels/ln_lrelu.py``,
``csrc/ln_lrelu.cu``).

On the CPU the block is ``leaky_relu(layernorm(p, x))`` bit for bit and
moves only the ``surrogate.ln_blocks`` counter; the plain twins of the
kernels (``kernels/ref.py`` ``ln_lrelu_forward`` / ``ln_lrelu_backward``)
are held to autograd of those layers in float32 (1e-5 of each tensor's
size) and by ``gradcheck`` in float64, and take gradient 1 at a
pre-activation of exactly 0, as autograd of the layers does (and JAX); and the autograd Function around the
pair, with the twins standing in for the launches, gives the surrogate the
plain path's loss and gradients.

Tests marked ``card`` need an NVIDIA card and skip without one.  On the
card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_ln_lrelu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine
does not have; this file does not import it.)  There the kernels are held
to the twins at every block shape of the 512x512 and 768x256 surrogates at
batch 64 and at small ragged shapes: y bit for bit from the kernel's own
mean and rstd, the statistics and dx to 1e-5 of their size, dg and db to
1e-5 of the sum of their terms' magnitudes (the sums run in another order);
two backward calls give the same bits; a surrogate's forward and backward
launch each kernel five times; a dtype the kernel does not take raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ln_lrelu, ops, ref
from repro_torch.models import nn
from repro_torch.models.surrogate import SurrogateConfig, _stage_channels, init_surrogate
from repro_torch.obs.metrics import get_registry

RTOL = 1e-5


def _block_params(c, rng, dtype=torch.float32):
    return {"g": torch.from_numpy(rng.uniform(0.5, 1.5, c)).to(dtype),
            "b": torch.from_numpy(rng.normal(0.0, 0.3, c)).to(dtype)}


def _input(shape, rng, dtype=torch.float32):
    if shape[2:] == (1, 1):             # the empty extent: conv2d_transpose's expanded bias
        return torch.from_numpy(rng.normal(size=shape[:2])).to(dtype)[:, :, None, None] \
            .expand(shape)
    return torch.from_numpy(rng.normal(1.0, 2.0, shape)).to(dtype)


def _close(got, want, what, rtol=RTOL):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale,
                               msg=lambda e: f"{what}: {e}")


SHAPES = [(2, 16, 5, 7), (2, 32, 6, 4), (2, 256, 3, 3), (3, 32, 1, 1)]


def _ids(shapes):
    return [f"C{s[1]}-{s[2]}x{s[3]}" for s in shapes]


# -- the CPU ------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_the_block_on_the_cpu_is_the_plain_chain_bit_for_bit(shape):
    rng = np.random.default_rng(shape[1])
    p, x = _block_params(shape[1], rng), _input(shape, rng)
    got = nn.layernorm_leaky_relu(p, x)
    assert torch.equal(got, nn.leaky_relu(nn.layernorm(p, x)))


def test_only_the_block_counter_moves_on_the_cpu():
    reg = get_registry()
    blocks, kernel_blocks = reg.counter("surrogate.ln_blocks"), \
        reg.counter("surrogate.ln_kernel_blocks")
    before = (blocks.value, kernel_blocks.value, ln_lrelu.launch_counts())
    model = init_surrogate(SurrogateConfig(height=32, width=16, base_channels=32), device="cpu")
    model(torch.zeros(2, model.cfg.cond_dim)).sum().backward()
    assert blocks.value - before[0] == 5
    assert kernel_blocks.value == before[1]
    assert ln_lrelu.launch_counts() == before[2]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_the_twins_match_autograd_of_the_plain_chain(shape):
    rng = np.random.default_rng(10 + shape[1])
    p = {k: v.requires_grad_() for k, v in _block_params(shape[1], rng).items()}
    x = _input(shape, rng).contiguous().requires_grad_()
    dy = torch.from_numpy(rng.normal(size=shape)).float()
    want = nn.leaky_relu(nn.layernorm(p, x))
    want_dx, want_dg, want_db = torch.autograd.grad(want, (x, p["g"], p["b"]), dy)
    with torch.no_grad():
        y, mean, rstd = ref.ln_lrelu_forward(x, p["g"], p["b"])
        dx, dg, db = ref.ln_lrelu_backward(dy, x, p["g"], p["b"], mean, rstd)
        _close(y, want, "y")
        _close(mean, x.mean(dim=1), "mean")
        _close(dx, want_dx, "dx")
        _close(dg, want_dg, "dg")
        _close(db, want_db, "db")


def _pre_zero_case(dtype):
    """Every channel of pixel (0, 0, 0) equal, so its xhat is exactly 0 and
    its pre-activation exactly b; b[1] is 0."""
    rng = np.random.default_rng(3)
    p = _block_params(8, rng, dtype)
    p["b"][1] = 0.0
    x = _input((2, 8, 3, 3), rng, dtype).contiguous()
    x[0, :, 0, 0] = 1.5
    return p, x


def test_the_twins_take_gradient_1_at_a_pre_activation_of_exactly_0():
    p, x = _pre_zero_case(torch.float32)
    y, mean, rstd = ref.ln_lrelu_forward(x, p["g"], p["b"])
    assert y[0, 1, 0, 0] == 0.0
    dy = torch.zeros_like(x)
    dy[0, 1, 0, 0] = 1.0
    _, dg, db = ref.ln_lrelu_backward(dy, x, p["g"], p["b"], mean, rstd)
    assert db[1] == 1.0 and dg[1] == 0.0
    x_ = x.clone().requires_grad_()
    b_ = p["b"].clone().requires_grad_()
    nn.leaky_relu(nn.layernorm({"g": p["g"], "b": b_}, x_)).backward(dy)
    assert b_.grad[1] == 1.0


class _Twins(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, b):
        y, mean, rstd = ref.ln_lrelu_forward(x, g, b)
        ctx.save_for_backward(x, g, b, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        return ref.ln_lrelu_backward(dy, *ctx.saved_tensors)


GRADCHECK_SHAPES = [(2, 6, 3, 4), (3, 16, 1, 1)]


@pytest.mark.parametrize("shape", GRADCHECK_SHAPES, ids=_ids(GRADCHECK_SHAPES))
def test_the_twins_pass_gradcheck_in_float64(shape):
    """Away from a pre-activation of 0 (a finite difference straddles the
    kink there; the test above takes that point)."""
    rng = np.random.default_rng(4)
    p, x = _block_params(shape[1], rng, torch.float64), _input(shape, rng, torch.float64)
    args = (x.contiguous().requires_grad_(), p["g"].requires_grad_(), p["b"].requires_grad_())
    assert torch.autograd.gradcheck(_Twins.apply, args, eps=1e-7, atol=1e-6)


@pytest.fixture
def twins_for_the_kernels(monkeypatch):
    """The card's path on the CPU: the block takes the kernel pair, whose
    launches are the twins, counted as the kernels count them."""
    on_cpu = ops._on_cpu
    monkeypatch.setattr(ops, "_on_cpu", lambda *ts, kind="ZFP":
                        kind != "layer norm" and on_cpu(*ts, kind=kind))
    calls = []

    def forward(x, g, b, eps, slope, stats=True):
        calls.append(("forward", stats))
        ln_lrelu._counted("ln_lrelu_fwd")
        y, mean, rstd = ref.ln_lrelu_forward(x, g, b, eps, slope)
        return (y, mean, rstd) if stats else (y, None, None)

    def backward(dy, x, g, b, mean, rstd, slope):
        calls.append(("backward", dy.is_contiguous()))
        ln_lrelu._counted("ln_lrelu_bwd", "ln_lrelu_bwd_reduce")
        return ref.ln_lrelu_backward(dy, x, g, b, mean, rstd, slope)

    monkeypatch.setattr(ln_lrelu, "forward", forward)
    monkeypatch.setattr(ln_lrelu, "backward", backward)
    return calls


@pytest.mark.parametrize("height", [32, 8], ids=["32x16", "8x8-empty-extent"])
def test_the_function_gives_the_plain_paths_loss_and_gradients(twins_for_the_kernels,
                                                               monkeypatch, height):
    cfg = SurrogateConfig(height=height, width=16 if height == 32 else 8, base_channels=32)
    model = init_surrogate(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(5)
    cond = torch.from_numpy(rng.uniform(size=(4, cfg.cond_dim))).float()
    target = torch.from_numpy(rng.normal(size=(4, cfg.height, cfg.width, cfg.fields))).float()
    reg = get_registry()
    blocks, kernel_blocks = reg.counter("surrogate.ln_blocks"), \
        reg.counter("surrogate.ln_kernel_blocks")
    before = (blocks.value, kernel_blocks.value)
    loss = (model(cond) - target).abs().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert (blocks.value - before[0], kernel_blocks.value - before[1]) == (5, 5)
    assert twins_for_the_kernels == [("forward", True)] * 5 + [("backward", True)] * 5
    with torch.no_grad():
        model(cond)
    assert twins_for_the_kernels[10:] == [("forward", False)] * 5

    monkeypatch.setattr(nn, "layernorm_leaky_relu",
                        lambda p, x: nn.leaky_relu(nn.layernorm(p, x)))
    want_loss = (model(cond) - target).abs().mean()
    plain = torch.autograd.grad(want_loss, list(model.parameters()))
    _close(loss.detach(), want_loss.detach(), "loss")
    for (name, _), got, want in zip(model.named_parameters(), grads, plain):
        _close(got, want, name, rtol=1e-4)



@pytest.mark.parametrize("when, flagged", [("first step", 0), ("third step", 1)])
def test_the_train_loop_flags_the_pairs_library_built_after_its_first_step(monkeypatch,
                                                                            when, flagged):
    """The pair's library, built at a run's first block, is expected there;
    one built later is a steady-state rebuild, which the recompile watcher
    counts in ``jax.recompiles``."""
    from repro_torch.data import RawArrayStore
    from repro_torch.train.loop import TrainConfig, train_surrogate
    libs = {}
    monkeypatch.setattr(ln_lrelu, "_libs", libs)
    block = nn.layernorm_leaky_relu

    def building_block(p, x, *args, **kw):
        libs.setdefault("ln_lrelu", None)
        return block(p, x, *args, **kw)

    hooks = []
    if when == "first step":
        monkeypatch.setattr(nn, "layernorm_leaky_relu", building_block)
    else:
        hooks.append(lambda step, m, loss: step == 2 and libs.setdefault("ln_lrelu", None))
    rng = np.random.default_rng(6)
    cfg = SurrogateConfig(height=16, width=16, base_channels=8)
    cond = rng.normal(size=(12, cfg.cond_dim)).astype(np.float32)
    fields = rng.normal(size=(12, 16, 16, 6)).astype(np.float32)
    recompiles = get_registry().counter("jax.recompiles")
    before = recompiles.value
    train_surrogate(cfg, TrainConfig(batch_size=4, max_steps=3, prefetch=0), cond,
                    RawArrayStore(fields, device="cpu"), hooks=hooks, device="cpu")
    assert len(libs) == 1
    assert recompiles.value - before == flagged

# -- the card -----------------------------------------------------------------------


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", False)
    return torch.device("cuda")


def _block_shapes(height, width, base=256, batch=64):
    """(B, C, H, W) of the five blocks of a surrogate."""
    h, w = height // 16, width // 16
    out = [(batch, base, h, w)]
    for i, (_, cout) in enumerate(_stage_channels(SurrogateConfig(base_channels=base))):
        out.append((batch, cout, h << (i + 1), w << (i + 1)))
    return out


CARD_SHAPES = (_block_shapes(512, 512) + _block_shapes(768, 256)
               + [(3, 32, 7, 5), (2, 48, 5, 3), (5, 5, 3, 1), (2, 300, 3, 5), (7, 64, 1, 1)])


def _card_case(shape, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=gen) * 2.0 + 1.0
    g = torch.rand(shape[1], device=dev, generator=gen) + 0.5
    b = torch.randn(shape[1], device=dev, generator=gen) * 0.3
    dy = torch.randn(shape, device=dev, generator=gen)
    return x, g, b, dy


@pytest.mark.card
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=_ids(CARD_SHAPES))
def test_the_kernels_match_the_twins(card, shape):
    x, g, b, dy = _card_case(shape, card, sum(shape))
    y, mean, rstd = ln_lrelu.forward(x, g, b, 1e-5, 0.2)
    want_y, want_mean, want_rstd = ref.ln_lrelu_forward(x, g, b)
    _close(mean, want_mean, "mean")
    _close(rstd, want_rstd, "rstd")
    _close(y, want_y, "y")
    # from the kernel's own statistics the plain order gives y's bits
    pre = (x - mean[:, None]) * rstd[:, None] * g[:, None, None] + b[:, None, None]
    assert torch.equal(y, torch.where(pre >= 0, pre, 0.2 * pre))
    del pre, want_y
    dx, dg, db = ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)
    want_dx, want_dg, want_db = ref.ln_lrelu_backward(dy, x, g, b, mean, rstd)
    _close(dx, want_dx, "dx")
    del dx, want_dx
    xhat = (x - mean[:, None]) * rstd[:, None]
    pre = xhat * g[:, None, None] + b[:, None, None]
    dpre = torch.where(pre >= 0, dy, 0.2 * dy)
    for got, want, mag, what in ((dg, want_dg, (dpre * xhat).abs().sum(dim=(0, 2, 3)), "dg"),
                                 (db, want_db, dpre.abs().sum(dim=(0, 2, 3)), "db")):
        err = (got - want).abs()
        assert bool((err <= RTOL * mag + 1e-30).all()), (what, float((err / mag).max()))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(64, 32, 512, 512), (64, 256, 48, 16), (2, 300, 3, 5)],
                         ids=["C32-512x512", "C256-48x16", "C300-3x5"])
def test_two_backward_calls_give_the_same_bits(card, shape):
    x, g, b, dy = _card_case(shape, card, 7)
    _, mean, rstd = ln_lrelu.forward(x, g, b, 1e-5, 0.2)
    first = ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)
    second = ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.card
@pytest.mark.parametrize("height,width", [(96, 32), (8, 8)], ids=["96x32", "8x8-empty-extent"])
def test_a_surrogate_step_launches_each_kernel_five_times(card, height, width):
    cfg = SurrogateConfig(height=height, width=width, base_channels=64)
    model = init_surrogate(cfg, seed=2, device=card)
    cpu = init_surrogate(cfg, seed=2, device="cpu")
    cond = torch.rand(8, cfg.cond_dim, generator=torch.Generator().manual_seed(0))
    reg = get_registry()
    blocks, kernel_blocks = reg.counter("surrogate.ln_blocks"), \
        reg.counter("surrogate.ln_kernel_blocks")
    torch.cuda.synchronize()
    before = (blocks.value, kernel_blocks.value, ln_lrelu.launch_counts())
    out = model(cond.to(card))
    out.square().mean().backward()
    torch.cuda.synchronize()
    launches = ln_lrelu.launch_counts()
    # an empty ln_in input (8 // 16 == 0 rows) launches nothing
    fives = 5 if height >= 16 else 4
    assert {k: launches[k] - before[2][k] for k in launches} == {
        "ln_lrelu_fwd": fives, "ln_lrelu_bwd": fives, "ln_lrelu_bwd_reduce": fives}
    assert blocks.value - before[0] == 5
    assert kernel_blocks.value - before[1] == blocks.value - before[0]
    want = cpu(cond)
    want.square().mean().backward()
    _close(out.cpu(), want.detach(), "prediction", rtol=1e-4)
    for (name, p), (_, q) in zip(model.named_parameters(), cpu.named_parameters()):
        _close(p.grad.cpu(), q.grad, name, rtol=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_a_dtype_the_kernel_does_not_take_raises(card, dtype):
    rng = np.random.default_rng(0)
    p = {k: v.to(card, dtype) for k, v in _block_params(32, rng).items()}
    x = _input((2, 32, 4, 4), rng).to(card, dtype)
    with pytest.raises(TypeError, match="float32"):
        nn.layernorm_leaky_relu(p, x)
