"""The seed ensemble's member-folded gradient (``train/source.py``
``ensemble_grad``, ``models/folded.py``) and evaluation
(``core/ensemble.py`` ``_eval_ensemble``): every member's convolutions
as grouped convolutions on one channels-last batch.

On the CPU the folded gradient is held to each member's own
``grad_and_value`` of ``functional_l1_loss`` over its own parameters,
with 1, 2 and 5 members, on one shared and on per-member device-resident
stores: every leaf to 1e-5 of its norm, every loss to 1e-6; the
gradients come back as contiguous ``(N, ...)`` stacks and leave the
stacks alone.  The folded evaluation is held to each member's own
``functional_forward`` metrics, every metric to 1e-5 of its size.

Tests marked ``card`` need an NVIDIA card and skip without one.  On the
card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_ensemble_layout.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine
does not have; this file does not import it.)  At the seed ensemble's
shapes (5 members of 64 samples, 96x32, base 256, f32 with TF32 off) a
replayed step spends under 5% of its kernel time in kernels named
``*transpose*``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ensemble import TRAJECTORY_METRICS, _eval_ensemble, init_ensemble
from repro_torch.data import DeviceResidentCompressedStore, channels_last
from repro_torch.metrics import psnr, total_mass, total_momentum
from repro_torch.models.surrogate import (SurrogateConfig, functional_forward,
                                          functional_l1_loss, init_surrogate,
                                          member_params)
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.synthetic import synthetic_study
from repro_torch.train.optimizer import AdamConfig, adam_init
from repro_torch.train.source import (ensemble_grad, make_ensemble_source,
                                      make_fused_ensemble_step)

CFG = SurrogateConfig(height=32, width=16, base_channels=32)
N_SAMPLES, BATCH = 32, 8
GRAD_RTOL, LOSS_RTOL, EVAL_RTOL = 1e-5, 1e-6, 1e-5


def _source(cfg, kind, members, dev, n_samples=N_SAMPLES):
    """A device-resident ensemble source of the synthetic study: one
    shared store, or one store a member at its own tolerance."""
    _, cond, fields = synthetic_study(n=n_samples, height=cfg.height, width=cfg.width,
                                      base_channels=cfg.base_channels)
    samples = np.ascontiguousarray(np.transpose(fields, (0, 3, 1, 2)))

    def store(tol):
        return DeviceResidentCompressedStore.from_samples(
            samples, [tol] * n_samples, shard_size=8, device=dev)
    data = store(0.02) if kind == "shared" else \
        [store(0.01 * 2 ** m) for m in range(members)]
    return make_ensemble_source(data, cond, channels_last)


def _batch(cfg, kind, members, dev="cpu", batch=BATCH, n_samples=N_SAMPLES):
    """(stacked parameters of seeds 0..N-1, cond (N, B, cond_dim), target
    (N, B, H, W, F)) of one gathered batch, each member its own rows."""
    source = _source(cfg, kind, members, dev, n_samples)
    rng = np.random.default_rng(members)
    idx = np.stack([rng.choice(n_samples, batch, replace=False) for _ in range(members)])
    cond, target = source.gather(source.fetch(idx))
    return init_ensemble(cfg, range(members), dev), cond, target


def _oracle(model, params, cond, target):
    """Each member's own ``grad_and_value`` of ``functional_l1_loss``."""
    def member_loss(p, c, t):
        return functional_l1_loss(model, p, c, t)

    out = [torch.func.grad_and_value(member_loss)(member_params(params, m), cond[m], target[m])
           for m in range(cond.shape[0])]
    return [g for g, _ in out], torch.stack([loss for _, loss in out])


@pytest.mark.parametrize("members", [1, 2, 5])
@pytest.mark.parametrize("kind", ["shared", "per_member"])
def test_folded_grad_equals_each_members_own_grad(kind, members):
    params, cond, target = _batch(CFG, kind, members)
    model = init_surrogate(CFG, 0, "cpu")
    grads, loss = ensemble_grad(CFG)(params, cond, target)
    want_grads, want_loss = _oracle(model, params, cond, target)
    assert loss.shape == (members,) and not loss.requires_grad
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    assert grads.keys() == params.keys()
    for k, g in grads.items():
        assert g.shape == params[k].shape and g.is_contiguous(), k
        assert not g.requires_grad, k
        for m in range(members):
            want = want_grads[m][k]
            assert float((g[m] - want).norm()) <= GRAD_RTOL * float(want.norm()), (k, m)


def test_folded_grad_at_a_width_below_16():
    """A width of 8: the dense layer has zero outputs and the first
    transposed convolution is its bias alone, as in the single model."""
    cfg = SurrogateConfig(height=16, width=8, base_channels=8)
    params, cond, target = _batch(cfg, "shared", 2)
    model = init_surrogate(cfg, 0, "cpu")
    grads, loss = ensemble_grad(cfg)(params, cond, target)
    want_grads, want_loss = _oracle(model, params, cond, target)
    torch.testing.assert_close(loss, want_loss, rtol=LOSS_RTOL, atol=0)
    for k, g in grads.items():
        for m in range(2):
            want = want_grads[m][k]
            assert float((g[m] - want).norm()) <= GRAD_RTOL * float(want.norm()), (k, m)


def test_folded_grad_leaves_the_stacks_under_no_grad():
    params, cond, target = _batch(CFG, "shared", 2)
    before = {k: v.clone() for k, v in params.items()}
    grad = ensemble_grad(CFG)
    with torch.no_grad():                       # a caller's no_grad does not stop it
        first, _ = grad(params, cond, target)
    second, _ = grad(params, cond, target)
    assert all(torch.equal(params[k], before[k]) and not params[k].requires_grad
               for k in params)
    assert all(torch.equal(first[k], second[k]) for k in first)


@pytest.mark.parametrize("members", [1, 2, 5])
def test_folded_eval_equals_each_members_own_metrics(members):
    """``_eval_ensemble`` on one eval set against each member's own
    ``functional_forward`` and the metrics reduced as a single model's
    eval: L1 and PSNR over everything, mass and momentum over the batch."""
    params, cond, target = _batch(CFG, "shared", members)
    cond, target = cond[0], target[0]
    model = init_surrogate(CFG, 0, "cpu")
    got = _eval_ensemble(params, CFG, cond, target)
    assert set(got) == set(TRAJECTORY_METRICS)
    for m in range(members):
        with torch.no_grad():
            pred = functional_forward(model, member_params(params, m), cond)
        mom = total_momentum(pred).mean(dim=0)
        want = {"l1": (pred - target).abs().mean(),
                "psnr": psnr(target, pred, axis=(-3, -2)).mean(),
                "mass": total_mass(pred).mean(), "mom_x": mom[0], "mom_y": mom[1]}
        for k, w in want.items():
            assert got[k].shape == (members,) and not got[k].requires_grad, k
            torch.testing.assert_close(got[k][m], w, rtol=EVAL_RTOL, atol=0,
                                       msg=lambda e, k=k: f"{k}, member {m}: {e}")


# -- the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
def test_a_replayed_step_at_the_cells_shapes_spends_little_on_transposes(card, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for flag in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flag, "allow_tf32", False)
    cfg, members, batch = SurrogateConfig(), 5, 64
    source = _source(cfg, "shared", members, card, n_samples=128)
    rng = np.random.default_rng(0)
    idxs = [source.fetch(np.stack([rng.choice(128, batch, replace=False)
                                   for _ in range(members)])) for _ in range(4)]
    params = init_ensemble(cfg, range(members), card)
    state = adam_init(params, AdamConfig(lr=1e-4))
    step = make_fused_ensemble_step(source, cfg, AdamConfig(lr=1e-4))
    counter = get_registry().counter("ensemble.graph_replays")
    for idx in idxs[:2]:                         # the eager first step; the capture
        params, state, _ = step(params, state, idx)
    torch.cuda.synchronize()
    start = counter.value
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for idx in idxs[2:]:
            params, state, loss = step(params, state, idx)
        torch.cuda.synchronize()
    assert counter.value - start == len(idxs) - 2
    assert torch.isfinite(loss).all()
    times = [(e.name(), e.end_ns() - e.start_ns()) for e in prof.profiler.kineto_results.events()
             if e.device_type() != DeviceType.CPU
             and not e.name().startswith(("Memcpy", "Memset"))]
    total = sum(t for _, t in times)
    spent = sum(t for name, t in times if "transpose" in name.lower())
    assert total > 0
    assert spent < 0.05 * total, (spent, total)
