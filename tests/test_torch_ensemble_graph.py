"""The seed ensemble's step replayed from CUDA graphs
(``train/source.py`` ``GraphedEnsembleStep``) and the capture-safe
``adam_update``.

On the CPU: ``adam_update`` against the formula it replaced (bias bases
uploaded with ``torch.tensor``), in place and not; the graphed step's
three stages, run eagerly, against the eager fused step; ``train_ensemble``
leaves the caller's parameters alone and captures nothing there.

Tests marked ``card`` need an NVIDIA card and skip without one.  On the
card, from the repo root::

    PYTHONPATH=src python -m pytest -q --noconftest -m card tests/test_torch_ensemble_graph.py

(``--noconftest``: ``tests/conftest.py`` imports JAX, which that machine
does not have; this file does not import it.)  They hold the graphed step
to the eager one bit for bit under deterministic algorithms.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.ensemble import init_ensemble, train_ensemble
from repro_torch.data import (DeviceResidentCompressedStore, EnsembleLoader,
                              channels_last)
from repro_torch.kernels import zfp_codec
from repro_torch.models.surrogate import SurrogateConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.synthetic import synthetic_study
from repro_torch.train.loop import TrainConfig
from repro_torch.train.optimizer import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.train.source import (GraphedEnsembleStep, _eager_fused_ensemble_step,
                                      make_ensemble_source, make_ensemble_update,
                                      make_fused_ensemble_step, make_loader)

CFG = SurrogateConfig(height=16, width=16, base_channels=16)
N_SAMPLES, BATCH = 32, 8
OPT = AdamConfig(lr=1e-3)
KINDS = ("shared", "per_member")


# -- helpers ----------------------------------------------------------------------


def _adam_update_before(grads, state, params, cfg, stacked):
    """``adam_update`` as it was written before the graphed step: the bias
    bases uploaded with ``torch.tensor``, every result a new tensor."""
    if cfg.grad_clip is not None:
        gn = torch.sqrt(sum(x.float().square().flatten(1).sum(dim=1) for x in grads.values())
                        ) if stacked else \
            torch.sqrt(sum(x.float().square().sum() for x in grads.values()))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
        grads = {k: g * (scale.reshape((-1,) + (1,) * (g.dim() - 1)) if stacked else scale)
                 for k, g in grads.items()}
    step = state.step + 1
    b1, b2 = cfg.b1, cfg.b2
    m = {k: b1 * state.m[k] + (1 - b1) * g for k, g in grads.items()}
    v = {k: b2 * state.v[k] + (1 - b2) * g.square() for k, g in grads.items()}
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step_f)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step_f)
    new = {k: (p - cfg.lr * ((m[k] / bc1) / (torch.sqrt(v[k] / bc2) + cfg.eps))).to(p.dtype)
           for k, p in params.items()}
    return new, AdamState(step=step, m=m, v=v)


def _data(kind, dev):
    """(conditions, data, seeds): one shared resident store of the tiny
    study, or two per-member stores at other tolerances (stacked by the
    source)."""
    cfg, cond, fields = synthetic_study(n=N_SAMPLES, height=CFG.height, width=CFG.width,
                                        base_channels=CFG.base_channels)
    assert cfg == CFG
    samples = np.ascontiguousarray(np.transpose(fields, (0, 3, 1, 2)))
    if kind == "shared":
        return cond, DeviceResidentCompressedStore.from_samples(
            samples, [0.02] * N_SAMPLES, shard_size=8, device=dev), (0, 1, 2)
    return cond, [DeviceResidentCompressedStore.from_samples(
        samples, [tol] * N_SAMPLES, shard_size=8, device=dev) for tol in (0.01, 0.5)], (7, 8)


def _setup(kind, dev, steps):
    """(source, initial stacked parameters, ``steps`` batches of device
    indices)."""
    cond, data, seeds = _data(kind, dev)
    source = make_ensemble_source(data, cond, channels_last)
    stores = data if isinstance(data, list) else [data] * len(seeds)
    loader = EnsembleLoader([make_loader(st, BATCH, seed=s) for st, s in zip(stores, seeds)])
    idxs = [source.fetch(i) for i, _ in zip(loader.iter_epochs(None), range(steps))]
    return source, init_ensemble(CFG, seeds, dev), idxs


def _snapshot(params, state, loss):
    return ({k: v.clone() for k, v in params.items()}, state.step.clone(),
            {k: v.clone() for k, v in state.m.items()},
            {k: v.clone() for k, v in state.v.items()}, loss.clone())


def _run(step, params, idxs):
    """Each step's state, copied as it is returned."""
    state = adam_init(params, OPT)
    out = []
    for idx in idxs:
        params, state, loss = step(params, state, idx)
        out.append(_snapshot(params, state, loss))
    return out


def _assert_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, dict):
                assert a.keys() == b.keys()
                for k in a:
                    assert torch.equal(a[k], b[k]), k
            else:
                assert torch.equal(a, b)


def _counters():
    reg = get_registry()
    return (reg.counter("ensemble.graph_captures").value,
            reg.counter("ensemble.graph_replays").value)


# -- the CPU -------------------------------------------------------------------------


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("grad_clip", [None, 1.0])
@pytest.mark.parametrize("stacked", [False, True])
def test_adam_update_equals_the_uploaded_bases_formula(stacked, grad_clip, inplace):
    g = torch.Generator().manual_seed(3)
    lead = (3,) if stacked else ()
    shapes = {"w": lead + (4, 5), "b": lead + (5,)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    state = AdamState(step=torch.tensor(4, dtype=torch.int32),
                      m={k: torch.randn(s, generator=g) for k, s in shapes.items()},
                      v={k: torch.rand(s, generator=g) for k, s in shapes.items()})
    grads = {k: 2 * torch.randn(s, generator=g) for k, s in shapes.items()}
    cfg = AdamConfig(lr=1e-3, grad_clip=grad_clip)
    want_p, want_s = _adam_update_before(grads, state, params, cfg, stacked)
    before = _snapshot(params, state, torch.zeros(()))
    got_p, got_s = adam_update(grads, state, params, cfg, stacked=stacked, inplace=inplace)
    _assert_identical([_snapshot(got_p, got_s, torch.zeros(()))],
                      [_snapshot(want_p, want_s, torch.zeros(()))])
    written = all(got_p[k] is params[k] and got_s.m[k] is state.m[k]
                  and got_s.v[k] is state.v[k] for k in params) and got_s.step is state.step
    assert written == inplace
    if not inplace:
        _assert_identical([_snapshot(params, state, torch.zeros(()))], [before])


@pytest.mark.parametrize("kind", KINDS)
def test_stages_run_eagerly_equal_the_fused_step(kind):
    source, params0, idxs = _setup(kind, "cpu", 3)
    p0 = {k: v.clone() for k, v in params0.items()}
    eager = make_fused_ensemble_step(source, CFG, OPT)
    assert not isinstance(eager, GraphedEnsembleStep)
    want = _run(eager, params0, idxs)
    step = GraphedEnsembleStep(source, CFG, OPT)
    params, state, loss = step(params0, adam_init(params0, OPT), idxs[0])
    got = [_snapshot(params, state, loss)]
    for idx in idxs[1:]:
        step.load(params, state, idx)
        for _, stage in step.STAGES:
            getattr(step, stage)()
        assert step.params is params and step.opt_state is state
        got.append(_snapshot(step.params, step.opt_state, step.loss))
    _assert_identical(got, want)
    assert all(torch.equal(params0[k], p0[k]) for k in p0)


def test_load_copies_foreign_state_and_refuses_another_batch_shape():
    source, params0, idxs = _setup("shared", "cpu", 2)
    step = GraphedEnsembleStep(source, CFG, OPT)
    params, state, _ = step(params0, adam_init(params0, OPT), idxs[0])
    other = {k: v + 1 for k, v in params.items()}
    step.load(other, state, idxs[1])
    assert step.params is params and all(torch.equal(params[k], other[k]) for k in other)
    assert torch.equal(step.idx, idxs[1])
    with pytest.raises(ValueError, match="indices of shape"):
        step.load(params, state, idxs[1][:, :-1])


@pytest.mark.parametrize("kind", KINDS)
def test_train_ensemble_on_the_cpu_leaves_params_and_captures_nothing(kind):
    cond, data, seeds = _data(kind, "cpu")
    params0 = init_ensemble(CFG, seeds, "cpu")
    p0 = {k: v.clone() for k, v in params0.items()}
    counters = _counters()
    tc = TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3, log_every=1, max_steps=3)
    res = train_ensemble(CFG, tc, cond, data, seeds, target_transform=channels_last,
                         params=params0, device="cpu")
    assert res.steps == 3
    assert all(torch.equal(params0[k], p0[k]) for k in p0)
    assert any(not torch.equal(res.params[k], p0[k]) for k in p0)
    assert _counters() == counters


# -- the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture
def deterministic(card, monkeypatch):
    """Deterministic algorithms, so that two runs of one step agree bit for
    bit (cuDNN's default backward kernels accumulate in any order)."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield card
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.card
@pytest.mark.parametrize("kind", KINDS)
def test_graphed_step_equals_the_eager_step(deterministic, kind):
    steps = 5
    source, params0, idxs = _setup(kind, deterministic, steps)
    p0 = {k: v.clone() for k, v in params0.items()}
    eager = _eager_fused_ensemble_step(source, make_ensemble_update(CFG, OPT))
    want = _run(eager, params0, idxs)
    graphed = make_fused_ensemble_step(source, CFG, OPT)
    assert isinstance(graphed, GraphedEnsembleStep)
    counters, launches = _counters(), zfp_codec.launch_counts()
    got = _run(graphed, params0, idxs)
    torch.cuda.synchronize()
    _assert_identical(got, want)
    captures, replays = _counters()
    assert (captures - counters[0], replays - counters[1]) == (1, steps - 1)
    after = zfp_codec.launch_counts()
    assert {k: n - launches[k] for k, n in after.items()} == {
        k: steps if k == "zfp_decode_blocks_fa" else 0 for k in after}
    assert all(torch.equal(params0[k], p0[k]) for k in p0)


@pytest.mark.card
def test_train_ensemble_on_the_card_leaves_params_and_replays(card):
    cond, data, seeds = _data("shared", card)
    params0 = init_ensemble(CFG, seeds, card)
    p0 = {k: v.clone() for k, v in params0.items()}
    counters = _counters()
    tc = TrainConfig(epochs=1, batch_size=BATCH, lr=1e-3, log_every=1, max_steps=4)
    res = train_ensemble(CFG, tc, cond, data, seeds, target_transform=channels_last,
                         params=params0, device=card)
    assert res.steps == 4 and all(np.isfinite(loss).all() for _, loss in res.losses)
    assert all(torch.equal(params0[k], p0[k]) for k in p0)
    assert any(not torch.equal(res.params[k], p0[k]) for k in p0)
    assert tuple(b - a for a, b in zip(counters, _counters())) == (1, 3)


@pytest.mark.card
def test_replays_keep_the_device_ranges_and_kernels_under_a_profiler(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    source, params0, idxs = _setup("shared", card, 8)

    def profiled(step, params, state, batch):
        obs_trace.shutdown(write=False)          # drop earlier captures' records
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for idx in batch:
                params, state, _ = step(params, state, idx)
            torch.cuda.synchronize()
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU
                   and not e.name().startswith(("Memcpy", "Memset"))]
        names = [e["name"] for e in obs_trace.capture_tracer().events()]
        return len(kernels), names

    counts = {}
    for name, step in (("eager", _eager_fused_ensemble_step(
            source, make_ensemble_update(CFG, OPT))),
            ("graphed", make_fused_ensemble_step(source, CFG, OPT))):
        params, state = params0, adam_init(params0, OPT)
        for idx in idxs[:2]:                     # the eager first step; the capture
            params, state, _ = step(params, state, idx)
        counts[name] = profiled(step, params, state, idxs[2:])
    n = len(idxs) - 2
    kernels, names = counts["graphed"]
    for rng, _ in GraphedEnsembleStep.STAGES:
        assert names.count(rng) == n, rng
    assert names.count("ensemble.replay") == n and "ensemble.capture" not in names
    assert kernels == counts["eager"][0] > 0
    assert counts["eager"][1].count("ensemble.replay") == 0


@pytest.mark.card
def test_a_capture_that_fails_raises(card):
    source, params0, idxs = _setup("shared", card, 2)
    step = make_fused_ensemble_step(source, CFG, OPT)
    params, state, _ = step(params0, adam_init(params0, OPT), idxs[0])
    grad = step.grad

    def syncing_grad():
        grad()
        float(step.loss.sum())                   # a device-to-host copy: not capturable

    step.grad = syncing_grad
    launches = zfp_codec.launch_counts()
    with pytest.raises(RuntimeError):
        step(params, state, idxs[1])
    assert step.graphs is None
    assert zfp_codec.launch_counts() == launches
    torch.cuda.synchronize()
