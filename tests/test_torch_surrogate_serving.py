"""The port's surrogate serving engine, load generator and launcher mode
against the JAX package's ``repro/serving/surrogate_engine.py``.

The fleet is the JAX package's: ``repro.core.ensemble.init_ensemble``,
each member carried across with ``params_from_jax`` and stacked.  Both
engines serve the same seeded mixed-length queries (zero-step rollouts
included).  Per query, the member mean must agree to ``FWD_ATOL`` (the
forward's tolerance of ``tests/test_torch_model.py``) and the band width
to ``4 * sigmas * FWD_ATOL``: a population std over members moves by at
most twice the largest member error, and the width is ``2 * sigmas`` stds.
Completion order and the engines' counts are deterministic and must be
equal.  The JAX modules are imported through ``torch_lm_reference``
(ROADMAP Queue 3, R1).
"""
import numpy as np
import pytest
import torch

from repro.core.ensemble import init_ensemble as jax_init_ensemble
from repro.models.surrogate import SurrogateConfig as JaxConfig

from repro_torch.core.variability import compute_band
from repro_torch.launch import serve as launcher
from repro_torch.models.folded import folded_forward
from repro_torch.models.surrogate import (SurrogateConfig, functional_forward,
                                          init_surrogate, member_params,
                                          params_from_jax, stack_params)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import SurrogateQuery, SurrogateServeEngine
from repro_torch.serving.loadgen import surrogate_workload

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

CFG = dict(height=32, width=16, base_channels=8)
SEEDS = (0, 1, 2)
SIGMAS = 2.0
FWD_ATOL = 2e-5
WIDTH_ATOL = 4 * SIGMAS * FWD_ATOL
ROLLOUTS = (0, 1, 2, 4, 7)


@pytest.fixture(scope="module")
def fleets():
    """(JAX stacked fleet, the port's stacked state dict of the same
    members)."""
    jfleet = jax_init_ensemble(JaxConfig(**CFG), SEEDS)
    ported = stack_params([
        params_from_jax({k: {n: np.asarray(v[m]) for n, v in leaf.items()}
                         for k, leaf in jfleet.items()})
        for m in range(len(SEEDS))])
    return jfleet, ported


def _engines(fleets, slots):
    jfleet, ported = fleets
    ref = load_reference().surrogate_engine
    return (ref.SurrogateServeEngine(jfleet, JaxConfig(**CFG), batch_slots=slots,
                                     sigmas=SIGMAS),
            SurrogateServeEngine(ported, SurrogateConfig(**CFG), batch_slots=slots,
                                 sigmas=SIGMAS, device="cpu"))


def _queries(n, seed=0, rate=None):
    return surrogate_workload(SurrogateConfig(**CFG).cond_dim - 1, n,
                              rollout_lens=ROLLOUTS, rate_qps=rate, seed=seed)


@pytest.mark.parametrize("rate", [None, 40.0])
def test_workload_is_the_reference_workload(rate):
    ref = load_reference().loadgen
    ours = surrogate_workload(7, 24, rollout_lens=ROLLOUTS, rate_qps=rate, seed=3)
    theirs = ref.surrogate_workload(7, 24, rollout_lens=ROLLOUTS, rate_qps=rate, seed=3)
    assert len(ours) == len(theirs) == 24
    for a, b in zip(ours, theirs):
        assert a.arrival == b.arrival and a.steps == b.steps
        assert a.params_vec.dtype == b.params_vec.dtype == np.float32
        assert np.array_equal(a.params_vec, b.params_vec)
        assert a.times.dtype == b.times.dtype and np.array_equal(a.times, b.times)
    assert isinstance(ours[0], SurrogateQuery)
    assert (rate is None) == all(q.arrival == 0 for q in ours)


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
def test_engine_matches_the_reference_engine(fleets, mode):
    jeng, peng = _engines(fleets, slots=4)
    jq, pq = _queries(14), _queries(14)
    index = {id(q): i for i, q in enumerate(pq)}
    jindex = {id(q): i for i, q in enumerate(jq)}
    jdone, pdone = getattr(jeng, mode)(jq), getattr(peng, mode)(pq)
    assert [jindex[id(q)] for q in jdone] == [index[id(q)] for q in pdone]
    assert len(pdone) == 14 and any(q.steps == 0 for q in pdone)
    for a, b in zip(jdone, pdone):
        assert b.mean.shape == b.width.shape == (b.steps, 32, 16, 6)
        assert b.mean.dtype == b.width.dtype == np.float32
        np.testing.assert_allclose(b.mean, a.mean, rtol=0, atol=FWD_ATOL)
        np.testing.assert_allclose(b.width, a.width, rtol=0, atol=WIDTH_ATOL)
        assert (b.width >= 0).all() and b.latency >= 0
    for k in ("queries", "field_evals", "steps"):
        assert peng.stats[k] == jeng.stats[k], k
    assert peng.slot_utilization == jeng.slot_utilization
    assert peng.queries_per_second > 0 and peng.num_members == len(SEEDS)


def test_run_and_lockstep_agree_and_zero_steps_return_as_they_are(fleets):
    _, ported = fleets
    cfg = SurrogateConfig(**CFG)
    a = SurrogateServeEngine(ported, cfg, batch_slots=3, device="cpu")
    b = SurrogateServeEngine(ported, cfg, batch_slots=3, device="cpu")
    empty = lambda: SurrogateQuery(np.zeros(cfg.cond_dim - 1, np.float32),
                                   np.zeros(0, np.float32))
    qa, qb = _queries(9, seed=5) + [empty()], _queries(9, seed=5) + [empty()]
    by_a = {i: q for i, q in enumerate(qa)}
    a.run(qa)
    b.run_lockstep(qb)
    for i, q in enumerate(qb):
        np.testing.assert_allclose(q.mean, by_a[i].mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q.width, by_a[i].width, rtol=0, atol=1e-6)
    zero = [q for q in qa if q.steps == 0]
    assert zero and all(q.mean.shape == (0, 32, 16, 6) for q in zero)
    assert a.slot_utilization > b.slot_utilization


def test_width_is_the_band_of_the_members(fleets):
    """One full batch: mean and width of the fleet step equal each member's
    own forward put through ``compute_band``."""
    _, ported = fleets
    cfg = SurrogateConfig(**CFG)
    eng = SurrogateServeEngine(ported, cfg, batch_slots=8, sigmas=SIGMAS, device="cpu")
    cond = torch.from_numpy(np.random.default_rng(2).random(
        (8, cfg.cond_dim)).astype(np.float32))
    mean, width = eng.fleet_step(cond)
    skeleton = init_surrogate(cfg, device="cpu")
    with torch.no_grad():
        preds = [functional_forward(skeleton, member_params(ported, m), cond).numpy()
                 for m in range(len(SEEDS))]
    band = compute_band(preds, sigmas=SIGMAS)
    assert mean.shape == width.shape == (8, 32, 16, 6)
    np.testing.assert_allclose(mean.numpy(), band.mean, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(width.numpy(), band.hi - band.lo, rtol=0, atol=WIDTH_ATOL)
    # on the fleet step's own member predictions the band is the formula's,
    # to float32 rounding
    with torch.inference_mode():
        own = compute_band(list(folded_forward(cfg, eng.members, cond.expand(
            len(SEEDS), -1, -1)).numpy()), sigmas=SIGMAS)
    np.testing.assert_allclose(mean.numpy(), own.mean, rtol=0, atol=1e-6)
    np.testing.assert_allclose(width.numpy(), own.hi - own.lo, rtol=0, atol=1e-6)
    # the population std, not the unbiased one
    unbiased = 2 * SIGMAS * np.stack(preds).std(0, ddof=1)
    assert np.abs(width.numpy() - unbiased).max() > 1e-3


def test_unstacked_or_foreign_fleets_raise(fleets):
    _, ported = fleets
    cfg = SurrogateConfig(**CFG)
    with pytest.raises(ValueError, match="stacked"):
        SurrogateServeEngine(member_params(ported, 0), cfg, device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        SurrogateServeEngine({k: v[:2] if k == "out.b" else v for k, v in ported.items()},
                             cfg, device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        SurrogateServeEngine({"w": torch.zeros(2, 3)}, cfg, device="cpu")
    eng = SurrogateServeEngine({k: v.numpy() for k, v in ported.items()}, cfg,
                               device="cpu")
    assert eng.members["out.w"].device.type == "cpu"


@pytest.fixture
def clean_telemetry():
    obs_trace.shutdown(write=False)
    obs_metrics.get_registry().reset()
    yield
    obs_trace.shutdown(write=False)
    obs_metrics.get_registry().reset()


def test_surrogate_serving_telemetry(fleets, clean_telemetry):
    """``tests/test_obs.py``'s ``test_surrogate_serving_telemetry`` on the port."""
    _, ported = fleets
    cfg = SurrogateConfig(**CFG)
    obs_trace.configure(run="serve")
    engine = SurrogateServeEngine({k: v[:2] for k, v in ported.items()}, cfg,
                                  batch_slots=2, device="cpu")
    queries = [SurrogateQuery(np.zeros(cfg.cond_dim - 1, np.float32),
                              np.linspace(0, 1, t).astype(np.float32))
               for t in (2, 3, 4)]
    done = engine.run(queries)
    assert len(done) == 3

    snap = obs_metrics.get_registry().snapshot()
    assert snap["surrogate_serve.queries"] == 3
    occ = snap["surrogate_serve.slot_occupancy"]
    assert occ["count"] == engine.stats["steps"]
    assert 0 < occ["mean"] <= 1.0
    lat = snap["surrogate_serve.query_latency_seconds"]
    assert lat["count"] == 3 and lat["p99"] >= lat["p50"] > 0

    evs = obs_trace.get_tracer().events()
    reqs = [e for e in evs if e["name"] == "surrogate_serve.query"]
    assert len(reqs) == 3
    assert all(e["args"]["queue_wait_s"] >= 0 for e in reqs)
    assert [e for e in evs if e["ph"] == "C"]   # occupancy counter track
    steps = [e for e in evs if e["name"] == "surrogate_serve.fleet_step"]
    assert len(steps) == engine.stats["steps"]
    assert all(e["args"]["members"] == 2 and 1 <= e["args"]["active"] <= 2
               for e in steps)


def test_launcher_serves_the_surrogate_on_the_cpu(capsys, tmp_path, clean_telemetry):
    done = launcher.main(["--mode", "surrogate", "--device", "cpu", "--requests", "6",
                          "--members", "3", "--trace-dir", str(tmp_path)])
    assert len(done) == 6 and all(q.mean is not None for q in done)
    out = capsys.readouterr().out
    assert "surrogate: 6 completed" in out and "3-member fleet" in out
    assert "device cpu" in out
    assert (tmp_path / "serve_surrogate.trace.json").exists()
    done = launcher.main(["--mode", "surrogate", "--device", "cpu", "--requests", "4",
                          "--lockstep"])
    assert len(done) == 4
