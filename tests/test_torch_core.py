"""The port's metrics, variability bands, stats-only codec roundtrip,
Algorithm 1 and stacked Adam against the JAX package on the CPU.

The same seeded numpy inputs go through both packages.  Metrics agree to
rtol 1e-6 (float reductions in two runtimes); the variability bands, which
are numpy in both, exactly.  The stats-only roundtrip's coefficients,
exponents and plane counts are bit-identical and its byte counts equal.
Its per-sample L1 is a mean of the same f32 terms, which the port sums in
f64 and rounds once while XLA sums in f32: the two agree to
``sqrt(n) * 2^-24`` relative for n terms (``l1_close``), a random-walk
bound on an f32 sum's rounding error; XLA's reaches 9 ulp on these stacks.
Algorithm 1's tolerances, ratios and iteration counts equal JAX's on these
stacks: a decision could flip only where an L1 lies that close to ``e``,
and none does here.  Inside the port the fused and unfused searches agree
bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import metrics as jm
from repro.compression.zfp import (fa_plane_counts as jax_plane_counts,
                                   fa_precompute_batch as jax_precompute,
                                   fa_stats_batch as jax_stats)
from repro.core import tolerance as jtol
from repro.core import variability as jvar
from repro.train import optimizer as jopt

from repro_torch import metrics as tm
from repro_torch.compression import (FixedAccuracyCodec, fa_plane_counts,
                                     fa_precompute_batch, fa_stats_batch,
                                     sample_l1)
from repro_torch.core import tolerance as ttol
from repro_torch.core import variability as tvar
from repro_torch.train import optimizer as topt

torch.set_num_threads(2)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def field_stack():
    """Smooth fields plus noise, (12, 6, 48, 16), as tests/test_shards.py
    builds its stack."""
    r = np.random.default_rng(11)
    t = np.linspace(0, 1, 48)
    xx, yy = np.meshgrid(np.linspace(0, 1, 16), t)
    return np.stack([(np.sin(6 * xx + 0.2 * i) + 0.3 * np.cos(14 * yy * xx)
                      + 0.05 * r.standard_normal((6, 48, 16)))
                     .astype(np.float32) for i in range(12)])


def l1_close(got, want, n_terms: int) -> bool:
    """Per-sample L1 means of ``n_terms`` f32 terms agree to
    ``sqrt(n_terms) * 2^-24`` relative (infinities exactly)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    return bool(np.array_equal(got[~fin], want[~fin]) and np.all(
        np.abs(got[fin] - want[fin]) <= np.sqrt(n_terms) * 2.0 ** -24 * np.abs(want[fin])))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _fields(rng, shape=(3, 12, 8, 6)):
    """Positive fields: the sums carry no cancellation, so float32 sums in
    two runtimes agree to a relative tolerance."""
    return (np.abs(rng.standard_normal(shape)) + 0.5).astype(np.float32)


METRIC_CASES = {
    "psnr_grid": lambda m, a, b: m.psnr(a, b, axis=(-3, -2)),
    "psnr_default_axes": lambda m, a, b: m.psnr(a, b),
    "psnr_perfect_is_capped": lambda m, a, b: m.psnr(a, a, axis=(-3, -2)),
    "psnr_constant_reference": lambda m, a, b: m.psnr(a * 0 + 2.0, b, axis=(-3, -2)),
    "total_mass": lambda m, a, b: m.total_mass(a, cell_area=0.25),
    "total_momentum": lambda m, a, b: m.total_momentum(a, cell_area=0.25),
    "mixing_layer_thickness": lambda m, a, b: m.mixing_layer_thickness(a, 0.0, 9.0, dy=0.5),
    "timeseries_correlation": lambda m, a, b: m.timeseries_correlation(a, b),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_match_jax(rng, case):
    a = _fields(rng)
    b = a + 0.1 * np.abs(rng.standard_normal(a.shape)).astype(np.float32)
    fn = METRIC_CASES[case]
    want = np.asarray(fn(jm, a, b))
    got = fn(tm, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# variability (numpy in both packages: exact)
# ---------------------------------------------------------------------------

def _trajectories(rng, shape=(5, 20)):
    base = np.sin(np.linspace(0, 3, shape[1]))
    return [base + 0.05 * rng.standard_normal(shape[1:]) for _ in range(shape[0])]


@pytest.mark.parametrize("sigmas", [1.0, 2.0, 2.5])
def test_variability_matches_jax(rng, sigmas):
    seeds = _trajectories(rng)
    cands = [seeds[0], seeds[0] + 0.07, seeds[1] + 1.0]
    jb, tb = jvar.compute_band(seeds, sigmas), tvar.compute_band(seeds, sigmas)
    for field in ("mean", "std", "lo", "hi"):
        assert np.array_equal(getattr(jb, field), getattr(tb, field)), field
    assert jb.n_models == tb.n_models
    for c in cands:
        assert jvar.band_contains(jb, c, 0.9) == tvar.band_contains(tb, c, 0.9)
        assert jvar.dev_vs_seeds(jb, seeds, c) == tvar.dev_vs_seeds(tb, seeds, c)
        assert dataclasses.asdict(jvar.band_verdict(jb, seeds, c)) == \
            dataclasses.asdict(tvar.band_verdict(tb, seeds, c))
    with pytest.raises(ValueError, match="shape"):
        tvar.band_contains(tb, cands[0][:-1])
    assert tvar.train_seed_ensemble(lambda s: s * 2, (1, 2)) == \
        jvar.train_seed_ensemble(lambda s: s * 2, (1, 2))


# ---------------------------------------------------------------------------
# the stats-only roundtrip
# ---------------------------------------------------------------------------

def _stacks(field_stack):
    ragged = np.random.default_rng(3).standard_normal((5, 2, 10, 7)).astype(np.float32)
    zero = np.array(field_stack[:4])
    zero[1] = 0.0
    return {"fields": field_stack[:8], "ragged": ragged, "with_zero_sample": zero}


@pytest.mark.parametrize("stack", ["fields", "ragged", "with_zero_sample"])
def test_stats_roundtrip_matches_jax(field_stack, stack):
    xs = _stacks(field_stack)[stack]
    tols = (10.0 ** np.random.default_rng(1).uniform(-5, -0.5, len(xs))).astype(np.float32)
    js = jax_precompute(xs)
    ts = fa_precompute_batch(torch.from_numpy(xs))
    assert np.array_equal(ts.u_full.numpy(), np.asarray(js.u_full))
    assert np.array_equal(ts.emax.numpy(), np.asarray(js.emax))
    assert ts.padded_shape == tuple(js.padded_shape)
    assert np.array_equal(fa_plane_counts(ts, torch.from_numpy(tols)).numpy(),
                          np.asarray(jax_plane_counts(js, tols)))
    l1, nbytes = fa_stats_batch(ts, torch.from_numpy(tols))
    jl1, jnbytes = jax_stats(js, tols)
    assert np.array_equal(nbytes.numpy(), np.asarray(jnbytes))
    assert l1_close(l1.numpy(), jl1, xs[0].size)
    # the codec seam carries the same functions
    assert FixedAccuracyCodec.precompute is fa_precompute_batch
    assert FixedAccuracyCodec.stats is fa_stats_batch


@pytest.mark.parametrize("stack", ["fields", "ragged", "with_zero_sample"])
def test_stats_roundtrip_equals_codec_roundtrip(field_stack, stack):
    """Inside the port the stats path equals encode -> decode bit for bit."""
    xs = torch.from_numpy(_stacks(field_stack)[stack])
    tols = torch.from_numpy((10.0 ** np.random.default_rng(2).uniform(
        -5, -0.5, xs.shape[0])).astype(np.float32))
    codec = FixedAccuracyCodec()
    cf = codec.encode_batch(xs, tols)
    l1, nbytes = codec.stats(codec.precompute(xs), tols)
    assert torch.equal(nbytes, codec.nbytes(cf))
    assert torch.equal(l1.view(torch.int32),
                       sample_l1(codec.decode_batch(cf), xs).view(torch.int32))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

# 1e-12 is unreachable (the search ends with no solution); 0.003 overshoots
# the first guess (the halving path); 10.0 on a zero sample saturates
BATCH_ERRORS = [0.02, 0.005, 0.05, 0.001, 0.5, 0.0001, 0.01, 0.003, 1e-12, 10.0]


def _batch_stack(field_stack):
    xs = np.array(field_stack[:len(BATCH_ERRORS)])
    xs[-1] = 0.0
    return xs


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_find_tolerance_batch_matches_jax(field_stack, fused):
    xs = _batch_stack(field_stack)
    want = jtol.find_tolerance_batch(xs, BATCH_ERRORS, fused=fused)
    got = ttol.find_tolerance_batch(xs, BATCH_ERRORS, fused=fused, device="cpu")
    assert np.array_equal(got.tolerance, want.tolerance)
    assert np.array_equal(got.iterations, want.iterations)
    assert np.array_equal(got.ratio, want.ratio)
    assert np.array_equal(got.model_l1, want.model_l1)
    assert l1_close(got.compression_l1, want.compression_l1, xs[0].size)
    assert got.compression_l1[-2] == np.float32("inf") and got.ratio[-2] == 1.0
    assert got.iterations.max() <= 8


@pytest.mark.parametrize("max_iters", [8, 3])
def test_fused_search_equals_unfused(field_stack, max_iters):
    xs = _batch_stack(field_stack)
    a = ttol.find_tolerance_batch(xs, BATCH_ERRORS, max_iters=max_iters, device="cpu")
    b = ttol.find_tolerance_batch(xs, BATCH_ERRORS, max_iters=max_iters, fused=False,
                                  device="cpu")
    for field in ("tolerance", "compression_l1", "ratio", "iterations"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field
    assert a.iterations.max() <= max_iters


@pytest.mark.parametrize("i", [0, 3, 7, 8, 9])
def test_find_tolerance_matches_jax(field_stack, i):
    """The per-sample loop (the initial guess, the doubling, the halving
    path, no solution, saturation) against JAX's and against the port's
    batched search."""
    x = _batch_stack(field_stack)[i]
    e = BATCH_ERRORS[i]
    want = jtol.find_tolerance(x, e)
    got = ttol.find_tolerance(x, e, device="cpu")
    assert got.tolerance == want.tolerance
    assert got.iterations == want.iterations
    assert got.ratio == want.ratio
    assert l1_close([got.compression_l1], [want.compression_l1], x.size)
    br = ttol.find_tolerance_batch(x[None], [e], device="cpu")
    assert np.isclose(br.tolerance[0], got.tolerance, rtol=1e-6)
    assert int(br.iterations[0]) == got.iterations
    assert ttol.algorithm1_per_sample([x], [e], device="cpu")[0] == got


def test_find_tolerance_batch_checks_its_inputs(field_stack):
    with pytest.raises(ValueError, match="one model error per sample"):
        ttol.find_tolerance_batch(field_stack[:3], [0.1, 0.2], device="cpu")
    assert ttol.C_D == jtol.C_D


# ---------------------------------------------------------------------------
# Adam on stacked parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_clip", [None, 0.5, 1e3])
def test_stacked_adam_equals_member_updates(rng, grad_clip):
    """One update of (N, ...) stacks equals N member updates; a clipped one
    clips each member by its own norm (and JAX's update agrees)."""
    n = 3
    shapes = {"a.w": (4, 5), "a.b": (5,), "c.w": (2, 3, 3, 3)}
    params = {k: torch.from_numpy(rng.standard_normal((n,) + s).astype(np.float32))
              for k, s in shapes.items()}
    # members with gradients of very different norms, so a clip at 0.5
    # scales each member by another factor
    grads = {k: torch.from_numpy(rng.standard_normal((n,) + s).astype(np.float32))
             * torch.tensor([0.1, 1.0, 10.0]).reshape((n,) + (1,) * len(s))
             for k, s in shapes.items()}
    cfg = topt.AdamConfig(lr=1e-2, grad_clip=grad_clip)
    state = topt.adam_init(params, cfg)
    state = state._replace(m={k: v + 0.01 for k, v in state.m.items()},
                           v={k: v + 0.02 for k, v in state.v.items()})
    new, new_state = topt.adam_update(grads, state, params, cfg, stacked=True)
    jcfg = jopt.AdamConfig(lr=1e-2, grad_clip=grad_clip)
    for m in range(n):
        pick = lambda d: {k: v[m] for k, v in d.items()}
        one, one_state = topt.adam_update(
            pick(grads), topt.AdamState(state.step, pick(state.m), pick(state.v)),
            pick(params), cfg)
        jone, _ = jopt.adam_update(
            {k: v.numpy() for k, v in pick(grads).items()},
            jopt.AdamState(np.int32(0), {k: v.numpy() for k, v in pick(state.m).items()},
                           {k: v.numpy() for k, v in pick(state.v).items()}),
            {k: v.numpy() for k, v in pick(params).items()}, jcfg)
        for k in shapes:
            np.testing.assert_allclose(new[k][m].numpy(), one[k].numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(new_state.m[k][m].numpy(),
                                       one_state.m[k].numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(new[k][m].numpy(), np.asarray(jone[k]),
                                       rtol=1e-6, atol=1e-7)
    assert int(new_state.step) == 1
    norms = topt.global_norm(grads, stacked=True)
    assert norms.shape == (n,)
    for m in range(n):
        assert torch.allclose(norms[m], topt.global_norm({k: g[m] for k, g in grads.items()}))
