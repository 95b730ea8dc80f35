"""Training-variability bands (paper §III): the yardstick for compression.

A copy of ``repro/core/variability.py`` (pure numpy), kept in the port so
that it imports nothing of the JAX package.

Models trained with identical data/hyperparameters but different seeds form
a distribution over every quality metric; the +/-2 sigma band over seeds is
the natural noise floor.  A lossy-trained model whose metric trajectories
stay inside the band is indistinguishable from training randomness ==
compression is benign.

Two complementary criteria live here (held to the JAX package's in
tests/test_torch_core.py):

  band_contains  -- the paper's large-N criterion: fraction of trajectory
                    points inside the +/-sigmas band.
  dev_vs_seeds   -- the small-ensemble fallback: a 5-seed band can be
                    degenerately narrow, so also compare the candidate's
                    worst deviation from the seed mean against the worst
                    seed's own deviation.  The paper's 30-model band is the
                    large-N version of the same test.

``band_verdict`` combines them into the benign/degraded decision that
``repro_torch.core.ensemble.certify_tolerance`` uses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


@dataclasses.dataclass
class VariabilityBand:
    mean: np.ndarray      # (T,) or (T, K) mean metric over seed-models
    std: np.ndarray       # same shape
    n_models: int
    sigmas: float = 2.0   # 95% band

    @property
    def lo(self) -> np.ndarray:
        return self.mean - self.sigmas * self.std

    @property
    def hi(self) -> np.ndarray:
        return self.mean + self.sigmas * self.std


def compute_band(metric_per_model: Sequence[np.ndarray],
                 sigmas: float = 2.0) -> VariabilityBand:
    """metric_per_model: list over seeds of (T,)/(T,K) metric trajectories."""
    stack = np.stack([np.asarray(m) for m in metric_per_model])
    return VariabilityBand(mean=stack.mean(0), std=stack.std(0),
                           n_models=len(metric_per_model), sigmas=sigmas)


def _check_shape(band: VariabilityBand, trajectory: np.ndarray, what: str):
    t = np.asarray(trajectory)
    b = np.asarray(band.mean)
    if t.shape != b.shape:
        raise ValueError(
            f"{what} shape {t.shape} does not match band shape {b.shape}; "
            "refusing to broadcast -- a mismatched trajectory/band pair "
            "would silently compare misaligned points")
    return t


def band_contains(band: VariabilityBand, trajectory: np.ndarray,
                  frac_required: float = 0.95) -> tuple[bool, float]:
    """Is `trajectory` inside the band for >= frac_required of points?

    Returns (benign?, fraction inside).  The paper's criterion: compression
    is benign when the lossy model is indistinguishable from seed noise.
    Raises ValueError when the trajectory shape differs from the band's.
    """
    t = _check_shape(band, trajectory, "trajectory")
    inside = (t >= band.lo) & (t <= band.hi)
    frac = float(inside.mean())
    return frac >= frac_required, frac


def dev_vs_seeds(band: VariabilityBand,
                 seed_trajectories: Sequence[np.ndarray],
                 trajectory: np.ndarray) -> float:
    """Worst deviation of `trajectory` from the seed mean, as a multiple of
    the worst seed's own deviation.

    <= 1 means the candidate never strays further from the ensemble mean
    than the most extreme seed model does; a small multiple (the default
    allowance in ``band_verdict`` is 1.5) is still within training
    randomness for the handful-of-seeds regime where the +/-2 sigma band
    itself is unreliable.
    """
    t = _check_shape(band, trajectory, "trajectory")
    devs = [np.abs(_check_shape(band, s, "seed trajectory") - band.mean).max()
            for s in seed_trajectories]
    seed_dev = max(devs)
    return float(np.abs(t - band.mean).max() / max(seed_dev, 1e-9))


@dataclasses.dataclass
class BandVerdict:
    """Benign/degraded decision for one candidate trajectory vs a band."""
    benign: bool
    inside_frac: float
    dev_vs_seeds: float


def band_verdict(band: VariabilityBand,
                 seed_trajectories: Sequence[np.ndarray],
                 trajectory: np.ndarray,
                 frac_required: float = 0.9,
                 dev_allowance: float = 1.5) -> BandVerdict:
    """Combined small/large-ensemble criterion (paper Fig. 3 / Fig. 6).

    Benign when EITHER the trajectory sits inside the +/-sigmas band for
    ``frac_required`` of its points OR its worst deviation from the seed
    mean is within ``dev_allowance`` times the worst seed's own deviation.
    """
    ok, frac = band_contains(band, trajectory, frac_required)
    dev = dev_vs_seeds(band, seed_trajectories, trajectory)
    return BandVerdict(benign=bool(ok or dev <= dev_allowance),
                       inside_frac=frac, dev_vs_seeds=dev)


def train_seed_ensemble(train_fn: Callable[[int], object], seeds: Sequence[int]):
    """Train one model per seed with an identical configuration.

    train_fn(seed) -> model params (or any evaluation artifact); mirrors the
    paper's 5-30 raw-data models.  Sequential reference path -- the
    N-seeds-in-one-step trainer is repro_torch.core.ensemble.train_ensemble.
    """
    return [train_fn(int(s)) for s in seeds]
