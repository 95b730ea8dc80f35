"""Algorithm 1: model-centric compression error tolerance (paper §IV).

Counterpart of ``repro/core/tolerance.py``.  A model trained on lossless
data has its own L1 prediction error ``e`` per sample, which bounds the
detail it can learn (Threshold 2, Fig. 4).  The search starts at
``t = 4^d * e / c(d)`` (ZFP's expected-L1 calibration, c(2) = 1.089 from
Fox & Lindstrom) and doubles the L-inf tolerance while the realized L1
compression error stays at or below ``e``.  No model is retrained.

Two entry points:
  find_tolerance        -- the per-sample reference loop
  find_tolerance_batch  -- the doubling/halving search for a whole stack of
                           samples, each round one batched evaluation under
                           per-sample active masks

Both run on the card unless the caller passes ``device="cpu"``.  The
codec's tensors decide the route (:mod:`repro_torch.kernels.ops`): on the
card the roundtrip is kernel 2 (encode) and kernel 1 (decode), on the CPU
their plain versions.  The fused search (``fused=True``) replaces the
roundtrip by the codec's stats-only path, plain PyTorch on either device
as it is plain jnp in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.compression import FixedAccuracyCodec, sample_l1
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace as obs_trace

C_D = {1: 1.044, 2: 1.089, 3: 1.134, 4: 1.178}   # Fox & Lindstrom, Appendix A

_SEARCH_CODEC = FixedAccuracyCodec()


@dataclasses.dataclass
class ToleranceResult:
    tolerance: float            # final L-inf tolerance
    model_l1: float             # e: model output L1 error (the bound)
    compression_l1: float       # realized L1 error at `tolerance`
    ratio: float                # realized compression ratio
    iterations: int


def find_tolerance(sample: np.ndarray, model_l1_error: float,
                   d: int = 2, max_iters: int = 8,
                   device: DeviceLike = None) -> ToleranceResult:
    """Algorithm 1 for one sample (any (..., H, W) float array or tensor).

    ``model_l1_error``: mean |.| prediction error of the lossless-trained
    model on this sample, in the sample's normalization.  The tolerance is
    carried as a Python float and rounded to f32 for each encode, as the
    JAX package does.
    """
    dev = resolve_device(device)
    e = float(model_l1_error)
    if not isinstance(sample, torch.Tensor):
        sample = torch.as_tensor(np.asarray(sample, np.float32))
    x = sample.to(dev, torch.float32)

    def roundtrip(t):
        cf = _SEARCH_CODEC.encode_batch(
            x[None], torch.tensor([t], dtype=torch.float32, device=dev))
        xd = _SEARCH_CODEC.decode_batch(cf)
        l1 = float(sample_l1(xd, x[None])[0])
        return l1, float(x.numel() * 4 / int(_SEARCH_CODEC.nbytes(cf)[0]))

    t = (4.0 ** d) * e / C_D[d]
    best = None
    iters = 0
    while iters < max_iters:
        iters += 1
        l1, ratio = roundtrip(float(t))
        if l1 <= e:
            saturated = best is not None and ratio <= best.ratio * 1.01
            best = ToleranceResult(float(t), e, l1, ratio, iters)
            if saturated:       # all blocks at zero planes: ratio cannot grow
                break
            t *= 2.0
        else:
            break
    if best is None:        # initial guess already exceeded e: halve downward
        while iters < max_iters:
            iters += 1
            t /= 2.0
            l1, ratio = roundtrip(float(t))
            if l1 <= e:
                best = ToleranceResult(float(t), e, l1, ratio, iters)
                break
    if best is None:
        best = ToleranceResult(float(t), e, float("inf"), 1.0, iters)
    return best


def algorithm1_per_sample(samples: Sequence[np.ndarray],
                          model_l1_errors: Sequence[float],
                          d: int = 2,
                          device: DeviceLike = None) -> list[ToleranceResult]:
    """Per-sample adaptive tolerances for a dataset (paper Algorithm 1)."""
    return [find_tolerance(s, e, d=d, device=device)
            for s, e in zip(samples, model_l1_errors)]


# ---------------------------------------------------------------------------
# batched Algorithm 1: one search for a whole stack of samples
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchToleranceResult:
    """Vectorized ToleranceResult: every field is an (N,) array."""
    tolerance: np.ndarray
    model_l1: np.ndarray
    compression_l1: np.ndarray
    ratio: np.ndarray
    iterations: np.ndarray

    def __len__(self) -> int:
        return len(self.tolerance)

    def as_results(self) -> list[ToleranceResult]:
        return [ToleranceResult(float(self.tolerance[i]),
                                float(self.model_l1[i]),
                                float(self.compression_l1[i]),
                                float(self.ratio[i]),
                                int(self.iterations[i]))
                for i in range(len(self))]


def _search_batch(xs: torch.Tensor, es: torch.Tensor, t0: torch.Tensor,
                  max_iters: int, codec: FixedAccuracyCodec, fused: bool):
    """Doubling/halving searches of all samples, one round per loop trip.

    Per-sample masks replicate the reference control flow: double while
    the realized L1 stays under ``e`` (stopping when the ratio saturates),
    halve downward when the initial guess overshoots, freeze a sample the
    moment its search ends.  Each round evaluates the whole stack once and
    updates the state term by term as the JAX package's ``lax.while_loop``
    body does; the loop stops when no sample is active, after at most
    ``max_iters`` rounds (each round counts one iteration of every active
    sample).
    """
    n = xs.shape[0]
    dev = xs.device
    sample_size = float(np.prod(xs.shape[1:]))
    raw = torch.tensor(sample_size * 4.0, dtype=torch.float32, device=dev)
    if fused:
        state = codec.precompute(xs)

        def evaluate(t):
            l1, nbytes = codec.stats(state, t)
            return l1, raw / nbytes.to(torch.float32)
    else:
        def evaluate(t):
            cf = codec.encode_batch(xs, t)
            l1 = sample_l1(codec.decode_batch(cf), xs)
            return l1, raw / codec.nbytes(cf).to(torch.float32)

    slack = torch.tensor(1.01, dtype=torch.float32, device=dev)
    t = t0
    best_t = torch.zeros(n, dtype=torch.float32, device=dev)
    best_l1 = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    best_ratio = torch.ones(n, dtype=torch.float32, device=dev)
    have_best = torch.zeros(n, dtype=torch.bool, device=dev)
    going_down = torch.zeros(n, dtype=torch.bool, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    iters = torch.zeros(n, dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        active = ~done
        l1, ratio = evaluate(t)
        iters = iters + active.to(torch.int32)
        ok = l1 <= es

        # success: record best; stop if the ratio saturated (all blocks
        # already at zero planes) or if this was the halving phase's first
        # success
        rec = active & ok
        saturated = have_best & (ratio <= best_ratio * slack)
        best_t = torch.where(rec, t, best_t)
        best_l1 = torch.where(rec, l1, best_l1)
        best_ratio = torch.where(rec, ratio, best_ratio)
        stop_ok = rec & (saturated | going_down)

        # failure: an overshoot ends a doubling search; a fresh failure
        # flips the sample into the halving phase
        fail = active & ~ok
        stop_fail = fail & have_best
        go_down = fail & ~have_best
        have_best = have_best | rec

        new_done = done | stop_ok | stop_fail | (iters >= max_iters)
        t_next = torch.where(rec & ~stop_ok, t * 2.0, t)
        t_next = torch.where(go_down, t_next * 0.5, t_next)
        # a sample that just ended keeps its last evaluated tolerance
        t = torch.where(new_done, t, t_next)
        going_down = going_down | go_down
        done = new_done
    tolerance = torch.where(have_best, best_t, t)
    l1 = torch.where(have_best, best_l1, torch.full_like(best_l1, float("inf")))
    ratio = torch.where(have_best, best_ratio, torch.ones_like(best_ratio))
    return tolerance, l1, ratio, iters


def find_tolerance_batch(samples: np.ndarray | Sequence[np.ndarray],
                         model_l1_errors: Sequence[float] | np.ndarray,
                         d: int = 2, max_iters: int = 8,
                         codec: Optional[FixedAccuracyCodec] = None,
                         fused: bool = True,
                         device: DeviceLike = None) -> BatchToleranceResult:
    """Algorithm 1 for a stack of same-shape samples, on ``device`` (the
    card unless ``device="cpu"``).

    Equal to ``[find_tolerance(s, e) for s, e in zip(...)]`` run in f32:
    every round evaluates all samples with one batched codec call.
    ``fused=True`` evaluates through the codec's stats-only path (plain
    PyTorch); ``fused=False`` through the whole roundtrip, which on the
    card is kernel 2 then kernel 1.  Both give the same bits.  The start
    ``t = 4^d * e / C_D[d]`` is computed in f32 as XLA computes it.
    """
    dev = resolve_device(device)
    xs = np.asarray(samples if isinstance(samples, np.ndarray)
                    else np.stack([np.asarray(s, np.float32) for s in samples]),
                    np.float32)
    es = np.asarray(model_l1_errors, np.float32)
    if xs.shape[0] != es.shape[0]:
        raise ValueError(f"{es.shape[0]} model errors for {xs.shape[0]} samples: "
                         "one model error per sample")
    # XLA turns the division by the constant into a multiply by its f32
    # reciprocal; the same bits here
    t0 = (np.float32(4.0 ** d) * es) * (np.float32(1.0) / np.float32(C_D[d]))
    xs_t = torch.from_numpy(np.ascontiguousarray(xs)).to(dev)
    with obs_trace.span("tolerance.search_batch", cat="certify",
                        samples=int(xs.shape[0])) as sp:
        tol, l1, ratio, iters = _search_batch(
            xs_t, torch.from_numpy(es).to(dev), torch.from_numpy(t0).to(dev),
            max_iters, _SEARCH_CODEC if codec is None else codec, fused)
        iters = iters.cpu().numpy()
        sp.set(max_iterations=int(iters.max(initial=0)))
    return BatchToleranceResult(tol.cpu().numpy(), es, l1.cpu().numpy(),
                                ratio.cpu().numpy(), iters)
