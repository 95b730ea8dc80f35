"""The paper's contribution in the port (counterpart of ``repro/core``):

  tolerance      -- Algorithm 1: model-centric compression error tolerance
                    (per-sample loop + batched search, fused or unfused)
  variability    -- training-randomness bands (the +/-2 sigma yardstick)
                    and the benign/degraded band_verdict criterion
  ensemble       -- the N-seed trainer on stacked parameters (one step
                    advances every member) + certify_tolerance, the
                    end-to-end max-benign-tolerance pipeline with persisted
                    BandArtifacts
  grad_compress  -- error-feedback compressed gradient mean over a
                    torch.distributed group (compressed_psum_tree) and its
                    wire-byte accounting (tree_collective_bytes)

The ensemble names are re-exported lazily: importing them pulls in the
data and train layers.
"""
from repro_torch.core.tolerance import (
    BatchToleranceResult, ToleranceResult, algorithm1_per_sample,
    find_tolerance, find_tolerance_batch,
)
from repro_torch.core.grad_compress import (
    as_codec, compress_decompress, compressed_psum_tree, tree_collective_bytes,
)
from repro_torch.core.variability import (
    BandVerdict, VariabilityBand, band_contains, band_verdict, compute_band,
    dev_vs_seeds, train_seed_ensemble,
)
from repro_torch.data.store import (
    ArrayStore, CompressedArrayStore, IoStats, RawArrayStore,
)

_ENSEMBLE_EXPORTS = (
    "BandArtifact", "CandidateVerdict", "CertificationResult",
    "EnsembleResult", "certify_tolerance", "ensemble_train_step",
    "init_ensemble", "train_ensemble",
)

__all__ = [
    "BatchToleranceResult", "ToleranceResult", "algorithm1_per_sample",
    "find_tolerance", "find_tolerance_batch",
    "as_codec", "compress_decompress", "compressed_psum_tree",
    "tree_collective_bytes",
    "BandVerdict", "VariabilityBand", "band_contains", "band_verdict",
    "compute_band", "dev_vs_seeds", "train_seed_ensemble",
    "ArrayStore", "CompressedArrayStore", "IoStats", "RawArrayStore",
    "ShardedCompressedStore", *_ENSEMBLE_EXPORTS,
]


def __getattr__(name):
    if name == "ShardedCompressedStore":
        from repro_torch.data.shards import ShardedCompressedStore
        return ShardedCompressedStore
    if name in _ENSEMBLE_EXPORTS:
        from repro_torch.core import ensemble
        return getattr(ensemble, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
