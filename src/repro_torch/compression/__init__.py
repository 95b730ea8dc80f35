"""ZFP-style error-bounded lossy compression on PyTorch tensors.

Public API:
  get_codec / FixedAccuracyCodec / FixedRateCodec / codec_from_plan
                                          -- the codec seam (api.py)
  encode_fixed_accuracy_batch / encode_fixed_rate_batch / decode_batch
  CompressedField                         -- tensors + sample geometry
  FAEncodeState / fa_precompute_batch / fa_stats_batch
                                          -- Algorithm 1's stats-only roundtrip
"""
from repro_torch.compression.transform import (MAX_WORDS, Q_FIXED_POINT,
                                               TOTAL_PLANES, blockify,
                                               deblockify)
from repro_torch.compression.zfp import (
    CompressedField,
    FAEncodeState,
    compressed_nbytes_batch,
    decode_batch,
    encode_fixed_accuracy_batch,
    encode_fixed_rate_batch,
    fa_plane_counts,
    fa_precompute_batch,
    fa_stats_batch,
    floor_log2,
    sample_l1,
    trim_to_nplanes,
)
from repro_torch.compression.api import (
    FixedAccuracyCodec,
    FixedRateCodec,
    codec_from_plan,
    codec_names,
    decode_stacked_payloads,
    get_codec,
)

__all__ = [
    "CompressedField",
    "FAEncodeState",
    "FixedAccuracyCodec",
    "FixedRateCodec",
    "MAX_WORDS",
    "Q_FIXED_POINT",
    "TOTAL_PLANES",
    "blockify",
    "codec_from_plan",
    "codec_names",
    "compressed_nbytes_batch",
    "deblockify",
    "decode_batch",
    "decode_stacked_payloads",
    "encode_fixed_accuracy_batch",
    "encode_fixed_rate_batch",
    "fa_plane_counts",
    "fa_precompute_batch",
    "fa_stats_batch",
    "floor_log2",
    "get_codec",
    "sample_l1",
    "trim_to_nplanes",
]
