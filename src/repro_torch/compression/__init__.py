"""ZFP-style error-bounded lossy compression on PyTorch tensors.

Public API:
  get_codec / register_codec / codec_spec / codec_from_spec / FixedAccuracyCodec
  FixedRateCodec / ResidualCorrectedCodec / codec_from_plan
                                          -- the codec seam (api.py)
  encode_tree / decode_tree / tree_nbytes / TreeCodecMeta / LeafSpec
  leaf_2d_shape / tree_leaf_keys / tree_flatten / tree_map
                                          -- the tree codec (api.py)
  encode_fixed_accuracy_batch / encode_fixed_rate_batch / decode_batch
  encode_fixed_rate / decode_fixed_rate / encode_fixed_accuracy / decode
  compressed_nbytes / compression_ratio   -- one unbatched field
  Codec                                   -- what a codec provides
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
    compressed_nbytes,
    compressed_nbytes_batch,
    compression_ratio,
    decode,
    decode_batch,
    decode_fixed_rate,
    encode_fixed_accuracy,
    encode_fixed_accuracy_batch,
    encode_fixed_rate,
    encode_fixed_rate_batch,
    fa_plane_counts,
    fa_precompute_batch,
    fa_stats_batch,
    floor_log2,
    sample_l1,
    trim_to_nplanes,
)
from repro_torch.compression.api import (
    BACKENDS,
    Codec,
    FixedAccuracyCodec,
    FixedRateCodec,
    LeafSpec,
    ResidualCorrectedCodec,
    ResidualCorrectedField,
    TreeCodecMeta,
    TreeDef,
    as_tensor,
    codec_from_plan,
    codec_from_spec,
    codec_names,
    codec_spec,
    decode_stacked_payloads,
    decode_tree,
    encode_tree,
    get_codec,
    leaf_2d_shape,
    register_codec,
    tree_flatten,
    tree_flatten_with_path,
    tree_leaf_keys,
    tree_map,
    tree_nbytes,
)

__all__ = [
    "BACKENDS",
    "Codec",
    "CompressedField",
    "FAEncodeState",
    "FixedAccuracyCodec",
    "FixedRateCodec",
    "LeafSpec",
    "MAX_WORDS",
    "Q_FIXED_POINT",
    "ResidualCorrectedCodec",
    "ResidualCorrectedField",
    "TOTAL_PLANES",
    "TreeCodecMeta",
    "TreeDef",
    "as_tensor",
    "blockify",
    "codec_from_plan",
    "codec_from_spec",
    "codec_names",
    "codec_spec",
    "compressed_nbytes",
    "compressed_nbytes_batch",
    "compression_ratio",
    "deblockify",
    "decode",
    "decode_batch",
    "decode_fixed_rate",
    "decode_stacked_payloads",
    "decode_tree",
    "encode_tree",
    "encode_fixed_accuracy",
    "encode_fixed_accuracy_batch",
    "encode_fixed_rate",
    "encode_fixed_rate_batch",
    "fa_plane_counts",
    "fa_precompute_batch",
    "fa_stats_batch",
    "floor_log2",
    "get_codec",
    "leaf_2d_shape",
    "register_codec",
    "sample_l1",
    "tree_flatten",
    "tree_flatten_with_path",
    "tree_leaf_keys",
    "tree_map",
    "tree_nbytes",
    "trim_to_nplanes",
]
