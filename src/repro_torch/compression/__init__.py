"""ZFP-style error-bounded lossy compression on PyTorch tensors.

Public API:
  get_codec / FixedAccuracyCodec / FixedRateCodec -- the codec seam (api.py)
  encode_fixed_accuracy_batch / encode_fixed_rate_batch / decode_batch
  CompressedField                         -- tensors + sample geometry
"""
from repro_torch.compression.transform import (MAX_WORDS, Q_FIXED_POINT,
                                               TOTAL_PLANES, blockify,
                                               deblockify)
from repro_torch.compression.zfp import (
    CompressedField,
    compressed_nbytes_batch,
    decode_batch,
    encode_fixed_accuracy_batch,
    encode_fixed_rate_batch,
    floor_log2,
    trim_to_nplanes,
)
from repro_torch.compression.api import (
    FixedAccuracyCodec,
    FixedRateCodec,
    codec_names,
    decode_stacked_payloads,
    get_codec,
)

__all__ = [
    "CompressedField",
    "FixedAccuracyCodec",
    "FixedRateCodec",
    "MAX_WORDS",
    "Q_FIXED_POINT",
    "TOTAL_PLANES",
    "blockify",
    "codec_names",
    "compressed_nbytes_batch",
    "deblockify",
    "decode_batch",
    "decode_stacked_payloads",
    "encode_fixed_accuracy_batch",
    "encode_fixed_rate_batch",
    "floor_log2",
    "get_codec",
    "trim_to_nplanes",
]
