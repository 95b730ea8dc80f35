"""Architecture config schema + input-shape cells for the assigned pool."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0           # arctic: dense residual MLP in parallel
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid (hymba): parallel attn + SSM heads; SWA except global layers
    hybrid: bool = False
    attn_window: int = 0            # sliding-window size; 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    # modality frontend stub: precomputed embeddings
    frontend: str = "none"          # none | audio | vision
    frontend_dim: int = 0
    frontend_seq: int = 0           # vision: #patch tokens prepended
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # execution
    param_dtype: str = "bfloat16"
    remat: str = "full"             # full | dots | none
    seq_parallel: bool = False      # Megatron-SP: layer-boundary activations
                                    # sequence-sharded over "model" 
    attn_chunk: int = 1024          # q-chunk for memory-efficient attention
    moe_group: int = 1024           # tokens per MoE dispatch group
    capacity_factor: float = 1.25

    @property
    def hdim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-SWA)."""
        return self.family == "ssm" or (self.hybrid and self.attn_window > 0)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs; reason recorded when skipped."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic (DESIGN.md §5)"
    return True, ""
