"""Model FLOPs of an LM training step on one chip's share, from the
configuration's shapes, whatever implements it; and the peak they are
held to.

A step is the forward and the backward (twice the forward: the gradients
of the inputs and of the weights); a recomputed forward is not model work
and is not counted.  The forward of a token counts each product with a
weight (multiply and add as two): a Mamba-2 layer's input and output
projections and its state space model in the chunked form (within a chunk
the causal half of ``C B^T`` and of its product with the inputs; a
chunk's state from its inputs and the state's reading through C), an
attention layer's four projections and the causal half of its scores and
their product with the values, the router, the held experts' SwiGLU at
their expected share of the pairs (``k`` pairs a token, ``held / E`` of
them here) and the shared expert on every layer, and the head over the
whole vocabulary.  Embedding lookups, norms, activations, the convolution,
the loss and Adam are elementwise and are not counted.
"""
from __future__ import annotations

# dense BF16 on the tensor cores of one H100 SXM (data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12


def forward_flops_per_token(cfg: dict, seq: int) -> float:
    """Forward model FLOPs of one token of a ``seq``-token sequence."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    nh, p, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    di, c = nh * p, min(cfg["mamba_chunk_size"], seq)
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    mamba = (2 * d * (2 * di + 2 * n + nh) + 2 * di * d      # projections
             + c * n + c * di                                # within a chunk, causal half
             + 2 * di * n + 2 * di * n)                      # a chunk's state, its reading
    attention = (2 * d * (2 * h * dh + 2 * hkv * dh)         # q, o; k, v
                 + 2 * 2 * h * dh * seq / 2)                 # scores and values, causal half
    pairs = cfg["num_experts_per_tok"] * cfg["num_local_experts"] / cfg["router_experts"]
    moe = (2 * d * cfg["router_experts"] + pairs * 3 * 2 * d * cfg["intermediate_size"]
           + 3 * 2 * d * cfg["shared_intermediate_size"])
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    layers = sum(mamba if k == "mamba" else attention for k in kinds) + len(kinds) * moe
    return layers + 2 * d * v


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step over ``batch`` sequences of ``seq``."""
    return 3.0 * batch * seq * forward_flops_per_token(cfg, seq)
