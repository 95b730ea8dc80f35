"""Assigned architecture pool (exact configs from the assignment brief) plus
the paper's own surrogate configs.  ``get_config(name)`` / ``--arch <id>``.

Reduced variants (``reduced=True``) shrink depth/width/experts/vocab for CPU
smoke tests while preserving every structural feature (GQA ratios, MoE
routing, SSD state, hybrid heads, enc-dec wiring).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, MixedArchConfig

_REGISTRY: Dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


# --- hybrid ---------------------------------------------------------------
# hymba-1.5b [arXiv:2411.13676]: 32L d=1600 25H (kv=5) ff=5504 v=32001,
# parallel attn+mamba heads, SWA + 3 global-attn layers, ssm_state=16
HYMBA_1P5B = _register(ArchConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_heads=50, ssm_head_dim=64,
    attn_window=1024, global_attn_layers=(0, 15, 31)))

# --- audio enc-dec ---------------------------------------------------------
# seamless-m4t-large-v2 [arXiv:2308.11596]: 24L d=1024 16H (kv=16) ff=8192
# v=256206, enc-dec; frontend = precomputed speech frame embeddings (stub)
SEAMLESS_M4T = _register(ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=8192, vocab_size=256206,
    frontend="audio", frontend_dim=1024))

# --- vlm -------------------------------------------------------------------
# internvl2-2b [arXiv:2404.16821]: 24L d=2048 16H (kv=8) ff=8192 v=92553,
# InternViT patch embeddings (stub) + InternLM2 backbone
INTERNVL2_2B = _register(ArchConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553,
    frontend="vision", frontend_dim=1024, frontend_seq=256))

# --- moe -------------------------------------------------------------------
# arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d=7168 56H (kv=8)
# ff=4864(expert) v=32000, 128e top-2 + dense residual (moe_dense_ff=7168*?)
# Arctic: dense FFN 7168->? residual MLP; uses d_ff 4864 for experts and a
# dense residual MLP; we use the published dense intermediate 7168.
ARCTIC_480B = _register(ArchConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, moe_dense_ff=7168))

# qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H (kv=4) ff=768
# (per expert) v=151936, 128e top-8
QWEN3_MOE = _register(ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, experts_per_token=8))

# --- dense -----------------------------------------------------------------
# codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d=4096 32H (kv=32... GQA kv=32
# means MHA) ff=13440 v=92416, qwen1.5 arch (qkv bias)
CODEQWEN_7B = _register(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=13440, vocab_size=92416, qkv_bias=True))

# internlm2-1.8b [arXiv:2403.17297]: 24L d=2048 16H (kv=8) ff=8192 v=92544
INTERNLM2_1P8B = _register(ArchConfig(
    name="internlm2-1.8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92544))

# command-r-35b [hf:CohereForAI/c4ai-command-r-v01]: 40L d=8192 64H (kv=8)
# ff=22528 v=256000, no bias, tied embeddings
COMMAND_R_35B = _register(ArchConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, tie_embeddings=True))

# qwen2.5-14b [hf:Qwen/Qwen2.5-14B]: 48L d=5120 40H (kv=8) ff=13824 v=152064,
# QKV bias
QWEN2P5_14B = _register(ArchConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, qkv_bias=True))

# --- ssm -------------------------------------------------------------------
# mamba2-130m [arXiv:2405.21060]: 24L d=768 attn-free v=50280, ssd state=128
MAMBA2_130M = _register(ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_heads=24, ssm_head_dim=64, tie_embeddings=True))


# the pool the JAX package shares; the configurations below it are the
# port's alone
ALL_ARCHS = tuple(_REGISTRY)

# --- mixed -----------------------------------------------------------------
# granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small config.json,
# granitemoehybrid]: 40L d=4096 v=100352 tied; layer_types: Mamba2 (128 heads
# x 64, state 128, 1 group, conv 4 with bias, chunk 256) but attention at
# layers 5, 15, 25, 35 (GQA 32/8, head 128, NoPE, scale 1/128); on every
# layer an MoE of 72 SwiGLU experts of width 768, top-10, dropless, and a
# shared SwiGLU expert of width 1536; muP: embeddings x 12, residual
# branches x 0.22, logits / 16; RMSNorm eps 1e-5
GRANITE_4_H_SMALL = _register(MixedArchConfig(
    name="granite-4.0-h-small", family="mixed",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100352, tie_embeddings=True,
    num_experts=72, experts_per_token=10, shared_expert_ff=1536,
    ssm_state=128, ssm_heads=128, ssm_head_dim=64, ssm_conv=4, ssm_conv_bias=True,
    layer_kinds=tuple("attention" if i % 10 == 5 else "mamba" for i in range(40)),
    nope=True, attn_scale=1 / 128,
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
    norm_eps=1e-5))
PORT_ARCHS = tuple(a for a in _REGISTRY if a not in ALL_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; choices: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced_config(name: str) -> ArchConfig:
    """Structure-preserving miniature for CPU smoke tests.  A mixed stack
    keeps its first period of layer kinds (ten layers), all its experts
    held, at the same miniature widths."""
    cfg = get_config(name)
    if cfg.family == "mixed":
        return dataclasses.replace(
            cfg, num_layers=10, layer_kinds=cfg.layer_kinds[:10], d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, shared_expert_ff=48,
            vocab_size=512, num_experts=8, experts_per_token=3, ssm_state=16,
            ssm_heads=8, ssm_head_dim=16, attn_chunk=64, param_dtype="float32")
    heads = max(cfg.num_heads // 8, 2) if cfg.num_heads else 0
    kv = max(min(cfg.num_kv_heads, heads), 1) if cfg.num_kv_heads else 0
    if heads and kv:
        kv = max(heads // max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1), 1)
    return dataclasses.replace(
        cfg,
        num_layers=2, encoder_layers=2 if cfg.encoder_layers else 0,
        d_model=128, num_heads=heads, num_kv_heads=kv,
        head_dim=32 if cfg.num_heads else None,
        d_ff=max(cfg.d_ff // 32, 64) if cfg.d_ff else 0,
        vocab_size=512,
        num_experts=8 if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 4),
        moe_dense_ff=128 if cfg.moe_dense_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_heads else 0,
        ssm_head_dim=16 if cfg.ssm_heads else 64,
        frontend_dim=64 if cfg.frontend != "none" else 0,
        frontend_seq=16 if cfg.frontend == "vision" else 0,
        attn_window=64 if cfg.attn_window else 0,
        global_attn_layers=(0,) if cfg.global_attn_layers else (),
        moe_group=64, attn_chunk=64, param_dtype="float32")
