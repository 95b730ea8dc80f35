#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --codec [--baseline CSRC ...]

Needs one CUDA card, the CUDA toolkit (``nvcc`` under ``$CUDA_HOME`` or on
``PATH``) and this checkout's ``src/``.  It builds the kernels (the four
ZFP kernels, fixed-accuracy and fixed-rate encode and decode, flash
attention, and the surrogate's layer norm + LeakyReLU pair) from
``src/repro_torch/csrc`` into ``build/``, all ``nvcc`` processes started
together, holds the layer norm + LeakyReLU pair against its plain twins
(``kernels/ref.py``) at every block shape of the 512x512 and 768x256
surrogates at batch 64 (y bit for bit from the kernel's own statistics,
two backward calls bit for bit) and times it at the 512x512 blocks and at
the device-resident path's, holds each ZFP kernel against its plain PyTorch
version bit for bit (on the CPU: the main path's data, the F1 blocks, block
counts around a warp's and a CTA's blocks, every fixed-rate width, a set
of blocks that needs each of 0..6 correction passes, blocks holding NaN and
+-inf; on the card: the whole store at per-sample tolerances; the gathered
decode on the resident store and on small ragged stores at every width and
plane count) and each of the attention kernel's
three variants (the wgmma + TMA prefill, the split-KV decode and the
scalar kernel) against its plain version on the card to a stated
tolerance, asserting which variant ran, then runs twelve paths at full
model width:

* the device-resident path (the paper's workflow 2 with the store in device
  memory): encode a synthetic study into a device-resident store and train
  the DCGAN surrogate with the gathered decode (one launch a batch) + L1 +
  Adam on the card, its five layer norm + LeakyReLU blocks one forward and
  one backward launch pair each a step;
* the certification path (the paper's steps 5-7): a 4-seed ensemble on
  stacked parameters (one member-folded step, one gathered decode a step
  for all members) held to its members run one by one, and a member trained on
  another member's batches shown to fail the same limits; one step's
  gather from the shared store and from the sweep's stacked candidate
  stores held bit for bit to the plain decode and to each member's own
  store; Algorithm 1 on every sample,
  fused (plain PyTorch stats) against unfused (kernels 2 and 1) bit for
  bit and against the CPU; ``certify_tolerance`` with device-resident
  candidate stores at six tolerance multiples (the band, the verdicts, the
  stores' bounds, the artifact read back); and the ensemble on one shared
  and on two per-member host-streaming sharded stores;
* the surrogate serving path: the certification path's 4-member fleet
  serves 64 mixed-length rollout queries through ``SurrogateServeEngine``
  (8 slots, bands at 2 sigma) with continuous batching, in lockstep and in
  open loop at half the closed loop's rate; every query's mean and width
  finite and of field shape, the two modes agreeing, the fleet step held
  to each member's own forward through ``compute_band`` and the card to a
  CPU copy of the fleet, the schedule's counts to the CPU engine's; the
  fleet step profiled folded and with the members one after another; one
  traced run (the serve, 10 device-resident and 10 host-streaming steps
  with the prefetch worker) whose spans, first-step split and recompile
  watch are checked and read back by ``tools/trace_report.py``;
* the checkpoint path (lossy and certified checkpoints, exact resume,
  compressed gradients) on the same model and store: a fresh run of 102
  steps saving every 20 against a run preempted at step 50 and resumed
  from step 40, final parameters and post-resume losses bit for bit under
  deterministic algorithms (and the same comparison without them, printed
  as a reading); raw, fixed-rate 13-bit, certified fixed-accuracy (per-leaf
  tolerances from Algorithm 1 on the last step's displacement) and
  residual-corrected (1e-3) checkpoints of the trained state, each restore
  within its bound and every ``.npz`` array equal to the same save from a
  CPU copy of the state (plain versions); a certifying save inside
  ``train_surrogate``; ``ops.encode_field``/``decode_field`` against the
  CPU; one step's gradients through ``compressed_psum_tree`` on a one-rank
  NCCL group at 8 and 16 bits and at fixed accuracy 1e-3, against the CPU
  plain versions on a gloo group;
* the datagen path (simulate, encode on the card, sharded store): the
  spectral solver on the card held to the same solver on the CPU (at the
  solver tests' grids and at PCHIP_SPEC's full grid; RT_SPEC's full grid
  on the card alone, its CPU reference cut for the script's time; mass
  drift and kinetic energy checked), two runs and the CUDA graph
  against the eager run bit for bit, its kernels per RK3 step profiled;
  ``produce`` of RT_SPEC x 32 and PCHIP_SPEC x 4 members at tol 1e-3 in
  shards of 32 (kernel 2, one launch a chunk) held byte for byte to an
  in-memory ``ShardedCompressedStore`` of the same fields, every decoded
  sample within its tolerance; sequential production and a run stopped
  after 3 shards and resumed, each byte for byte against the overlapped
  run; a fixed-rate plan (kernel 4) held to the plain encoder; 30 training
  steps from the produced path (kernel 3) and ``certify_tolerance`` from
  it (kernels 3, 2 and 1);
* the host-streaming path (workflows 1 and 2 from disk): write a raw store,
  a per-sample fixed-accuracy store, a sharded store and a per-sample
  fixed-rate store to a temporary directory (removed at exit), and train
  from each, with and without the prefetch worker and, for the raw and
  sharded stores, at the paper's emulated workspace bandwidth;
* the paper's study and the surrogate examples: the quickstart as
  written, ``examples/train_surrogate_torch.py`` at full width (RT_SPEC,
  base 256, a compressed store, 16-bit lossy checkpoints: kernel 4) and
  again on its checkpoint directory (it resumes and trains nothing),
  ``repro_torch.study.build_study`` at ``benchmarks/common.py``'s sizes
  (16 RT members of 48x16, 5 seeds, lossy models at x0.5-x16; array
  shapes those of the JAX study's ``study.npz``, ratios rising with the
  multiple, Algorithm 1 equal to the plain search on the CPU bit for bit)
  and ``examples/compression_study_torch.py`` on that study (exact resume
  under deterministic algorithms), printed beside the JAX study;
* LM serving: ``internlm2-1.8b`` at full width (24 layers, bf16, random
  weights from a seeded generator) serves 16 mixed-length requests with
  continuous batching and the first 8 again in lockstep, 8 slots, an f32 KV cache of
  1,088 positions (every prefill launch must run the wgmma prefill and
  every decode launch the split-KV decode); the served tokens are replayed
  teacher-forced with the kernel and with the plain attention, and their
  logits compared;
* LM training: the launcher (``python -m repro_torch.launch.train``) on
  the card, then resumed from its step-5 checkpoint (two subprocesses,
  run beside the kernel build and checks; nothing of them is timed); one
  ``train_step`` at
  full width with 2 layers in f32 against a CPU copy (loss, every
  gradient, the updated parameters); ``internlm2-1.8b`` at full width and
  depth (bf16, remat "full", batch 2 x 4,096): every gradient finite and
  the attention weights' nonzero with no kernel-5 launch under autograd,
  ``lm_forward`` against ``lm_prefill`` (kernel 5) on 1,024 tokens, 5
  timed and 3 profiled steps of ``train_step``, 3 steps of the
  compressed-gradient example (``examples/lm_pretrain_torch.py``: kernels
  4 and 1 on every gradient leaf, error feedback checked leaf by leaf) and
  a fixed-rate 14-bit checkpoint of the trained parameters restored bit
  for bit against ``decode_tree(encode_tree(leaf))``;
* the SSM and hybrid LM families: ``mamba2-130m`` and ``hymba-1.5b`` at
  full width and depth (bf16, random weights) serve 16 and 8 requests with
  continuous batching and 8 each in lockstep (8 slots; hymba's prompts up to
  2,048 tokens, past its 1,024-key window; every hymba prefill launch the
  wgmma prefill, every decode launch the split-KV decode, none the scalar
  kernel; mamba2 none at all); one request served alone against the
  batch (teacher-forced logits, tokens up to a tie); ``lm_forward``
  against ``lm_prefill``; 10 decode steps profiled; kernel 5 against its
  plain version and timed at hymba's shapes (group 5, D 64, the window and
  none); training at 2 x 4,096 (5 and 3 steps), mamba2's compressed-
  gradient example (kernels 4 and 1 once a leaf a step) and an FR-14
  checkpoint; one loss and its gradients with 2 layers in f32 against the
  CPU;
* the MoE LM family: ``qwen3-moe-30b-a3b`` at full width and depth (bf16,
  random weights, 30.5 B parameters) serves 8 requests with continuous
  batching and in lockstep, at its capacity factor (8
  slots, prompts of 128 and 1,024 tokens; every prefill launch the wgmma
  prefill, every decode launch the split-KV decode); two requests alone
  against the batch with lossless dispatch (tokens up to a tie); 10
  decode steps profiled beside the bound of reading every expert; a
  1,024-token prefill timed; ``lm_forward`` against ``lm_prefill`` on the
  first 2 layers, and at full depth beside a prefill through the plain
  attention; on the card a tied
  router picking experts 0..k-1 and dropping the tokens past capacity,
  and a prefill group off the reference's ``moe_group`` rule raising its
  ``ValueError``; training at full width with 2 layers (2 x 4,096); one
  loss and its gradients with 1 layer in f32 against the CPU, and a
  control with bf16 expert products outside that limit;
  ``arctic-480b`` at full width with 2 layers (its dense residual MLP and
  56/8 GQA) against its prefill and serving 4 requests; kernel 5 against
  its plain version and timed at both models' groups (8 and 7);
* the VLM and encoder-decoder LM families: ``internvl2-2b`` at full width
  and depth (bf16, random weights, 256 image tokens) serves 8 requests
  from tokens alone through ``ServeEngine.run`` and one image request
  (256 seeded image embeddings and 512 prompt tokens) through
  ``lm_prefill`` and 32 greedy ``serve_step`` calls; ``seamless-m4t-large-v2``
  at full width and depth (24 encoder and 24 decoder layers) serves 8
  requests of 1,024 seeded frames and 128-512 prompt tokens through
  ``lm_prefill`` and 32 greedy ``serve_step`` calls at per-slot positions
  (every attention call of both through kernel 5: the encoder's and the
  cross-attention's non-causal, the plain versions refused), one request
  alone against the batch (tokens up to a tie); each family's decode
  logits, teacher-forced, against ``lm_forward``; 10 decode steps
  profiled; training at 2 x (256 image + 3,840) and 2 x (2,048 frames +
  2,048) tokens; one loss and its gradients with 2 layers (and 2 encoder
  layers) in f32 against the CPU; kernel 5 against its plain version at
  their shapes (the non-causal prefill with as many, more and fewer
  queries than keys, the non-causal decode against the f32 cross cache,
  group 1 at D 64) and timed there;
* the multi-device launch on a one-rank NCCL mesh: ``internlm2-1.8b`` at
  full width with 2 layers, its parameters and batches DTensors, the dry
  run's sharded train step against the plain one (loss, gradients,
  updated parameters; both timed), a sharded prefill and 8 decode steps
  through kernel 5 under ``local_map`` against the plain ones, and the
  pod-compressed step on a one-pod mesh, its exchange held bit for bit to
  ``compress_decompress``; beside the kernel build, ``launch.train
  --dry-run`` of ``internlm2-1.8b x train_4k`` on the 16x16 mesh, on the
  CPU, as a subprocess.

It prints the card's name and power limit, per run the median step time,
the summed fetch wait and the store's ``IoStats``, the ensemble's and the
sweep's dispatch medians beside the single model's step median, the
kernels per ensemble step and its device busy share, Algorithm 1's seconds and iterations, the
candidate stores' build times and the certification's summary and verdict,
the serving phase's queries/s, p50/p99 and fleet-step profiles (one
``surrogate_serving`` JSON line) and the traced runs' first-step and
steady-state times, the checkpoint phase's step medians with and without deterministic
algorithms, each checkpoint mode's stored/raw, save and restore seconds
and largest restore error beside its bound, and the gradients' wire bytes,
the solver's time per member (CUDA graph and eager) and kernels per RK3
step, the produced stores' ratios, the producer's samples per second
(overlapped and sequential) and the certification from the produced path,
the serving rates and latencies, the attention variants' times at the main
path's shapes beside
the scalar variant's, the plain version's, each SDPA backend's (for the
decode also on the kernel's own function: q upcast to f32 against the f32
cache) and the bound, the LM training phase's readings (one
``lm_training`` JSON line: losses, step median, tokens/s, peak memory,
the profile, the compressed step, the checkpoint), one ``recurrent_lm``
JSON line (per family the serving modes, the solo checks, the decode
profile, training, the CPU check; kernel 5 at hymba's shapes), one ``moe_lm`` JSON line
(the serving modes, the decode profile and its bounds, the solo and
tied-router checks, training, the CPU check, arctic's readings, kernel 5
at both groups), one ``frontend_lm`` JSON line (per family the serving
readings, the decode against the forward, the solo check, the decode
profile, training, the CPU check; kernel 5 at seamless's shapes), one ``sharded_lm`` JSON
line (the sharded and plain steps' times and readings, the variants under
``local_map``, the exchange), one ``examples`` JSON line (the card's
study and the JAX study's, each section's seconds and launches), one
``kernels`` JSON line (launches on the paths, agreement, times,
bounds and the library yardstick; kernel 5 also per variant), and as its
last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line.  A device busy share is the union of the device's activity
intervals over the wall time (``device_busy_us``), never over 100%.
Precision: float32 with TF32 off; the LM runs in bf16.

With ``--codec`` it builds, checks and times only the four ZFP kernels
(each with its registers and spills from ``ptxas``) and ends with a
``{"codec": ...}`` line; each ``--baseline`` names another checkout's
``csrc`` directory whose ZFP kernels are built too and timed in turns with
these (before and after a change, in one run on one card).

With ``--ranks N`` (N even, N cards) it runs only the sharded prefill and
decode of ``internlm2-1.8b`` (2 layers, full width, bf16) on a (data 2,
model N / 2) NCCL mesh across the cards, one process a card, against the
plain ones, and ends with a ``{"multi_card_serving": ...}`` line: the
cache's sequence is split over "model", so every decode step goes through
kernel 5's partial entry and the shards merge across the cards.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).  The
# codec's integer work is counted at the f32 non-tensor rate, which is at
# least the card's int32 rate, so the bound stays a lower bound.
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12

# main-path configuration: SurrogateConfig() = 96x32 grid, 6 fields,
# base_channels 256 (RT_SPEC); 64 sims x 51 snapshots of synthetic data
N_SAMPLES = 64 * 51
TOLERANCE = 1e-3
BATCH, LR, STEPS = 64, 1e-4, 30
# the layer norm + LeakyReLU pair against its plain twins: the card tests'
# limit (tests/test_torch_ln_lrelu.py), relative to each tensor's largest
# magnitude, and for dg and db to the sum of their terms' magnitudes
LN_RTOL = 1e-5
CHECK_SAMPLES = 128                  # 147,456 main-path blocks held to the CPU
LOSS_RTOL = 1e-4                     # first-step loss, card vs CPU (f32 convs)
# host-streaming path: fixed-rate store at 12 bits per value, shards of 32
# samples, and the paper's workspace file system as an emulated bandwidth
# (benchmarks/loading_throughput.py:23)
HOST_STEPS = 30
FR_BITS = 12
FR_CHECK_BITS = (1, 2, 7, 12, 13, 16, 29, 30)
SHARD_SIZE = 32
# block counts of the lane kernels' edge checks: one and two blocks, a warp's
# worth plus one, and counts that leave a CTA (16 blocks) partly filled
CHECK_NB = (1, 2, 3, 31, 33, 4103)
WORKSPACE_MBS = 145.65
# certification path (main path steps 5-7) on the same model and samples:
# four seeds, 10 ensemble steps against the members run one by one, then
# certify_tolerance at the JAX package's default multiples for two epochs
# (102 steps) with the first 256 samples as its eval set
ENS_SEEDS = (0, 1, 2, 3)
ENS_STEPS = 10
CERT_MULTIPLES = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
CERT_EPOCHS = 2
EVAL_SAMPLES = 256
# ensemble vs its members run one by one (the ensemble's convolutions are
# grouped, so cuDNN runs other algorithms; an L1 gradient sign that float
# noise flips moves an element by 2 LR a step): logged losses to
# ENS_LOSS_RTOL; final params by the quantile criterion of
# tests/test_ensemble.py:43-58 and, per parameter tensor, by the distance to
# the run alone over the run alone's own movement from its initial values
# (ENS_PARAM_REL).  A planted fault, a member trained on another member's
# batches, must exceed both ENS_LOSS_RTOL and ENS_PARAM_REL.
ENS_LOSS_RTOL = 1e-4
ENS_PARAM_REL = 0.1
ENS_PARAM_MAX, ENS_PARAM_Q99, ENS_PARAM_MEDIAN = 2e-2, 1e-3, 1e-4
# datagen path (Queue 1 item 7): the solver on the card against the CPU at
# tests/test_solver.py's grids and parameters (SOLVER_SMALL_RTOL of each
# field's largest magnitude) and at PCHIP_SPEC's full grid (SOLVER_FULL_RTOL:
# the instability amplifies rounding; RT_SPEC's: SOLVER_FULL_CPU); the kinetic-energy
# bound is tests/test_solver.py's 100 at 32x16 cells, per cell.  Production
# of RT_SPEC x 32 and PCHIP_SPEC x 4 at TOLERANCE in shards of SHARD_SIZE;
# kill (after 3 shards) and resume, and sequential production, on RT_SPEC x
# 4; a fixed-rate plan of RT_SPEC x 2 at FR_BITS
SOLVER_GRIDS = (("16x8/40", dict(ny=16, nx=8, nsteps=40, nsnaps=5)),
                ("32x16/300", dict(ny=32, nx=16, nsteps=300, nsnaps=11)))
SOLVER_SMALL_RTOL, SOLVER_FULL_RTOL = 1e-5, 1e-3
# the sampled RT member's card-vs-CPU reading: RT_SPEC's grid and its 40 steps
# a snapshot, over 12 of its 50 snapshot intervals (cut from all 50, for the
# script's time)
SOLVER_READING = dict(nsteps=480, nsnaps=13)
# full grids held to the CPU: PCHIP's (2.6 s of CPU); RT's CPU reference
# (5-11 s by host) is cut for the script's time, its grid still
# run on the card against itself, its graph, its mass and its energy
SOLVER_FULL_CPU = ("pchip",)
KE_BOUND_PER_CELL = 100.0 / (32 * 16)
DG_RT_MEMBERS, DG_PCHIP_MEMBERS = 32, 4
DG_RESUME_MEMBERS, DG_RESUME_SHARDS = 4, 3
DG_FR_MEMBERS = 2
# LM serving path: internlm2-1.8b at full width (configs/registry.py), 16
# requests of the seeded mixed workload, 8 slots, max_seq 1088 (the longest
# prompt plus the longest generation)
LM_ARCH = "internlm2-1.8b"
# (run_lockstep on the first LM_LOCKSTEP_REQUESTS of them, cut from 16 for
# the script's time, as the later phases' lockstep runs)
LM_REQUESTS, LM_SLOTS, LM_MAX_SEQ = 16, 8, 1088
LM_PROMPTS, LM_NEW = (256, 512, 1024), (16, 32, 64)
LM_LOCKSTEP_REQUESTS = 8
# attention kernel vs plain version, as tests/test_kernels.py:158
ATTN_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# teacher-forced logits, kernel vs plain attention, through 24 bf16 layers:
# the two round attention outputs to bf16 differently, and the residual
# stream carries those bf16 differences on (logits are about N(0, 1))
LOGIT_ATOL = 0.25
# surrogate serving path (Queue 1 item 10): the certification phase's
# 4-member fleet serves SERVE_QUERIES queries of the seeded mixed workload
# (rollouts of 1, 2, 4 and 16 steps) in SERVE_SLOTS slots, bands at
# SERVE_SIGMAS.  The fleet step (folded, grouped convolutions) against each
# member's own forward and the card against a CPU copy of the fleet: mean
# to SERVE_ATOL, width to 4 * SERVE_SIGMAS * SERVE_ATOL (f32 convolutions
# in other algorithms; a population std moves by at most twice the largest
# member error, and the width is 2 * sigmas stds).  The traced runs: the
# closed-loop serve, TRACE_STEPS steps on the resident store and
# TRACE_STEPS host-streaming steps with the prefetch worker
SERVE_QUERIES, SERVE_SLOTS, SERVE_SIGMAS = 64, 8, 2.0
SERVE_ROLLOUTS = (1, 2, 4, 16)
SERVE_ATOL = 1e-4
SERVE_CPU_QUERIES = 8
TRACE_STEPS = 10
# LM training path (Queue 1 item 11a): LM_ARCH at full width and depth, bf16,
# remat "full", batch LM_TRAIN_BATCH x LM_TRAIN_SEQ (the train_4k cell's
# length; its global batch of 256 cut to 2 to fit one card), Adam as the JAX
# launcher sets it.  LM_TRAIN_STEPS timed steps, LM_TRAIN_PROFILE profiled,
# LM_COMP_STEPS steps of the compressed-gradient example at LM_GRAD_BITS,
# then a fixed-rate LM_LOSSY_BITS checkpoint of the trained parameters.
# Card against CPU on one step at full width with LM_CPU_LAYERS layers in
# f32 on 1 x LM_CPU_SEQ tokens: loss to LM_CPU_LOSS_RTOL, every gradient to
# LM_CPU_GRAD_RTOL of its tensor's max, updated parameters by the quantile
# criterion of tests/test_ensemble.py:45-55 (p99 |d| under LM_CPU_Q99, none
# over 2 lr: Adam's first step moves each element by about +-lr, so a
# gradient near zero whose sign rounding flips moves it by 2 lr).  The
# training forward against lm_prefill (kernel 5) on LM_FWD_PROMPT tokens:
# last-token logits to LOGIT_ATOL (bf16 through 24 layers, as the replay)
# (LM_TRAIN_STEPS cut from 10 to 5, so that the script with the MoE phase
# stays within its time limit)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_PROFILE = 2, 4096, 5, 3
LM_PROFILE_STEPS = 10
LM_TRAIN_LR = 3e-4
LM_COMP_STEPS, LM_GRAD_BITS, LM_LOSSY_BITS = 3, 12, 14
LM_CPU_LAYERS, LM_CPU_SEQ = 2, 64
LM_CPU_LOSS_RTOL, LM_CPU_GRAD_RTOL, LM_CPU_Q99 = 1e-5, 1e-4, 1e-6
LM_FWD_PROMPT = 1024
LM_LAUNCHER_STEPS = (6, 4)
# SSM and hybrid LM path (Queue 1 item 11b, families 1 and 2): mamba2-130m and
# hymba-1.5b at full width and depth (configs/registry.py), bf16, random
# weights from a seeded generator.  Each serves LM_REQUESTS requests of the
# seeded workload (prompts REC_PROMPTS, generations LM_NEW) in LM_SLOTS slots
# with max_seq the longest prompt plus the longest generation, so that
# hymba's 1,024-key window bites in prefill and in decode, with run and
# run_lockstep; REC_SOLO of the requests are served again alone (in as many
# slots, so a decode step has the same shapes): teacher-forced logits alone
# and in the padded batch to SOLO_F32_ATOL in f32 (the weights cast up), and
# the served tokens equal up to a near tie in bf16.
# lm_prefill's last-token logits against lm_forward's on REC_FWD_PROMPT
# tokens to LOGIT_ATOL.  Training at REC_TRAIN (batch, length, steps),
# remat "full", Adam as the dense phase; REC_COMP_STEPS steps of the
# compressed-gradient example at LM_GRAD_BITS and an FR-LM_LOSSY_BITS
# checkpoint on mamba2-130m.  Card against CPU: one loss and its gradients
# with LM_CPU_LAYERS layers in f32 on 1 x LM_CPU_SEQ tokens, to the dense
# phase's limits.  Kernel 5 against its plain version at the hybrid's
# shapes: group 5, D 64, the window and none, a prefill of the longest
# prompt and decode rows whose kv_lens cross the window (HYBRID_KV_LENS).
REC_ARCHS = ("mamba2-130m", "hymba-1.5b")
REC_PARAMS = {"mamba2-130m": 128_958_912, "hymba-1.5b": 1_640_768_896}
REC_PROMPTS = {"mamba2-130m": (256, 512, 1024), "hymba-1.5b": (512, 1024, 2048)}
REC_MAX_SEQ = {"mamba2-130m": 1088, "hymba-1.5b": 2112}
REC_FWD_PROMPT = {"mamba2-130m": 1024, "hymba-1.5b": 2048}
REC_TRAIN = {"mamba2-130m": (2, 4096, 5), "hymba-1.5b": (2, 4096, 3)}
# requests served with run and with run_lockstep (the lockstep's the first of
# run's): cut from 16 and 16, for the script's time
REC_REQUESTS = {"mamba2-130m": (16, 8), "hymba-1.5b": (8, 8)}
# (REC_SOLO cut from 2 requests to 1, after the dense phase's cut, so that
# the script with the MoE phase stays within its time limit)
REC_COMP_STEPS, REC_SOLO, REC_PROFILE_STEPS = 3, 1, 10
SOLO_F32_ATOL = 1e-3
HYBRID_KV_LENS = (1, 513, 1023, 1024, 1025, 1500, 2048, 2112)
# MoE LM path (Queue 1 item 11b, family 3): qwen3-moe-30b-a3b at full width
# and depth (configs/registry.py:61-68; 30,532,110,336 parameters, 61.06 GB
# in bf16), random weights from a seeded generator.  It serves MOE_REQUESTS
# requests (cut from 16, for the script's time) of the seeded
# workload (prompts MOE_PROMPTS, so that every
# prefill group of run and run_lockstep holds at most moe_group tokens or a
# multiple of it, as the reference's reshape demands; generations LM_NEW)
# in LM_SLOTS slots, max_seq LM_MAX_SEQ, at the config's capacity factor,
# with run, and the first MOE_LOCKSTEP_REQUESTS of them with run_lockstep
# (reduced from 16, for the script's time: one lockstep group of 8 slots,
# 63 decode steps instead of 126).  MOE_SOLO requests of MOE_SOLO_NEW tokens alone
# against the batch with lossless dispatch (capacity_factor E / k): tokens
# equal up to a bf16 tie, as the recurrent phase holds them.
# MOE_PROFILE_STEPS decode steps profiled beside the bound of reading the
# step's weights (every expert: the dense dispatch multiplies all E experts
# x cap rows); one prefill of MOE_PROMPTS[-1] tokens timed.  lm_forward's
# last-token logits against lm_prefill's to LOGIT_ATOL on the model's first
# MOE_FWD_LAYERS layers; at full depth bf16 routing flips near-tied experts
# on the attention's rounding, so there the two are read beside a prefill
# with kernel 5 swapped for its plain version, and only held finite.
# Training at full width with MOE_TRAIN_LAYERS layers (reduced from 48:
# Adam's step holds about 30 bytes a parameter at its peak, the bf16
# parameters, bf16 and f32 gradients, the clip's f32 copies, the old and the
# new f32 moments, so 4 layers' 3.11e9 parameters would need 93 GB),
# MOE_TRAIN (batch, length: train_4k's global batch 256 -> 2), a warm-up and
# MOE_TRAIN_STEPS timed steps, the peak at most MOE_PEAK_LIMIT; card against
# CPU with 1 layer in f32 on 1 x LM_CPU_SEQ tokens: the loss to
# LM_CPU_LOSS_RTOL, every gradient to MOE_CARD_GRAD_RTOL of its tensor's
# largest magnitude, and the same step with the expert products in bf16
# (the control) further than that: the dispatch rounds tokens and
# cotangents to bf16, so f32 noise moves a value at a rounding midpoint by
# a bf16 ulp (tests/test_torch_lm_moe.py shows the JAX package differing
# from itself so); the limit lies between the card's reading, 1.54e-3 of
# the max, and the control's, 8.18e-3 (H100 80GB HBM3, 700 W).
# arctic-480b at full width with ARCTIC_LAYERS layers (reduced from 35;
# 27,780,221,952 parameters, 55.56 GB): lm_forward against lm_prefill to
# LOGIT_ATOL, ARCTIC_REQUESTS requests through run.  Kernel 5 against its
# plain version and timed at both models' groups (8 and 7, D 128).  The
# tied-router check holds MOE_TIED_ULPS bf16 ulps of the output's largest
# magnitude against the experts applied one by one.
MOE_ARCHS = ("qwen3-moe-30b-a3b", "arctic-480b")
MOE_PARAMS = 30_532_110_336
MOE_PROMPTS = (128, 1024)
MOE_SOLO, MOE_SOLO_NEW, MOE_PROFILE_STEPS = 2, 16, 10
MOE_REQUESTS, MOE_LOCKSTEP_REQUESTS = 8, 8
MOE_TRAIN_LAYERS, MOE_TRAIN_PARAMS = 2, 1_868_572_672
MOE_TRAIN, MOE_TRAIN_STEPS, MOE_PEAK_LIMIT = (2, 4096), 3, 75e9
MOE_CARD_GRAD_RTOL, MOE_TIED_ULPS, MOE_FWD_LAYERS = 4e-3, 4, 2
ARCTIC_LAYERS, ARCTIC_PARAMS, ARCTIC_REQUESTS = 2, 27_780_221_952, 4
# VLM and encoder-decoder LM path (Queue 1 item 11b, families 4 and 5):
# internvl2-2b (configs/registry.py:43-49; 24 layers, d 2,048, 16 q over 8
# KV heads x 128, 256 image tokens of width 1,024) and seamless-m4t-large-v2
# (configs/registry.py:34-40; 24 encoder and 24 decoder layers, d 1,024, 16
# heads x 64, vocab 256,206) at full width and depth, bf16, random weights
# from a seeded generator, f32 caches.  The VLM serves FRONT_REQUESTS text
# requests (prompts LM_PROMPTS, generations LM_NEW) through ServeEngine.run,
# which serves a VLM from tokens alone as the JAX engine does, and one image
# request through lm_prefill (its 256 seeded image embeddings and a
# VLM_IMAGE_PROMPT-token prompt) and FRONT_NEW greedy serve_steps.  The
# encoder-decoder, which both packages' engines refuse, serves FRONT_REQUESTS
# requests of ENC_FRAMES seeded frames and decoder prompts of ENC_PROMPTS
# tokens, right-padded, through lm_prefill and FRONT_NEW greedy serve_steps
# at per-slot positions (the JAX dry run's prefill and decode contract),
# every attention call of both through kernel 5 (the plain versions
# refused); one request alone against its batch, tokens equal up to a tie
# (the recurrent phase's rule).  Each family's decode logits, teacher-forced,
# against lm_forward's to LOGIT_ATOL; FRONT_PROFILE_STEPS decode steps
# profiled; training at FRONT_TRAIN (batch, tokens: the dry run's train_4k
# splits, launch/dryrun.py:45-54, the VLM's 256 image tokens before 3,840
# and the encoder-decoder's 2,048 frames beside 2,048 tokens; batch 256 cut
# to 2), seeded image and frame embeddings, a warm-up and FRONT_TRAIN_STEPS
# timed steps, the peak at most FRONT_PEAK_LIMIT; card against CPU with
# LM_CPU_LAYERS layers (and encoder layers) in f32 on 1 x LM_CPU_SEQ tokens
# (after FRONT_CPU_IMAGE image tokens, or beside as many frames) to the
# dense phase's limits.  Kernel 5 against its plain version at their
# shapes: the VLM's causal prefill of image and prompt (group 2, D 128);
# at group 1, D 64 the encoder's non-causal prefill, the cross-attention's
# prefills ENC_CROSS (queries, keys; more queries than keys and fewer, key
# counts off the 64-key tile, a short encoder input), its non-causal
# decode against the f32 cross cache at ENC_DECODE_KEYS keys (ENC_FRAMES
# and off the split edges), and the decoder's causal prefill and decode.
FRONT_ARCHS = ("internvl2-2b", "seamless-m4t-large-v2")
FRONT_PARAMS = {"internvl2-2b": 1_891_244_032, "seamless-m4t-large-v2": 2_035_832_832}
FRONT_REQUESTS, FRONT_NEW, FRONT_PROFILE_STEPS = 8, 32, 10
VLM_IMAGE_PROMPT = 512
ENC_FRAMES, ENC_PROMPTS = 1024, (128, 256, 512)
ENC_CROSS = ((8, 512, 1024), (1, 1024, 520), (1, 512, 1000), (1, 100, 40))
ENC_DECODE_KEYS = (ENC_FRAMES, 1000, 37)
FRONT_TRAIN = {"internvl2-2b": (2, 3840), "seamless-m4t-large-v2": (2, 2048)}
FRONT_TRAIN_STEPS, FRONT_PEAK_LIMIT, FRONT_CPU_IMAGE = 3, 76e9, 16

# the sharded LM phase: internlm2-1.8b at full width with 2 layers (bf16)
# on a one-rank NCCL mesh, against the plain steps on the same card
SHARD_LAYERS = 2
SHARD_TRAIN = (2, 1024)                 # batch, sequence of the training step
SHARD_STEPS = 3                         # timed steps of each, after one untimed
SHARD_SERVE = (4, 256, 512)             # batch, prompt, max_seq of the prefill
SHARD_DECODE = 8                        # decode steps after it
# the sharded gradients equal the plain ones bit for bit (the vocab-parallel
# cross-entropy is logsumexp's arithmetic on one shard); a control with one
# label of the batch changed must break that
SHARD_CONTROL_TOKEN = (0, 0)
# --ranks N: the sharded prefill and decode across N cards on a (data 2,
# model N / 2) NCCL mesh, the cache's sequence split over "model"
MULTI_CARD_TIMEOUT = 600
SHARD_PARAM_LR = 1e-4
SHARD_BITS = 12
DRYRUN_CELL = "train_4k"


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    print(f"check {'ok  ' if cond else 'FAIL'} {what}", flush=True)
    if not cond:
        raise CheckFailed(what)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and the graph replayed, so no host dispatch sits between the
    calls.  None, with the reason printed, where a call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        print(f"  not captured in a CUDA graph: {str(e).splitlines()[0][:100]}")
        return None
    ms = cuda_ms(graph.replay, reps=5, warmup=1) / reps
    del graph
    return ms


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / VECTOR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# Operations per 4x4 block: the function's work, not an implementation's
# (the lane-parallel kernels repeat each lift on four lanes and add
# shuffles; those are not counted).  Unpack: 8 per lane per word in kernel
# 1's scalar loop, 6 in the lane kernels (two shift-and-shift-or triples); a
# 4-point lift 16; negabinary 2 per lane; dequantize 3 per lane; an error
# check 3 per lane; the pack 2 per lane per plane.
def decode_ops(nb: int, words: int) -> float:
    return nb * (128 * words + 17 + 32 + 8 * 16 + 48)


def encode_ops(nb: int, checks: int) -> float:
    """Kernel 2 for ``checks`` error checks over ``nb`` blocks (the early
    exit's count for the data at hand)."""
    front = 16 + 32 + 5 + 64 + 8 * 16 + 32 + 16 + 5
    per_check = 16 + 32 + 8 * 16 + 48 + 48 + 3
    return nb * (front + 2 * 16 * 30) + checks * per_check


def fr_decode_ops(nb: int, words: int) -> float:
    return nb * (96 * words + 32 + 8 * 16 + 48)


def fr_encode_ops(nb: int, words: int) -> float:
    front = 16 + 32 + 5 + 64 + 8 * 16 + 32
    return nb * (front + 16 + 8 * 16 * words)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, dtypes and bit patterns (signed zeros included)."""
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def ln_block_shapes(height: int, width: int, base: int = 256, batch: int = BATCH) -> list:
    """(B, C, H, W) of a surrogate's five layer norm + LeakyReLU blocks."""
    from repro_torch.models.surrogate import SurrogateConfig, _stage_channels
    h, w = height // 16, width // 16
    out = [(batch, base, h, w)]
    for i, (_, c) in enumerate(_stage_channels(SurrogateConfig(base_channels=base))):
        out.append((batch, c, h << (i + 1), w << (i + 1)))
    return out


def ln_case(shape, dev, seed: int):
    """x, g, b and a cotangent dy for one block, from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=gen) * 2.0 + 1.0
    g = torch.rand(shape[1], device=dev, generator=gen) + 0.5
    b = torch.randn(shape[1], device=dev, generator=gen) * 0.3
    dy = torch.randn(shape, device=dev, generator=gen)
    return x, g, b, dy


def ln_bytes(shape) -> float:
    """The pair's least memory traffic on one block: the forward reads x and
    writes y (8 bytes a float) and a mean and rstd a pixel (8 bytes), the
    backward reads dy and x and writes dx (12 bytes a float) and reads the
    mean and rstd (8 bytes a pixel); g, b and the channel partials are
    small beside them."""
    n = math.prod(shape)
    return 20.0 * n + 16.0 * (n // shape[1])


def ln_err_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ``|got - want|`` as a share of ``torch.testing.assert_close``'s
    limit at rtol ``LN_RTOL`` and atol ``LN_RTOL`` times want's largest
    magnitude (the card tests' comparison); at most 1 where they pass."""
    limit = LN_RTOL * (want.abs() + want.abs().max())
    return float(((got - want).abs() / limit).max())


def ln_lrelu_checks(dev) -> float:
    """The layer norm + LeakyReLU pair (``kernels/ln_lrelu.py``) against its
    plain twins at every block shape of the 512x512 and 768x256 surrogates
    at batch 64: y bit for bit from the kernel's own mean and rstd in the
    plain order; mean, rstd, y and dx within :func:`ln_err_share`'s limit;
    dg and db within ``LN_RTOL`` of the sum of their terms'
    magnitudes (the sums run in another order); a second backward call
    bit for bit the first.  Returns the largest error as a share of its
    limit."""
    from repro_torch.kernels import ln_lrelu, ref
    worst = 0.0
    shapes = ln_block_shapes(512, 512) + ln_block_shapes(768, 256)
    for shape in shapes:
        x, g, b, dy = ln_case(shape, dev, sum(shape))
        y, mean, rstd = ln_lrelu.forward(x, g, b, 1e-5, 0.2)
        pre = (x - mean[:, None]) * rstd[:, None] * g[:, None, None] + b[:, None, None]
        require(same_bits(y, torch.where(pre >= 0, pre, 0.2 * pre)),
                f"ln_lrelu forward {shape}: y bit for bit from its own mean and rstd")
        del pre
        errs = {}
        for what, got, want in zip(("y", "mean", "rstd"), (y, mean, rstd),
                                   ref.ln_lrelu_forward(x, g, b)):
            errs[what] = ln_err_share(got, want)
        del y
        dx, dg, db = ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)
        want_dx, want_dg, want_db = ref.ln_lrelu_backward(dy, x, g, b, mean, rstd)
        errs["dx"] = ln_err_share(dx, want_dx)
        del want_dx
        xhat = (x - mean[:, None]) * rstd[:, None]
        dpre = torch.where(xhat * g[:, None, None] + b[:, None, None] >= 0, dy, 0.2 * dy)
        for what, got, want, mag in (
                ("dg", dg, want_dg, (dpre * xhat).abs().sum(dim=(0, 2, 3))),
                ("db", db, want_db, dpre.abs().sum(dim=(0, 2, 3)))):
            errs[what] = float(((got - want).abs() / (LN_RTOL * mag + 1e-30)).max())
        del xhat, dpre
        again = ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)
        require(all(same_bits(a, c) for a, c in zip((dx, dg, db), again)),
                f"ln_lrelu backward {shape}: a second call gives the same bits")
        shown = ", ".join(f"{k} {v:.3f}" for k, v in errs.items())
        require(max(errs.values()) <= 1.0,
                f"ln_lrelu {shape} against its plain twins (error / limit: {shown})")
        worst = max(worst, *errs.values())
        del x, dy, dx, again
    torch.cuda.empty_cache()
    return worst


def ln_lrelu_timings(dev, shapes) -> dict:
    """One step's pair over the blocks ``shapes``: each block's forward (with
    its statistics) and backward back to back, beside the plain twins and
    the byte bound at ``HBM_BYTES_PER_S``."""
    from repro_torch.kernels import ln_lrelu, ref
    cases = [ln_case(s, dev, i) for i, s in enumerate(shapes)]

    def pair():
        for x, g, b, dy in cases:
            _, mean, rstd = ln_lrelu.forward(x, g, b, 1e-5, 0.2)
            ln_lrelu.backward(dy, x, g, b, mean, rstd, 0.2)

    def plain():
        for x, g, b, dy in cases:
            _, mean, rstd = ref.ln_lrelu_forward(x, g, b)
            ref.ln_lrelu_backward(dy, x, g, b, mean, rstd)

    res = {"ms": cuda_ms(pair, reps=10), "graph_ms": graph_ms(pair, reps=10),
           "plain_ms": cuda_ms(plain, reps=3),
           "bound_ms": sum(ln_bytes(s) for s in shapes) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "shapes": [list(s) for s in shapes]}
    del cases
    torch.cuda.empty_cache()
    return res


def ptxas_table(logs: dict) -> list:
    """(source, kernel, registers, spill stores, spill loads) per kernel
    entry, from ``nvcc -Xptxas -v`` output."""
    import re
    rows = []
    for key, log in logs.items():
        name, spills = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name is not None:
                rows.append((key, name, int(m.group(1)), *spills))
                name, spills = None, (0, 0)
    return rows


def print_ptxas(logs: dict, what: str) -> None:
    import re
    for key, name, regs, st, ld in ptxas_table(logs):
        m = re.search(r"\d([a-z]+(?:_[a-z]+)*_kernel)(?:ILi(\d+)E)?", name)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        print(f"  {what} {key}: {name[:60]}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B")


def pass_count_set(rng) -> tuple:
    """Blocks and tolerances that need each of 0..6 correction passes of the
    fixed-accuracy encode (the CPU tests build the same kind of set).  A
    positive normal tolerance leaves at most two passes after the guess,
    except for blocks below 2^-120 (coded as zero, error never falls: six);
    a tolerance of -1 is never met, so a block at emax 28 - 2k climbs from
    30 - 2k planes to 30 in exactly k passes.  Also blocks that start at 30
    planes, zero and subnormal blocks, and the F1 blocks."""
    rows, tols = [], []
    for k in range(7):
        emax = 28 - 2 * k if k < 6 else 10
        v = rng.uniform(-1, 1, 16) * 2.0 ** (emax - 1)
        v[0] = 0.75 * 2.0 ** emax
        rows.append(v)
        tols.append(-1.0)
    for scale, tol in ((1.0, 1e-3), (1e-2, 1e-5), (1e3, 1e-1)):
        rows += list(rng.standard_normal((24, 16)) * scale)
        tols += [tol] * 24
    tiny = rng.uniform(-1, 1, 16) * 2.0 ** -121
    rows += [tiny, tiny, rng.standard_normal(16), np.zeros(16), np.zeros(16),
             np.full(16, 1e-40)]
    tols += [2.0 ** -126, 1e-30, 2.0 ** -126, 1e-3, -1.0, 1e-3]
    for em in range(-119, -98):
        rows.append(rng.uniform(-1, 1, 16) * 2.0 ** (em - 1))
        tols.append(2.0 ** -126)
    return (torch.from_numpy(np.stack(rows).astype(np.float32)),
            torch.tensor(tols, dtype=torch.float32))


def count_passes(blocks: torch.Tensor, tols: torch.Tensor, log2tols: torch.Tensor):
    """Per block, the correction passes that add planes (0..6) and the error
    checks the encode needs when each block stops at its first settled pass
    (plain PyTorch on the blocks' device)."""
    from repro_torch.compression import transform as T
    x, tol = T.flush_denormals(blocks), T.flush_denormals(tols)
    emax = T.block_emax(x)
    u_full = T.int2nb(T.fwd_transform_2d(T.quantize_blocks(x, emax)))
    npl = torch.clamp(emax - log2tols + 2, 0, T.TOTAL_PLANES).to(torch.int32)
    npl = torch.where((u_full == 0).all(-1), torch.zeros_like(npl), npl)
    passes, checks = torch.zeros_like(npl), torch.zeros_like(npl)
    live = npl < T.TOTAL_PLANES
    for _ in range(6):
        checks += live.to(torch.int32)
        dec = T.inv_transform_2d(T.nb2int(T.truncate_planes(u_full, npl)))
        bad = live & (T.dequantize_minus(dec, emax, x).abs().amax(-1) > tol)
        npl = torch.where(bad, torch.clamp(npl + 2, max=T.TOTAL_PLANES), npl)
        passes += bad.to(torch.int32)
        live = bad & (npl < T.TOTAL_PLANES)
    return passes, checks


def build_baseline(csrc: str, i: int = 0):
    """The ZFP kernels of another checkout's ``csrc`` directory (the parent
    commit's, to time before and after in one run), built with this
    checkout's flags into ``build/``; returns (libraries, nvcc logs)."""
    from repro_torch.kernels import nvcc_build, zfp_codec
    csrc = Path(csrc).resolve()
    logs = {}
    libs = nvcc_build.compile_and_load(
        f"zfp_codec_baseline{i}", zfp_codec.SOURCES,
        tuple(sorted(p.name for p in csrc.glob("*.cuh"))), zfp_codec.NVCC_FLAGS, logs, csrc)
    return zfp_codec.bind(libs), logs


def before_after(call, args, reps: int, baseline: dict) -> dict:
    """Times of ``call(*args)`` on this checkout's kernels ("new") and on
    each baseline's ({csrc: libraries}), in turns (baselines, new, new,
    baselines in reverse) so all see the same card state; each entry lists
    its runs, each {"ms": per call with CUDA events around back-to-back
    launches from Python, "graph_ms": per call replayed from a CUDA graph}."""
    from repro_torch.kernels import zfp_codec
    libs = {"new": zfp_codec.build(), **baseline}
    order = [*baseline, "new", "new", *reversed(list(baseline))] if baseline else ["new"]
    out = {who: [] for who in libs}
    for who in order:
        with mock.patch.dict(zfp_codec._libs, libs[who]):
            out[who].append({"ms": cuda_ms(lambda: call(*args), reps=reps),
                             "graph_ms": graph_ms(lambda: call(*args), reps)})
    return out


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


class ProfileRow:
    """One name's totals over a torch.profiler run: the fields of a
    ``key_averages()`` row that this script reads (times in us)."""
    __slots__ = ("key", "device_type", "count", "self_device_time_total",
                 "self_cpu_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count, self.self_device_time_total, self.self_cpu_time_total = 0, 0.0, 0.0


# names the profiler's own aggregation leaves out (profiler_util._filter_name)
PROFILE_SKIP = frozenset(("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                          "profiler::_record_function_enter_new",
                          "profiler::_record_function_exit", "aten::is_leaf",
                          "aten::output_nr", "aten::_version"))


def profile_rows(prof) -> list:
    """``prof.key_averages()``'s rows, aggregated by name from the
    profiler's raw events.  key_averages builds a Python object and a
    parent tree for every event, about 75 us each: a window of decode steps
    at tens of thousands of operator calls a step took longer to parse than
    to run.  Device rows (kernels, copies, sets) count their own time; a
    host row's self time is its time less its direct children's on its
    thread (a runtime call on the thread of the operator that launched
    it), and a node that is the only child of a parent of its own name is
    merged into that parent, as the profiler's tree does.
    ``check_profile_rows`` holds the two aggregations equal on the card."""
    from torch.autograd import DeviceType
    from torch.autograd import profiler_util
    rewrite = getattr(profiler_util, "_rewrite_name", lambda name, with_wildcard: name)
    cpu = DeviceType.CPU
    keys, rows, op_thread = {}, {}, {}
    host = []       # [thread, start, -end, kineto order, name, linked op] a sync host event
    for e in prof.profiler.kineto_results.events():
        raw = e.name()
        if raw in PROFILE_SKIP or e.is_hidden_event():
            continue
        name = keys.get(raw)
        if name is None:        # demangled, numbered names as one (the profiler's keys)
            name = keys[raw] = rewrite(name=raw, with_wildcard=True)
        kind = e.device_type()
        row = rows.get(name)
        if row is None:
            row = rows[name] = ProfileRow(name, kind)
        if kind != cpu:
            row.count += 1
            row.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
            continue
        thread = e.start_thread_id()
        if e.is_async() or thread != e.end_thread_id():
            row.count += 1
            continue
        link = e.linked_correlation_id()
        if not link:
            op_thread[e.correlation_id()] = thread
        host.append([thread, e.start_ns(), -e.end_ns(), len(host), name, link])
    for h in host:
        if h[5]:
            h[0] = op_thread.get(h[5], h[0])
    # the host tree: per thread, by start (the longer first), a stack of the
    # intervals that may hold the next one
    host.sort()
    n = len(host)
    parent, kids, kid_ns = [-1] * n, [0] * n, [0] * n
    stack, thread = [], None
    for i, (t, start, neg_end, _, _, _) in enumerate(host):
        if t != thread:
            stack, thread = [], t
        while stack:
            top = host[stack[-1]]
            if start >= -top[2] or -neg_end > -top[2]:
                stack.pop()
            else:
                parent[i] = p = stack[-1]
                kids[p] += 1
                kid_ns[p] += -neg_end - start
                break
        stack.append(i)
    # merge each only child of a parent of its name into that parent
    merged = {}
    todo = [i for i, p in enumerate(parent) if p >= 0 and host[p][4] == host[i][4]]
    while todo:
        rest = []
        for i in todo:
            p = parent[i]
            while p in merged:
                p = merged[p]
            if kids[p] == 1:
                kids[p], kid_ns[p] = kids[i], kid_ns[i]
                merged[i] = p
            else:
                rest.append(i)
        if len(rest) == len(todo):
            break
        todo = rest
    for i, (_, start, neg_end, _, name, _) in enumerate(host):
        if i not in merged:
            row = rows[name]
            row.count += 1
            row.self_cpu_time_total += (-neg_end - start - kid_ns[i]) / 1e3
    return [r for r in rows.values() if r.count]


def check_profile_rows(prof) -> None:
    """profile_rows against the profiler's own key_averages() on one run:
    the same names, counts and times (to 1 ns an event of rounding)."""
    from torch.autograd import DeviceType
    fast = {r.key: r for r in profile_rows(prof)}
    slow = {e.key: e for e in prof.key_averages()}

    def differs(k):
        f, s = fast.get(k), slow.get(k)
        if f is None or s is None or f.count != s.count:
            return True
        field = ("self_cpu_time_total" if s.device_type == DeviceType.CPU
                 else "self_device_time_total")
        return abs(getattr(f, field) - getattr(s, field)) > 1e-3 * s.count + 1e-6

    bad = [k for k in set(fast) | set(slow) if differs(k)]
    require(not bad, f"profile_rows == key_averages() on {len(slow)} names "
                     f"({sum(e.count for e in slow.values())} events; differing: {bad[:5]})")


def device_busy_us(prof) -> float:
    """The device's busy time over a torch.profiler run, in us: the union of
    the intervals of its activities (kernels, copies, sets) from the raw
    events ``profile_rows`` walks.  Activities on different streams
    overlap, so the sum of their times can pass the wall time; the union
    cannot."""
    from torch.autograd import DeviceType
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() != DeviceType.CPU and not e.is_hidden_event()
                   and e.name() not in PROFILE_SKIP)
    busy_ns, start, end = 0, None, None
    for s, e in spans:
        if end is None or s > end:          # a gap: close the running interval
            busy_ns += 0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_ns += 0 if end is None else end - start
    return busy_ns / 1e3


def print_profile(prof, wall_ms: float, per: int, unit: str):
    """The device's busy share and the kernels that take most of its time,
    from a torch.profiler run over ``per`` units of work; returns the
    kernels per unit (None where the profiler recorded no device time)."""
    from torch.autograd import DeviceType
    # kernels only: operator rows repeat their kernels' device time
    averages = profile_rows(prof)
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print(f"profile: {wall_ms:.3f} ms/{unit} wall; the profiler recorded no "
              "device time (device busy share not measured)")
        return None
    busy_ms = device_busy_us(prof) / 1e3 / per
    sum_ms = sum(e.self_device_time_total for e in events) / 1e3 / per
    require(busy_ms <= wall_ms, f"device busy {busy_ms:.3f} ms/{unit} (the union of its "
                                f"intervals) within the wall {wall_ms:.3f} ms/{unit}")
    print(f"profile: {per} {unit}s, {wall_ms:.3f} ms/{unit} wall (profiler on), device "
          f"busy {busy_ms:.3f} ms/{unit} ({100 * busy_ms / wall_ms:.1f}%; kernels' times "
          f"summed {sum_ms:.3f} ms/{unit}), "
          f"{sum(e.count for e in events) / per:.0f} kernels/{unit}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        ms = e.self_device_time_total / 1e3 / per
        print(f"  {ms:8.4f} ms/{unit} {e.count / per:6.0f}x  {100 * ms / busy_ms:5.1f}%  "
              f"{e.key[:90]}")
    host = [e for e in averages if e.device_type == DeviceType.CPU]
    print(f"  host: {sum(e.count for e in host) / per:.0f} operator calls/{unit}; most "
          f"self CPU time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"  {e.self_cpu_time_total / 1e3 / per:8.4f} ms/{unit} {e.count / per:6.0f}x  "
              f"{e.key[:90]}")
    return sum(e.count for e in events) / per


# kernels per device-resident step with the five-launch batch decode (three
# gathers, the flat decode and the deblockify copy), profiled on the H100
PARENT_KERNELS_PER_STEP = 921


def profile_steps(store, cond, model, transform, steps: int = 10) -> None:
    """Trace ``steps`` fused train steps with torch.profiler and print the
    device's busy share, the kernels that take most of its time and the
    kernels per step beside the parent's."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import ShardedLoader
    from repro_torch.train.optimizer import AdamConfig, adam_init
    from repro_torch.train.source import make_batch_source, make_fused_step
    source = make_batch_source(store, cond, transform)
    opt_cfg = AdamConfig(lr=LR)
    step = make_fused_step(source, model, opt_cfg)
    opt = adam_init(dict(model.named_parameters()), opt_cfg)
    idxs = [source.fetch(i) for i in
            ShardedLoader(store.num_samples, BATCH, seed=1).take(steps + 2)]
    for idx in idxs[:2]:
        opt, loss = step(opt, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx in idxs[2:]:
            opt, loss = step(opt, idx)
            float(loss)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    per_step = print_profile(prof, wall_ms, steps, "step")
    print(f"kernels per device-resident step: "
          f"{'not measured' if per_step is None else f'{per_step:.1f}'} "
          f"(before the gathered decode: {PARENT_KERNELS_PER_STEP})")
    return per_step


def profile_ensemble_steps(data, cond, cfg, steps: int = 10):
    """Trace ``steps`` fused ensemble steps on device-resident data: one
    store shared by the ``ENS_SEEDS`` members, or a list of per-member
    stores (the sweep's stacked payload); print the device's busy share and
    where its time goes, and return the kernels per step (None where not
    measured)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.ensemble import init_ensemble
    from repro_torch.data import EnsembleLoader, ShardedLoader, channels_last
    from repro_torch.train.optimizer import AdamConfig, adam_init
    from repro_torch.train.source import make_ensemble_source, make_fused_ensemble_step
    stores = data if isinstance(data, list) else [data] * len(ENS_SEEDS)
    seeds = list(range(len(stores)))
    source = make_ensemble_source(data, cond, channels_last)
    opt_cfg = AdamConfig(lr=LR)
    step = make_fused_ensemble_step(source, cfg, opt_cfg)
    params = init_ensemble(cfg, seeds, source.device)
    opt = adam_init(params, opt_cfg)
    loader = EnsembleLoader([ShardedLoader(st.num_samples, BATCH, seed=s)
                             for st, s in zip(stores, seeds)])
    idxs = [source.fetch(i) for i, _ in zip(loader, range(steps + 2))]
    for idx in idxs[:2]:
        params, opt, loss = step(params, opt, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx in idxs[2:]:
            params, opt, loss = step(params, opt, idx)
            loss.cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    what = "the sweep's candidate stores" if isinstance(data, list) else "one shared store"
    print(f"ensemble step ({len(stores)} members, {what}):", end=" ")
    return print_profile(prof, wall_ms, steps, "step")


def profile_member_loop(store, cond, cfg, steps: int = 10):
    """The sequential alternative to the ensemble step: the ``ENS_SEEDS``
    members as single models, one fused step each, back to back (one host
    sync at the end of the four).  Traces ``steps`` such rounds; returns
    the kernels per round (None where not measured)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import ShardedLoader, channels_last
    from repro_torch.models.surrogate import init_surrogate
    from repro_torch.train.optimizer import AdamConfig, adam_init
    from repro_torch.train.source import make_batch_source, make_fused_step
    source = make_batch_source(store, cond, channels_last)
    opt_cfg = AdamConfig(lr=LR)
    members = []
    for s in ENS_SEEDS:
        model = init_surrogate(cfg, s, store.device)
        idxs = [source.fetch(i) for i in
                ShardedLoader(store.num_samples, BATCH, seed=s).take(steps + 2)]
        members.append([make_fused_step(source, model, opt_cfg),
                        adam_init(dict(model.named_parameters()), opt_cfg), idxs])

    def round_(i):
        for m in members:
            m[1], loss = m[0](m[1], m[2][i])
        return loss

    for i in range(2):
        round_(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2, steps + 2):
            round_(i).cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    print(f"{len(ENS_SEEDS)} single models one after another:", end=" ")
    return print_profile(prof, wall_ms, steps, "round")


def decode_indices_kernels(store, idx: torch.Tensor):
    """The device kernels one ``store.decode_indices(idx)`` runs, from
    torch.profiler: [(name, count)], or None where it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    store.decode_indices(idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        store.decode_indices(idx)
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in profile_rows(prof)
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return events or None


def profile_serving(engine, lm, cache, cur, pos, steps: int = LM_PROFILE_STEPS) -> None:
    """Trace ``steps`` full-width decode steps of the engine (8 slots at the
    depths ``pos``), each with its argmax read back, and one prefill of the
    longest prompt; print where the device time goes."""
    from torch.profiler import ProfilerActivity, profile
    dev = engine.device
    toks = torch.from_numpy(np.asarray(cur, np.int32)).to(dev)
    depth = torch.from_numpy(np.asarray(pos, np.int32)).to(dev)
    for _ in range(2):
        engine._decode_step(cache, cur, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, _ = lm.serve_step(engine.params, engine.cfg, cache, toks, depth)
            torch.argmax(logits, -1).cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    print("decode step:", end=" ")
    print_profile(prof, wall_ms, steps, "step")
    plen = LM_PROMPTS[-1]
    prompt = np.arange(plen, dtype=np.int32)[None] % engine.cfg.vocab_size
    engine._prefill(prompt, np.array([plen]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = engine._prefill(prompt, np.array([plen]))
        torch.argmax(logits, -1).cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print(f"prefill of {plen} tokens:", end=" ")
    print_profile(prof, wall_ms, 1, "prefill")
    check_profile_rows(prof)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port's main paths on one card.")
    ap.add_argument("--codec", action="store_true",
                    help="only build the ZFP kernels, check them and time them")
    ap.add_argument("--baseline", metavar="CSRC", action="append", default=[],
                    help="with --codec: also time the ZFP kernels built from this "
                         "csrc directory (another checkout's), in turns with these; "
                         "may be given more than once")
    ap.add_argument("--ranks", type=int, default=1,
                    help="only the sharded prefill and decode across this many cards "
                         "(a (data 2, model N / 2) NCCL mesh) against the plain ones")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    codec_only = args.codec
    # cuBLAS reads this when its first handle is made: the checkpoint
    # phase's exact-resume check runs under deterministic algorithms, which
    # need it for reproducible matrix products
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import DeviceResidentCompressedStore, channels_last
    from repro_torch.kernels import flash_attention, ln_lrelu, zfp_codec
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.sim.synthetic import synthetic_study
    from repro_torch.train.loop import TrainConfig, predict_fields, train_surrogate

    if args.rank is not None:                  # one of --ranks' other ranks
        sharded_serving_rank(args.rank, args.ranks, args.port)
        return 0
    smi = gpu_line()
    print(smi)
    if args.ranks > 1:
        return multi_card_serving(args.ranks)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tf32: cudnn={torch.backends.cudnn.allow_tf32} "
          f"matmul={torch.backends.cuda.matmul.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = torch.device(DEV)
    t_start = time.perf_counter()

    # the LM training launcher's two runs, beside the build (not with --codec)
    launcher = None if codec_only else LauncherRuns()

    # -- 1. build: every nvcc started together -------------------------------
    t0 = time.perf_counter()
    errors = []

    def build(module):
        try:
            module.build()
        except Exception as e:          # re-raised below, on the main thread
            errors.append(e)

    baseline, baseline_logs = {}, {}

    def build_base(i, csrc):
        try:
            baseline[csrc], logs = build_baseline(csrc, i)
            baseline_logs.update({f"{csrc}: {k}": v for k, v in logs.items()})
        except Exception as e:
            errors.append(e)

    jobs = [lambda: build(zfp_codec)]
    if not codec_only:
        jobs += [lambda: build(flash_attention), lambda: build(ln_lrelu)]
    jobs += [lambda i=i, c=c: build_base(i, c) for i, c in enumerate(args.baseline)]
    threads = [threading.Thread(target=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"build: {time.perf_counter() - t0:.1f} s")
    print_ptxas(zfp_codec.BUILD_LOGS, "this checkout's")
    print_ptxas(baseline_logs, "baseline's")
    for key, log in {**flash_attention.BUILD_LOGS, **ln_lrelu.BUILD_LOGS}.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {key}: {line.strip()}")

    # -- 2. data at full width -----------------------------------------------
    cfg_full = SurrogateConfig()
    _, cond, fields = synthetic_study(n=N_SAMPLES, height=cfg_full.height,
                                      width=cfg_full.width,
                                      base_channels=cfg_full.base_channels, seed=0)
    samples = np.ascontiguousarray(fields.transpose(0, 3, 1, 2))   # (N, 6, H, W)
    del fields
    print(f"data: {samples.shape} float32, {samples.nbytes / 1e6:.1f} MB raw")

    # -- 3. each codec kernel against its plain version --------------------------
    codec_checks(dev, samples)
    print(f"kernel checks: {time.perf_counter() - t_start:.1f} s since start", flush=True)
    if codec_only:
        resident, shard_batch = codec_batches(dev, samples)
        gather_checks(dev, resident)
        codec = codec_timings(dev, samples, resident, shard_batch, baseline)
        print(json.dumps({"codec": codec, "card": smi}))
        return 0

    # -- 3b. the layer norm + LeakyReLU pair against its plain twins ------------
    ln_worst = ln_lrelu_checks(dev)
    ln_times = ln_lrelu_timings(dev, ln_block_shapes(cfg_full.height, cfg_full.width,
                                                     cfg_full.base_channels))
    ln_times["at_512x512"] = ln_lrelu_timings(dev, ln_block_shapes(512, 512))
    print(f"ln_lrelu: worst error {ln_worst:.3f} of its limit; a step's pair "
          f"{ln_times['ms']:.4f} ms (plain twins {ln_times['plain_ms']:.4f}, bound "
          f"{ln_times['bound_ms']:.4f}); at 512x512 {ln_times['at_512x512']['ms']:.3f} ms "
          f"(bound {ln_times['at_512x512']['bound_ms']:.3f})", flush=True)

    launcher_s = launcher.join()
    print(f"launcher runs (beside the build and the kernel checks): {launcher_s:.1f} s; "
          f"{time.perf_counter() - t_start:.1f} s since start", flush=True)

    # -- 4. device-resident path at full width -----------------------------------
    zfp_codec.reset_launches()
    ln_lrelu.reset_launches()
    t0 = time.perf_counter()
    store = DeviceResidentCompressedStore.from_samples(
        samples, np.full(N_SAMPLES, TOLERANCE, np.float32), device=DEV)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    stamps = []
    t0 = time.perf_counter()
    model, losses = train_surrogate(
        cfg_full, TrainConfig(epochs=1, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                              max_steps=STEPS),
        cond, store, hooks=[lambda step, m, loss: stamps.append(time.perf_counter())],
        target_transform=channels_last, device=DEV)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    resident_launches = dict(zfp_codec.LAUNCHES)
    ln_launches = ln_lrelu.launch_counts()
    print(f"device-resident path: store build {t_store:.3f} s, {STEPS} steps "
          f"{t_train:.3f} s; launches {resident_launches}")
    print(f"store: {store.num_samples} samples x {store.nb} blocks, width "
          f"{store.payload.shape[-1]} words, ratio {store.ratio:.3f}, resident "
          f"{store.resident_bytes} bytes ({store.resident_bytes / 1e6:.1f} MB), "
          f"logical {store.logical_bytes} bytes")
    print("losses: " + json.dumps([round(l, 7) for _, l in losses]))
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    print(f"step time: median {statistics.median(step_ms):.3f} ms over steps "
          f"2..{STEPS} (min {min(step_ms):.3f}, max {max(step_ms):.3f})")
    for name in ("zfp_decode_blocks_fa", "zfp_encode_blocks_fa"):
        require(resident_launches[name] > 0, f"{name} launched on the device-resident "
                                             f"path ({resident_launches[name]} times)")
    require(len(losses) == STEPS and all(np.isfinite(l) for _, l in losses),
            f"{STEPS} finite losses")
    require(ln_launches == dict.fromkeys(ln_lrelu.LAUNCHES, 5 * STEPS),
            f"the five layer norm + LeakyReLU blocks launched one pair each a step "
            f"({ln_launches})")

    # -- 5. the device-resident outputs are right ---------------------------------
    worst = 0.0
    for i in range(0, N_SAMPLES, 256):
        idx = torch.arange(i, min(i + 256, N_SAMPLES), device=dev)
        dec = store.decode_indices(idx)
        x = torch.from_numpy(samples[i:i + 256]).to(dev)
        worst = max(worst, float((dec - x).abs().max()))
    require(worst <= TOLERANCE, f"store decodes within the L-inf bound "
                                f"(max error {worst:.3e} <= {TOLERANCE})")
    cpu_store = DeviceResidentCompressedStore(
        store.payload.cpu(), store.emax.cpu(), store.nplanes.cpu(), store.shape,
        store.padded_shape, store.tolerances, store.logical_bytes_per)
    _, cpu_losses = train_surrogate(
        cfg_full, TrainConfig(epochs=1, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                              max_steps=1),
        cond, cpu_store, target_transform=channels_last, device="cpu")
    l_gpu, l_cpu = losses[0][1], cpu_losses[0][1]
    require(abs(l_gpu - l_cpu) <= LOSS_RTOL * abs(l_cpu),
            f"first-step loss on the card {l_gpu:.7f} == plain CPU path "
            f"{l_cpu:.7f} (rtol {LOSS_RTOL})")
    preds = predict_fields(model, cond[:8], device=DEV)
    require(preds.shape == (8, 96, 32, 6) and bool(np.isfinite(preds).all()),
            "predict_fields gives finite (8, 96, 32, 6) fields")
    gather_checks(dev, store)

    # -- 6. certification path: seed ensemble, Algorithm 1, certify_tolerance ----
    print(f"certification phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    cert = certification_path(dev, samples, cond, cfg_full, store,
                              statistics.median(step_ms))

    # -- 6b. surrogate serving of the certification phase's fleet, and the
    # traced runs (spans, the compile/steady split, the recompile watcher) ---
    print(f"surrogate serving phase starts {time.perf_counter() - t_start:.1f} s since "
          f"start", flush=True)
    t0 = time.perf_counter()
    serving = surrogate_serving_path(dev, samples, cond, cfg_full, store, cert.pop("fleet"))
    print(f"surrogate serving phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 7. checkpoint path: exact resume, lossy checkpoints, compressed grads ---
    print(f"checkpoint phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    ckpt_res = checkpoint_path(dev, store, cond, cfg_full, smi)
    print(f"checkpoint phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 8. datagen path: solver, produce, train and certify from the path ------
    print(f"datagen phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_datagen_")
    try:
        datagen = datagen_path(dev, tmp.name, cfg_full)
    finally:
        tmp.cleanup()

    # -- 9. host-streaming path: stores on disk, decoded per batch ----------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    try:
        host = host_streaming_path(tmp.name, samples, cond, cfg_full, store)
    finally:
        tmp.cleanup()
    host_launches, fr_store_words, shard_batch = host

    # -- 10. times at the main-path shapes ----------------------------------------
    codec = codec_timings(dev, samples, store, tuple(t.to(dev) for t in shard_batch), {})
    blocks, _ = whole_store(dev, samples, spread=False)
    require(same_bits(zfp_codec.zfp_encode_blocks(blocks, FR_BITS)[0].reshape(N_SAMPLES, -1),
                      fr_store_words),
            "fixed-rate store words == the whole-store encode kernel's")
    del blocks

    # -- 11. where a step's device time goes (profiler on; launches not counted)
    single_kernels = profile_steps(store, cond, model, channels_last)
    ens_kernels = profile_ensemble_steps(store, cond, cfg_full)
    sweep_kernels = profile_ensemble_steps(cert.pop("sweep_stores"), cond, cfg_full)
    loop_kernels = profile_member_loop(store, cond, cfg_full)
    fmt = lambda k: "not measured" if k is None else f"{k:.1f}"
    print(f"kernels per step: single model {fmt(single_kernels)}, ensemble of "
          f"{len(ENS_SEEDS)} {fmt(ens_kernels)}, sweep of {len(CERT_MULTIPLES)} "
          f"{fmt(sweep_kernels)}, {len(ENS_SEEDS)} single models one after another "
          f"{fmt(loop_kernels)}")
    del store, model, samples, cond
    torch.cuda.empty_cache()

    # -- 11b. the paper's study and the three surrogate examples -----------------
    print(f"examples phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    examples = examples_path(dev, smi)
    print(f"examples phase: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- 12. LM serving path at full width: internlm2-1.8b, kernel 5 --------------
    print(f"LM phase starts {time.perf_counter() - t_start:.1f} s since start", flush=True)
    attn = lm_serving_path(dev, smi)
    torch.cuda.empty_cache()

    # -- 13. LM training path at full width: train_step, compressed gradients
    print(f"LM training phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    lm_train = lm_training_path(dev, smi, launcher_s)
    print(f"LM training phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 14. SSM and hybrid LM path at full width: mamba2-130m, hymba-1.5b
    print(f"recurrent LM phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    rec = recurrent_lm_path(dev, smi)
    print(f"recurrent LM phase: {time.perf_counter() - t0:.1f} s", flush=True)
    hybrid = rec["hymba-1.5b"]["attention"]
    attn["launches"] += rec["attention"]["launches"]
    attn["max_abs_err"] = max(attn["max_abs_err"], hybrid["max_abs_err"])
    for name, n in rec["attention"]["variants"].items():
        attn["variants"][name]["launches"] += n
    attn["launches_by_run"]["hymba-1.5b"] = {
        mode: {k: r[k] for k in ("prefill_launches", "decode_launches")}
        for mode, r in rec["hymba-1.5b"]["serve"].items()}
    attn["hybrid"] = hybrid["timings"]

    # -- 15. MoE LM path: qwen3-moe-30b-a3b at full width, arctic-480b's
    # dense residual at 2 layers
    torch.cuda.empty_cache()
    print(f"MoE LM phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    moe = moe_lm_path(dev, smi)
    print(f"MoE LM phase: {time.perf_counter() - t0:.1f} s", flush=True)
    attn["launches"] += moe["attention"]["launches"]
    attn["max_abs_err"] = max(attn["max_abs_err"], moe["attention"]["max_abs_err"])
    for name, n in moe["attention"]["variants"].items():
        attn["variants"][name]["launches"] += n
    attn["launches_by_run"][MOE_ARCHS[0]] = {
        mode: {k: r[k] for k in ("prefill_launches", "decode_launches")}
        for mode, r in moe["serve"].items()}
    attn["launches_by_run"][MOE_ARCHS[1]] = {
        "run": {k: moe["arctic_serve"][k] for k in ("prefill_launches", "decode_launches")}}
    attn["moe"] = moe["attention"]["timings"]

    # -- 16. VLM and encoder-decoder LM path: internvl2-2b and
    # seamless-m4t-large-v2 at full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    print(f"VLM and encoder-decoder LM phase starts {time.perf_counter() - t_start:.1f} s "
          f"since start", flush=True)
    t0 = time.perf_counter()
    front = frontend_lm_path(dev, smi)
    print(f"VLM and encoder-decoder LM phase: {time.perf_counter() - t0:.1f} s", flush=True)
    attn["launches"] += front["attention"]["launches"]
    attn["max_abs_err"] = max(attn["max_abs_err"], front["attention"]["max_abs_err"])
    for name, n in front["attention"]["variants"].items():
        attn["variants"][name]["launches"] += n
    attn["launches_by_run"].update(front["launches_by_run"])
    attn["frontend"] = front["attention"]["timings"]

    # -- 17. the multi-device launch path: DTensor steps on a one-rank NCCL
    # mesh, kernel 5 under local_map, the pod exchange through kernels 4, 3
    gc.collect()
    torch.cuda.empty_cache()
    print(f"sharded LM phase starts {time.perf_counter() - t_start:.1f} s since start",
          flush=True)
    t0 = time.perf_counter()
    sharded = sharded_lm_path(dev, smi)
    print(f"sharded LM phase: {time.perf_counter() - t0:.1f} s", flush=True)
    attn["launches"] += sharded["attention"]["launches"]
    attn["max_abs_err"] = max(attn["max_abs_err"], sharded["attention"]["max_abs_err"])
    for name, n in sharded["attention"]["variants"].items():
        attn["variants"][name]["launches"] += n
    attn["launches_by_run"]["sharded"] = sharded["serve"]["variants"]

    def launches(name):
        return (resident_launches[name] + cert["launches"][name] + ckpt_res["launches"][name]
                + datagen["launches"][name] + host_launches[name]
                + serving["launches"][name] + lm_train["launches"][name]
                + rec["launches"][name] + sharded["launches"][name]
                + examples["launches"][name])

    kernels = [
        {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
         "replaces": f"src/repro/kernels/zfp_codec.py:{line}", "launches": launches(name),
         **codec[name]}
        for name, src, line in (("zfp_decode_blocks_fa", "zfp_fa_decode.cu", 190),
                                ("zfp_encode_blocks_fa", "zfp_fa_encode.cu", 313),
                                ("zfp_decode_blocks", "zfp_fr_decode.cu", 127),
                                ("zfp_encode_blocks", "zfp_fr_encode.cu", 346))
    ] + [attn, {
        "name": "ln_lrelu", "route": "cuda", "source": "src/repro_torch/csrc/ln_lrelu.cu",
        "replaces": None, "launches": sum(ln_launches.values()),
        "launches_by_kernel": ln_launches, "max_err_share_of_limit": ln_worst, **ln_times}]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} launched on the paths "
                                   f"({k['launches']} times)")
    from repro_torch.obs.metrics import get_registry
    recompiles = get_registry().counter("jax.recompiles").value
    require(recompiles == 0, f"no kernel library was built after a run's first step "
                             f"({recompiles} flagged by the recompile watcher)")
    print(f"card: {smi}; device-resident step median {statistics.median(step_ms):.3f} "
          f"ms; ensemble dispatch median ({len(ENS_SEEDS)} members) "
          f"{cert['ensemble_ms']:.3f} ms, sweep dispatch median ({len(CERT_MULTIPLES)} "
          f"candidates) {cert['sweep_ms']:.3f} ms; LM train step median "
          f"{lm_train['train']['median_s']:.4f} s, compressed "
          f"{lm_train['compressed']['median_s']:.4f} s; "
          + "; ".join(f"{n} decode {rec[n]['serve']['run']['decode_tok_s']:.1f} tok/s, train "
                      f"step {rec[n]['train']['median_s']:.4f} s" for n in REC_ARCHS)
          + f"; {MOE_ARCHS[0]} decode {moe['serve']['run']['decode_tok_s']:.1f} tok/s, train "
          f"step ({MOE_TRAIN_LAYERS} layers) {moe['train']['median_s']:.4f} s"
          + f"; {FRONT_ARCHS[0]} decode {front[FRONT_ARCHS[0]]['serve']['decode_tok_s']:.1f} "
          f"tok/s, {FRONT_ARCHS[1]} decode {front[FRONT_ARCHS[1]]['serve']['decode_tok_s']:.1f} "
          f"tok/s"
          + f"; sharded train step {sharded['train']['sharded_s']:.4f} s vs plain "
          f"{sharded['train']['plain_s']:.4f} s"
          + f"; examples phase {sum(examples['seconds'].values()):.1f} s"
          + f"; surrogate serving {serving['qps']:.1f} queries/s "
          f"closed loop, fleet step {serving['fleet_ms']:.3f} ms; flash_attention prefill {attn['ms']:.4f} ms, decode "
          f"{attn['timings']['decode']['ms']:.4f} ms; RT_SPEC member on the card "
          f"{datagen['solver']['rt']['graph_s'][1]:.3f} s, produced ratios at {TOLERANCE} "
          f"rt {datagen['ratios']['rt']:.4f}, pchip {datagen['ratios']['pchip']:.4f}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


def nonfinite_blocks(rng) -> torch.Tensor:
    """Blocks holding NaN and +-inf, eight of each kind at other positions:
    a NaN, a +inf, a -inf in a standard-normal block; all NaN; all +inf or
    -inf; NaN, +inf and -inf together; a NaN beside values whose fixed-point
    image leaves int32 (a NaN block has emax 0, so |x| >= 8 saturates); an
    inf beside tiny values; +-inf mixed; and a finite control."""
    nan, inf = np.nan, np.inf
    rows = []
    for k in range(8):
        pos = rng.permutation(16)
        sign = (-1.0) ** k
        for put in ({pos[0]: nan}, {pos[0]: inf}, {pos[0]: -inf}, "nan", "inf",
                    {pos[0]: nan, pos[1]: inf, pos[2]: -inf}, "big", "tiny", "mixed", {}):
            r = rng.standard_normal(16)
            if put == "nan":
                r[:] = nan
            elif put == "inf":
                r[:] = sign * inf
            elif put == "big":
                r *= 30.0
                r[pos[0]] = nan
            elif put == "tiny":
                r *= 1e-30
                r[pos[0]] = sign * inf
            elif put == "mixed":
                r = np.sign(r) * inf
            else:
                for i, v in put.items():
                    r[i] = v
            rows.append(r)
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def codec_checks(dev, samples: np.ndarray) -> None:
    """Each ZFP kernel against its plain version, bit for bit: on the CPU
    (main-path data, the F1 blocks, mixed tolerances, every fixed-rate rate
    class, FA streams padded to the widest sample, blocks holding NaN and
    +-inf at tol 1e-3 and 1e-7 and at 12 and 30 bits), at block counts
    around the warp's two blocks and the CTA's sixteen (a lane whose block
    is past the end computes on a dummy block), at every fixed-rate width,
    on the pass-count set, and on the card at the whole store with
    per-sample tolerances 1e-5..1e-1."""
    from repro_torch.compression import floor_log2, transform as T
    from repro_torch.kernels import ref, zfp_codec
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(samples[:CHECK_SAMPLES])
    main_blocks = T.blockify(T.pad_to_blocks(xs)).contiguous()
    specials = [(rng.uniform(-1, 1, 16) * 2.0 ** (em - 1)) for em in range(-119, -98)]
    sub = np.zeros(16)
    sub[:3] = [2.0 ** -100, 2.0 ** -127, -3 * 2.0 ** -128]
    specials += [sub, np.zeros(16), np.full(16, 1e-40)]
    special_blocks = torch.from_numpy(np.stack(specials).astype(np.float32))
    mixed_blocks = torch.cat([main_blocks[:16384], special_blocks]).contiguous()
    pset_blocks, pset_tols = pass_count_set(rng)
    passes, _ = count_passes(pset_blocks, pset_tols, floor_log2(pset_tols))
    require(bool((torch.bincount(passes, minlength=7) > 0).all()),
            f"the pass-count set needs each of 0..6 passes "
            f"({torch.bincount(passes, minlength=7).tolist()} blocks)")
    cases = [
        ("main-path data at tol 1e-3", main_blocks,
         torch.full((main_blocks.shape[0],), TOLERANCE)),
        ("F1 blocks, zero blocks, mixed tolerances", mixed_blocks,
         torch.from_numpy((10.0 ** rng.uniform(-6, 0, mixed_blocks.shape[0]))
                          .astype(np.float32))),
        ("F1 blocks at tol 2^-126", special_blocks,
         torch.full((special_blocks.shape[0],), 2.0 ** -126)),
        (f"the pass-count set ({pset_blocks.shape[0]} blocks)", pset_blocks, pset_tols),
    ]
    # F3: the error check as one fused multiply-add (values just above 2^-126
    # beside one that sets emax -110..-100; values near the f32 maximum)
    tiny = np.sign(rng.standard_normal((88, 16))) * 2.0 ** -126 * (
        1 + 2.0 ** -rng.integers(2, 23, (88, 16)).astype(np.float64))
    tiny[:, 0] = 1.5 * 2.0 ** (np.repeat(np.arange(-110, -99), 8) - 1)
    big = (rng.choice([-1.0, 1.0], (64, 16)) * np.finfo(np.float32).max
           * (1 - 2.0 ** -rng.integers(1, 24, (64, 16)).astype(np.float64)))
    for what, b, tol in (("F3 blocks near 2^-126 at tol 2^-126", tiny, 2.0 ** -126),
                         ("F3 blocks near the f32 maximum at tol 1.5 2^110", big,
                          1.5 * 2.0 ** 110)):
        cases.append((what, torch.from_numpy(b.astype(np.float32)),
                      torch.full((len(b),), tol, dtype=torch.float32)))
    # NaN and +-inf (F4, F5): 80 such blocks and 3 main-path ones (a ragged warp)
    nonfinite = torch.cat([nonfinite_blocks(np.random.default_rng(1)),
                           main_blocks[:3]]).contiguous()
    for tol in (1e-3, 1e-7):
        cases.append((f"NaN and +-inf blocks at tol {tol:g}", nonfinite,
                      torch.full((nonfinite.shape[0],), tol)))
    reps = -(-max(CHECK_NB) // pset_blocks.shape[0])
    for nb in CHECK_NB:     # the set's blocks cycled, then main-path blocks
        blocks = torch.cat([pset_blocks.repeat(reps, 1)[:nb // 2], main_blocks[:nb - nb // 2]])
        tols = torch.cat([pset_tols.repeat(reps)[:nb // 2],
                          torch.full((nb - nb // 2,), TOLERANCE)])
        cases.append((f"{nb} blocks", blocks.contiguous(), tols))
    for what, blocks, tols in cases:
        l2 = floor_log2(tols)
        want = ref.zfp_encode_blocks_fa_ref(blocks, tols, l2)
        got = zfp_codec.zfp_encode_blocks_fa(blocks.to(dev), tols.to(dev), l2.to(dev))
        torch.cuda.synchronize()
        got = [g.cpu() for g in got]
        for name, g, w in zip(("payload", "emax", "nplanes"), got, want):
            require(torch.equal(g, w), f"encode kernel == plain ({what}, "
                                       f"{blocks.shape[0]} blocks): {name}")
        dec_want = ref.zfp_decode_blocks_fa_ref(*want)
        dec_got = zfp_codec.zfp_decode_blocks_fa(*(w.to(dev) for w in want)).cpu()
        require(same_bits(dec_got, dec_want),
                f"decode kernel == plain ({what}, 15 words)")
        w_trim = max((int(want[2].max()) + 1) // 2, 1)
        trimmed = want[0][:, :w_trim].contiguous()
        dec_got = zfp_codec.zfp_decode_blocks_fa(trimmed.to(dev), want[1].to(dev),
                                                 want[2].to(dev)).cpu()
        require(same_bits(dec_got, dec_want),
                f"decode kernel == plain ({what}, trimmed to {w_trim} words)")
    deep = torch.cat([main_blocks[:4096], special_blocks]).contiguous()
    deep_tols = torch.full((deep.shape[0],), 2.0 ** -126)
    full_p, full_e, _ = ref.zfp_encode_blocks_fa_ref(deep, deep_tols,
                                                     floor_log2(deep_tols))
    npl = torch.arange(deep.shape[0], dtype=torch.int32) % 31
    require(same_bits(zfp_codec.zfp_decode_blocks_fa(full_p.to(dev), full_e.to(dev),
                                                     npl.to(dev)),
                      ref.zfp_decode_blocks_fa_ref(full_p, full_e, npl)),
            "decode kernel == plain (full-depth words, counts 0..30 mask planes)")

    # fixed-rate kernels: every rate class on the main-path, F1 and zero blocks
    fr_blocks = torch.cat([main_blocks, special_blocks]).contiguous()
    fr_blocks_dev = fr_blocks.to(dev)
    for bits in FR_CHECK_BITS:
        want = ref.zfp_encode_blocks_ref(fr_blocks, bits)
        got = zfp_codec.zfp_encode_blocks(fr_blocks_dev, bits)
        for name, g, w in zip(("payload", "emax"), got, want):
            require(same_bits(g, w), f"fixed-rate encode kernel == plain ({bits} bits, "
                                     f"{fr_blocks.shape[0]} blocks): {name}")
        require(same_bits(zfp_codec.zfp_decode_blocks(want[0].to(dev), want[1].to(dev),
                                                      bits),
                          ref.zfp_decode_blocks_ref(want[0], want[1], bits)),
                f"fixed-rate decode kernel == plain ({bits} bits, "
                f"{(bits + 1) // 2} words)")
    for bits in (12, 30):
        want = ref.zfp_encode_blocks_ref(nonfinite, bits)
        got = zfp_codec.zfp_encode_blocks(nonfinite.to(dev), bits)
        for name, g, w in zip(("payload", "emax"), got, want):
            require(same_bits(g, w), f"fixed-rate encode kernel == plain (NaN and +-inf "
                                     f"blocks, {bits} bits): {name}")
        require(same_bits(zfp_codec.zfp_decode_blocks(want[0].to(dev), want[1].to(dev),
                                                      bits),
                          ref.zfp_decode_blocks_ref(want[0], want[1], bits)),
                f"fixed-rate decode kernel == plain (NaN and +-inf blocks, {bits} bits)")
    # the fixed-rate decode at every width: arbitrary words (every bit in use)
    # at 2W bits, and encoded blocks at 2W - 1 bits, at each block count
    for words in range(1, 16):
        bad = []
        for nb in CHECK_NB:
            p = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (nb, words),
                                              dtype=np.int64).astype(np.int32))
            e = torch.from_numpy(rng.integers(-40, 40, nb).astype(np.int32))
            pe, ee = ref.zfp_encode_blocks_ref(main_blocks[:nb].contiguous(), 2 * words - 1)
            for bits, pw, ew in ((2 * words, p, e), (2 * words - 1, pe, ee)):
                if not same_bits(zfp_codec.zfp_decode_blocks(pw.to(dev), ew.to(dev), bits),
                                 ref.zfp_decode_blocks_ref(pw, ew, bits)):
                    bad.append((nb, bits))
        require(not bad, f"fixed-rate decode kernel == plain at {words} words, "
                         f"{2 * words} and {2 * words - 1} bits, {len(CHECK_NB)} block "
                         f"counts {list(CHECK_NB)}" + (f": FAILED at {bad}" if bad else ""))
    # FA main-path streams at per-sample tolerances 1e-5..1e-1, padded to
    # the widest sample's words and decoded without nplanes (the
    # host-streaming stores' decode)
    nb_s = main_blocks.shape[0] // CHECK_SAMPLES
    sample_tols = torch.from_numpy(np.logspace(-5, -1, CHECK_SAMPLES).astype(np.float32))
    block_tols = sample_tols.repeat_interleave(nb_s)
    fa_p, fa_e, fa_n = ref.zfp_encode_blocks_fa_ref(main_blocks, block_tols,
                                                    floor_log2(block_tols))
    widths = [max((int(n.max()) + 1) // 2, 1) for n in fa_n.reshape(CHECK_SAMPLES, nb_s)]
    wmax = max(widths)
    padded = fa_p[:, :wmax].contiguous()
    dec_want = ref.zfp_decode_blocks_fa_ref(fa_p, fa_e, fa_n)
    require(same_bits(ref.zfp_decode_blocks_ref(padded, fa_e, 2 * wmax), dec_want),
            f"plain fixed-rate decode of FA streams == FA decode ({wmax} words)")
    require(same_bits(zfp_codec.zfp_decode_blocks(padded.to(dev), fa_e.to(dev), 2 * wmax),
                      dec_want),
            f"fixed-rate decode kernel of FA streams padded to {wmax} words (per-sample "
            f"widths {min(widths)}..{wmax}) == plain FA decode")

    # the whole store at per-sample tolerances 1e-5..1e-1 (plain on the card)
    blocks, tols = whole_store(dev, samples, spread=True)
    l2 = floor_log2(tols)
    got = zfp_codec.zfp_encode_blocks_fa(blocks, tols, l2)
    want = ref.zfp_encode_blocks_fa_ref(blocks, tols, l2)
    for name, g, w in zip(("payload", "emax", "nplanes"), got, want):
        require(same_bits(g, w), f"encode kernel == plain on the card ({blocks.shape[0]} "
                                 f"blocks, per-sample tolerances 1e-5..1e-1): {name}")


def whole_store(dev, samples: np.ndarray, spread: bool):
    """The whole study as (nb, 16) blocks on the card, with the store's
    tolerance 1e-3 per block, or per-sample tolerances spread over
    1e-5..1e-1 (logarithmically, as Algorithm 1 spreads them)."""
    from repro_torch.compression import transform as T
    xs = torch.from_numpy(samples).to(dev)
    blocks = T.blockify(T.pad_to_blocks(xs)).contiguous()
    per = blocks.shape[0] // samples.shape[0]
    if spread:
        t = torch.from_numpy(np.logspace(-5, -1, samples.shape[0]).astype(np.float32))
        tols = t.to(dev).repeat_interleave(per)
    else:
        tols = torch.full((blocks.shape[0],), TOLERANCE, device=dev)
    return blocks, tols


# the gathered decode's small stores: ragged fields that are cropped, one
# block a sample, a field without lead dims; batches whose block count is
# no multiple of a warp's eight blocks
GATHER_SHAPES = ((3, 10, 7), (1, 3, 2), (2, 12, 16), (10, 13))
GATHER_BATCHES = (1, 3, 13)


def step_batch(n_samples: int) -> torch.Tensor:
    """A training step's batch of indices: BATCH samples, shuffled, four of
    them repeated (the loader never repeats one; the decode must not care)."""
    idx = np.random.default_rng(4).choice(n_samples, BATCH, replace=False)
    idx[-4:] = idx[:4]
    return torch.from_numpy(idx)


def gather_checks(dev, store) -> None:
    """Kernel 1's gathered entry against its plain version (CPU), bit for
    bit: the full-width resident store at a step's batch (shuffled and
    repeated indices) and at one sample; small stores of ragged shapes at
    full depth, cut to each width 1..15 under random plane counts 0..30,
    at batches of 1, 3 and 13 samples.  Then one ``decode_indices`` is one
    kernel launch (launch counter and profiler)."""
    from repro_torch.compression import encode_fixed_accuracy_batch
    from repro_torch.kernels import ref, zfp_codec
    rng = np.random.default_rng(3)
    resident = [store.payload, store.emax, store.nplanes]
    host = [a.cpu() for a in resident]

    def same(arrays, idx, padded, shape, on_card=None):
        on_card = on_card or [a.to(dev) for a in arrays]
        got = zfp_codec.zfp_decode_blocks_fa_gather(*on_card, idx.to(dev), padded, shape)
        want = ref.zfp_decode_blocks_fa_gather_ref(*arrays, idx, padded, shape)
        return same_bits(got, want)

    idx = step_batch(store.num_samples)
    for what, i in ((f"a step's batch of {BATCH}, shuffled, 4 repeated", idx),
                    ("a batch of 1", idx[:1])):
        require(same(host, i, store.padded_shape, store.shape, resident),
                f"gathered decode kernel == plain (resident store {tuple(store.payload.shape)}"
                f", {what})")
    for shape in GATHER_SHAPES:
        n = 9
        xs = rng.standard_normal((n,) + shape) * 10.0 ** rng.integers(
            -3, 3, (n,) + (1,) * len(shape))
        cf = encode_fixed_accuracy_batch(torch.from_numpy(xs.astype(np.float32)),
                                         torch.full((n,), 2.0 ** -126))
        bad = []
        for words in range(1, 16):
            npl = torch.from_numpy(rng.integers(0, 31, cf.emax.shape).astype(np.int32))
            npl.view(-1)[:31] = torch.arange(31, dtype=torch.int32)[:npl.numel()]
            arrays = [cf.payload[..., :words].contiguous(), cf.emax, npl]
            for b in GATHER_BATCHES:
                i = torch.from_numpy(rng.integers(0, n, b))
                if not same(arrays, i, cf.padded_shape, cf.shape):
                    bad.append((words, b))
        nb = cf.emax.shape[1]
        require(not bad, f"gathered decode kernel == plain (shape {shape} padded to "
                         f"{cf.padded_shape}, {nb} blocks a sample, widths 1..15, plane "
                         f"counts 0..30, batches {list(GATHER_BATCHES)})"
                         + (f": FAILED at (words, batch) {bad}" if bad else ""))
    before = zfp_codec.LAUNCHES["zfp_decode_blocks_fa"]
    store.decode_indices(idx.to(dev))
    require(zfp_codec.LAUNCHES["zfp_decode_blocks_fa"] - before == 1,
            "decode_indices launches kernel 1 once")
    kernels = decode_indices_kernels(store, idx.to(dev))
    if kernels is None:
        print("decode_indices kernels: the profiler recorded no device time (not measured)")
    else:
        require(len(kernels) == 1 and kernels[0][1] == 1
                and "decode_fa_gather_kernel" in kernels[0][0],
                f"decode_indices is one kernel on the card (profiler: {kernels})")


def gathered_or_composed(payload, emax, nplanes, idx, padded_shape, shape):
    """The batch decode of a resident store with the kernels that are bound:
    the gathered kernel where the library has it, else (an older checkout's
    library) the composition that checkout ran: three torch gathers, the
    flat decode, the deblockify copy and the crop."""
    from repro_torch.kernels import zfp_codec
    if zfp_codec.has_gather(zfp_codec._libs):
        return zfp_codec.zfp_decode_blocks_fa_gather(payload, emax, nplanes, idx,
                                                     padded_shape, shape)
    return composed_decode(payload, emax, nplanes, idx, padded_shape, shape)


def composed_decode(payload, emax, nplanes, idx, padded_shape, shape):
    """Five launches: the parent's decode_indices on the bound flat kernel."""
    from repro_torch.compression import transform as T
    from repro_torch.compression.zfp import crop
    from repro_torch.kernels import zfp_codec
    b, (_, nb, w) = idx.shape[0], payload.shape
    blocks = zfp_codec.zfp_decode_blocks_fa(payload[idx].reshape(b * nb, w),
                                            emax[idx].reshape(b * nb),
                                            nplanes[idx].reshape(b * nb))
    return crop(T.deblockify(blocks, (b,) + tuple(padded_shape)), shape)


def in_turns(calls: dict, reps: int) -> dict:
    """Each call timed as before_after times one (events "ms", graph
    "graph_ms"), in turns: first, second, second, first."""
    names = list(calls)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append({"ms": cuda_ms(calls[n], reps=reps), "graph_ms": graph_ms(calls[n], reps)})
    return out


def codec_timings(dev, samples: np.ndarray, store, shard_batch, baseline: dict) -> dict:
    """The four ZFP kernels at the main paths' shapes: device ms per call
    with CUDA events around back-to-back launches ("ms") and replayed from a
    CUDA graph ("graph_ms"), beside the plain version and the bound; with
    baselines' libraries ({csrc: libraries}), theirs in turns with these.
    Kernel 1 at a device-resident step's batch of ``store``, flat (on the
    gathered copy) and gathered (beside the five-launch composition it
    replaces; a baseline without the gathered entry runs that composition on
    its flat kernel).  Kernel 2 at the three shapes its launches encode (the
    whole store, one ENCODE_CHUNK of samples, one shard), each at the
    store's tolerance and at per-sample tolerances 1e-5..1e-1, with the
    histogram of correction passes its blocks need.  Returns {kernel name:
    entry}."""
    from repro_torch.compression import floor_log2
    from repro_torch.kernels import ref, zfp_codec
    out = {}

    def report(name, shape, t):
        def f(x):
            return "not captured" if x is None else f"{x:.5f}"
        runs = "; ".join(f"{who} " + ", ".join(f"{f(r['ms'])} ({f(r['graph_ms'])} graph)"
                                              for r in rs) for who, rs in t.items())
        print(f"{name} {shape}: ms per call, events (graph): {runs}", flush=True)

    def mean(rs, key):
        vals = [r[key] for r in rs if r[key] is not None]
        return sum(vals) / len(vals) if vals else None

    def entry(t, plain_ms, bound, err, shape, **extra):
        e = {"max_abs_err": err, "ms": mean(t["new"], "ms"),
             "graph_ms": mean(t["new"], "graph_ms"), "plain_ms": plain_ms,
             "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
             "shape": list(shape), **extra}
        others = {who: {"ms": mean(rs, "ms"), "graph_ms": mean(rs, "graph_ms")}
                  for who, rs in t.items() if who != "new"}
        if others:
            e["baselines"] = others
        return e

    # kernel 1 at the device-resident step's batch: flat on the gathered
    # copy, and gathered from the resident store
    idx = step_batch(store.num_samples).to(dev)
    words = store.payload.shape[-1]
    bp = store.payload[idx].reshape(-1, words).contiguous()
    be, bn = store.emax[idx].reshape(-1).contiguous(), store.nplanes[idx].reshape(-1).contiguous()
    nb = bp.shape[0]
    t = before_after(zfp_codec.zfp_decode_blocks_fa, (bp, be, bn), 200, baseline)
    report("zfp_decode_blocks_fa", (nb, words), t)
    err = float((ref.zfp_decode_blocks_fa_ref(bp, be, bn)
                 - zfp_codec.zfp_decode_blocks_fa(bp, be, bn)).abs().max())
    require(err == 0.0, f"decode kernel == plain version on the card ({nb} blocks)")
    bound = bound_ms(nb * (words * 4 + 8) + nb * 64, decode_ops(nb, words))
    out["zfp_decode_blocks_fa"] = entry(
        t, cuda_ms(lambda: ref.zfp_decode_blocks_fa_ref(bp, be, bn), reps=20),
        bound, err, (nb, words))
    args = (store.payload, store.emax, store.nplanes, idx, store.padded_shape, store.shape)
    tg = before_after(gathered_or_composed, args, 200, baseline)
    report("zfp_decode_blocks_fa gathered (baselines: their composition)",
           (BATCH, *store.shape), tg)
    tc = in_turns({"composed": lambda: composed_decode(*args),
                   "gathered": lambda: zfp_codec.zfp_decode_blocks_fa_gather(*args)}, 200)
    report("zfp_decode_blocks_fa gathered beside the composition on this flat kernel",
           (BATCH, *store.shape), tc)
    got = zfp_codec.zfp_decode_blocks_fa_gather(*args)
    err_g = float((ref.zfp_decode_blocks_fa_gather_ref(*args) - got).abs().max())
    require(err_g == 0.0 and same_bits(got, composed_decode(*args)),
            f"gathered decode kernel == plain version and == the composition on the "
            f"card ({BATCH} samples, {nb} blocks)")
    gathered = entry(tg, cuda_ms(lambda: ref.zfp_decode_blocks_fa_gather_ref(*args), reps=20),
                     bound_ms(nb * (words * 4 + 8) + nb * 64 + 8 * BATCH,
                              decode_ops(nb, words)),
                     err_g, (BATCH, *store.shape))
    gathered["in_turns"] = {who: {"ms": mean(rs, "ms"), "graph_ms": mean(rs, "graph_ms")}
                            for who, rs in tc.items()}
    out["zfp_decode_blocks_fa"]["gathered"] = gathered

    # kernel 3 at one sharded batch
    sp, se = shard_batch
    nb, words = sp.shape
    t = before_after(zfp_codec.zfp_decode_blocks, (sp, se, 2 * words), 200, baseline)
    report("zfp_decode_blocks", (nb, words), t)
    err = float((ref.zfp_decode_blocks_ref(sp, se, 2 * words)
                 - zfp_codec.zfp_decode_blocks(sp, se, 2 * words)).abs().max())
    require(err == 0.0, f"fixed-rate decode kernel == plain version on the card ({nb} "
                        f"blocks x {words} words)")
    out["zfp_decode_blocks"] = entry(
        t, cuda_ms(lambda: ref.zfp_decode_blocks_ref(sp, se, 2 * words), reps=20),
        bound_ms(nb * (words * 4 + 4) + nb * 64, fr_decode_ops(nb, words)), err,
        (nb, words))

    # kernel 2 at three shapes, two tolerance settings
    shapes = {}
    for setting, spread in (("tol 1e-3", False), ("tol 1e-5..1e-1", True)):
        blocks, tols = whole_store(dev, samples, spread)
        l2 = floor_log2(tols)
        per = blocks.shape[0] // samples.shape[0]
        passes, checks = count_passes(blocks, tols, l2)
        hist = torch.bincount(passes, minlength=7).tolist()
        print(f"zfp_encode_blocks_fa, {setting}: blocks needing 0..6 correction passes "
              f"{hist}; error checks with the early exit {int(checks.sum())} "
              f"({float(checks.float().mean()):.4f} per block; the six-pass kernel ran "
              f"{6 * blocks.shape[0]})", flush=True)
        for shape_name, n_samples, reps in (("whole store", samples.shape[0], 5),
                                            ("ENCODE_CHUNK", 256, 20),
                                            ("shard", SHARD_SIZE, 100)):
            n = n_samples * per
            args = (blocks[:n], tols[:n], l2[:n])
            t = before_after(zfp_codec.zfp_encode_blocks_fa, args, reps, baseline)
            report(f"zfp_encode_blocks_fa {setting}, {shape_name}", (n, 16), t)
            n_checks = int(checks[:n].sum())
            shapes[f"{shape_name}, {setting}"] = entry(
                t, None, bound_ms(n * 140, encode_ops(n, n_checks)), None, (n, 16),
                pass_histogram=torch.bincount(passes[:n], minlength=7).tolist(),
                error_checks=n_checks)
        if not spread:
            got = zfp_codec.zfp_encode_blocks_fa(blocks, tols, l2)
            want = ref.zfp_encode_blocks_fa_ref(blocks, tols, l2)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            require(err == 0.0, f"encode kernel == plain version on the card "
                                f"({blocks.shape[0]} blocks)")
            plain = cuda_ms(lambda: ref.zfp_encode_blocks_fa_ref(blocks, tols, l2),
                            reps=2, warmup=1)
            nb_enc = blocks.shape[0]
            del got, want
        del blocks, tols, l2, passes, checks
    main = shapes["whole store, tol 1e-3"]
    out["zfp_encode_blocks_fa"] = {
        **main, "max_abs_err": err, "plain_ms": plain,
        # PR 11's count: a scalar 30-plane pack and six unconditional passes
        "bound_ms_pr11_count": bound_ms(nb_enc * 140, nb_enc * 3868)[0],
        "shapes": shapes}

    # kernel 4 at the whole store, FR_BITS
    blocks, _ = whole_store(dev, samples, False)
    words = (FR_BITS + 1) // 2
    t = before_after(zfp_codec.zfp_encode_blocks, (blocks, FR_BITS), 10, baseline)
    report("zfp_encode_blocks", (nb_enc, words), t)
    err = max(float((a - b).abs().max()) for a, b in zip(
        zfp_codec.zfp_encode_blocks(blocks, FR_BITS),
        ref.zfp_encode_blocks_ref(blocks, FR_BITS)))
    require(err == 0.0, f"fixed-rate encode kernel == plain version on the card "
                        f"({nb_enc} blocks, {FR_BITS} bits)")
    out["zfp_encode_blocks"] = entry(
        t, cuda_ms(lambda: ref.zfp_encode_blocks_ref(blocks, FR_BITS), reps=2, warmup=1),
        bound_ms(nb_enc * 64 + nb_enc * (4 * words + 4), fr_encode_ops(nb_enc, words)), err,
        (nb_enc, words))
    return out


def codec_batches(dev, samples: np.ndarray):
    """Without the training paths: the device-resident store of the whole
    study at the store's tolerance (kernel 1's input) and kernel 3's batch,
    a step's batch of it flattened (as a sharded store's batch holds it)."""
    from repro_torch.data import DeviceResidentCompressedStore
    store = DeviceResidentCompressedStore.from_samples(
        samples, np.full(samples.shape[0], TOLERANCE, np.float32), device=dev)
    idx = step_batch(store.num_samples).to(dev)
    words = store.payload.shape[-1]
    return store, (store.payload[idx].reshape(-1, words).contiguous(),
                   store.emax[idx].reshape(-1).contiguous())


ATTN_CASES = [
    # b, hq, hkv, sq, sk, d, causal, window, dtype (tests/test_kernels.py:141)
    (2, 4, 2, 64, 64, 32, True, None, torch.float32),
    (1, 8, 2, 1, 128, 64, True, None, torch.float32),
    (1, 4, 4, 96, 96, 16, False, None, torch.float32),
    (2, 2, 1, 128, 128, 32, True, 48, torch.float32),
    (1, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
    (1, 2, 2, 80, 80, 24, True, None, torch.float32),
]
# the new kernels' own cases: (case as above, the variant that must run)
VARIANT_CASES = [
    ((2, 4, 2, 80, 80, 64, True, 48, torch.bfloat16), "prefill_wgmma"),     # window, ragged
    ((1, 4, 2, 200, 200, 128, False, None, torch.bfloat16), "prefill_wgmma"),
    ((2, 4, 2, 100, 300, 128, True, None, torch.bfloat16), "prefill_wgmma"),  # Sq < Sk
    ((2, 4, 2, 130, 130, 64, True, None, torch.bfloat16), "prefill_wgmma"),
]
PREFILL_S = (256, 512, 1024)
CHECK_KV_LENS = (1, 17, 256, 300, 513, 700, 1024, 1088)
SPLIT_KV_LENS = (127, 128, 129, 1088, 1, 64, 700, 1087)   # at and around split edges
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def attn_bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_TENSOR_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_times(q, k, v, reps: int, mask=None, q_dtype=None, causal: bool = True) -> dict:
    """``scaled_dot_product_attention`` with ``enable_gqa`` (``is_causal=causal``
    without a mask, else the explicit boolean mask), pinned to each backend
    in turn: {backend: {"ms": device ms per call (CUDA graph), "eager_ms":
    ms per call launched from Python}, or None where it refuses the call}.
    With ``q_dtype`` each call first casts q to it (part of the timed
    call).  The library yardstick, never on the port's path."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    kw = {"is_causal": causal} if mask is None else {"attn_mask": mask}
    out = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        out[name.lower()] = None
        if backend is None:
            print(f"  SDPA {name}: not in this PyTorch")
            continue

        def call():
            qq = q if q_dtype is None else q.to(q_dtype)
            return F.scaled_dot_product_attention(qq, k, v, enable_gqa=True, **kw)

        try:
            with sdpa_kernel(backend):
                call()
                torch.cuda.synchronize()
                out[name.lower()] = {"ms": graph_ms(call, reps),
                                     "eager_ms": cuda_ms(call, reps=reps)}
        except (RuntimeError, TypeError) as e:     # the backend refuses these inputs
            print(f"  SDPA {name}: not accepted ({str(e).splitlines()[0][:100]})")
    return out


def fastest(times: dict):
    """(device ms, backend) of the fastest backend that accepted the call."""
    ok = {n: t["ms"] for n, t in times.items() if t is not None and t["ms"] is not None}
    if not ok:
        return None, None
    name = min(ok, key=ok.get)
    return ok[name], name


def check_attention(what, q, k, v, variant=None, scalar=False, **kw) -> float:
    """Kernel 5 (the variant ``select_variant`` picks, or with ``scalar``
    the scalar one) against its plain version on the same inputs, to
    ``ATTN_ATOL``; requires that exactly one variant ran, ``variant`` if
    given.  Returns the largest error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    before = dict(fa.VARIANT_LAUNCHES)
    if scalar:
        got = fa._launch(q, k, v, causal=kw.get("causal", True), sm_scale=None,
                         window=kw.get("window"), kv_lens=kw.get("kv_lens"),
                         variant="scalar")
    else:
        got = fa.flash_attention(q, k, v, **kw)
    ran = [n for n in fa.VARIANTS if fa.VARIANT_LAUNCHES[n] != before[n]]
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_ATOL[q.dtype]
    require(got.dtype == q.dtype and got.shape == want.shape and err <= tol
            and len(ran) == 1 and (variant is None or ran[0] == variant),
            f"flash_attention kernel == plain ({what}; {'/'.join(ran)} ran"
            f"{'' if variant is None else f', {variant} required'}): max err {err:.3e} "
            f"<= {tol}")
    return err


def attention_checks(dev, cfg) -> float:
    """Kernel 5 against its plain version on the card: the kernel tests' six
    cases, the new kernels' own cases (windowed, ragged, D = 64, Sq < Sk, the
    lockstep prefill at B = 8), the full-width prefill shapes, and decode
    (bf16 q against the f32 cache in its (B, max_seq, Hkv, D) layout: mixed
    kv_lens, kv_lens at the split edges, GQA groups of 2, 8 and 1, a window,
    Sq = 3), each naming the variant that ran; the scalar variant at the
    main path's shapes too.  Returns the worst error."""
    g = torch.Generator(device=dev).manual_seed(1)

    def rn(shape, dt):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    worst = 0.0

    def check(*args, **kw):
        nonlocal worst
        worst = max(worst, check_attention(*args, **kw))

    def case(c, variant=None):
        b, hq, hkv, sq, sk, d, causal, window, dt = c
        check(f"b{b} hq{hq} hkv{hkv} sq{sq} sk{sk} d{d} causal={causal} window={window} "
              f"{dt}", rn((b, hq, sq, d), dt), rn((b, hkv, sk, d), dt), rn((b, hkv, sk, d), dt),
              variant=variant, causal=causal, window=window)

    for c in ATTN_CASES:
        case(c)
    for c, variant in VARIANT_CASES:
        case(c, variant)
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    bf = torch.bfloat16
    for b, s in [(1, s) for s in PREFILL_S] + [(LM_SLOTS, PREFILL_S[-1])]:
        q, k, v = rn((b, h, s, d), bf), rn((b, hkv, s, d), bf), rn((b, hkv, s, d), bf)
        check(f"prefill {b}x{h}x{s}x{d} over {hkv} KV heads, bf16", q, k, v, "prefill_wgmma")
        if b == 1 and s == PREFILL_S[-1]:
            check(f"prefill {b}x{h}x{s}x{d}, the scalar variant", q, k, v, "scalar",
                  scalar=True)
    n, ms = LM_SLOTS, LM_MAX_SEQ
    ck, cv = rn((n, ms, hkv, d), torch.float32), rn((n, ms, hkv, d), torch.float32)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    for lens_t, hq, sq, window, what in [
            (CHECK_KV_LENS, h, 1, None, "mixed kv_lens"),
            (SPLIT_KV_LENS, h, 1, None, "kv_lens at split edges"),
            (SPLIT_KV_LENS, 8 * hkv, 1, None, f"group 8 ({8 * hkv} q heads)"),
            (SPLIT_KV_LENS, hkv, 1, None, "group 1"),
            (CHECK_KV_LENS, h, 1, 200, "window 200"),
            (SPLIT_KV_LENS, h, 3, None, "Sq 3"),
            (SPLIT_KV_LENS, 8 * hkv, 8, 300, "group 8, Sq 8, window 300")]:
        lens_t = tuple(max(x, sq) for x in lens_t)     # every query sees a key
        lens = torch.tensor(lens_t, dtype=torch.int32, device=dev)
        q = rn((n, hq, sq, d), bf)
        check(f"decode bf16 q ({n},{hq},{sq},{d}) against the f32 cache, {what}, kv_lens "
              f"{list(lens_t)}", q, kt, vt, "decode_splitkv", kv_lens=lens, window=window)
    lens = torch.tensor(CHECK_KV_LENS, dtype=torch.int32, device=dev)
    check(f"decode bf16 q ({n},{h},1,{d}) against the f32 cache, the scalar variant",
          rn((n, h, 1, d), bf), kt, vt, "scalar", scalar=True, kv_lens=lens)
    return worst


def attention_timings(dev, cfg, lens_np: np.ndarray, smi: str) -> dict:
    """Kernel 5 at the main path's shapes (prefill of one request at
    PREFILL_S tokens and of the lockstep batch, and the decode step at the
    given depths): the variant the rule picks, the scalar variant, the
    plain version and each SDPA
    backend, in one call, beside the bound.  "ms" is device time per call
    (calls replayed from a CUDA graph); "eager_ms" is per call launched from
    Python one after another, host dispatch included."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(2)
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    bf = torch.bfloat16
    timings = {}

    def both(fn, reps):
        return graph_ms(fn, reps), cuda_ms(fn, reps=reps)

    def scalar(q, k, v, **kw):
        return fa._launch(q, k, v, causal=True, sm_scale=None, window=None,
                          kv_lens=kw.get("kv_lens"), variant="scalar")

    for b, s in [(1, s) for s in PREFILL_S] + [(LM_SLOTS, PREFILL_S[-1])]:
        q = torch.randn((b, h, s, d), generator=g, device=dev).to(bf)
        k = torch.randn((b, hkv, s, d), generator=g, device=dev).to(bf)
        v = torch.randn((b, hkv, s, d), generator=g, device=dev).to(bf)
        t = {"variant": fa.select_variant(q, k, v, None, None)}
        t["ms"], t["eager_ms"] = both(lambda: fa.flash_attention(q, k, v), 50)
        t["scalar_ms"], t["scalar_eager_ms"] = both(lambda: scalar(q, k, v), 10)
        t["plain_ms"], t["plain_eager_ms"] = both(lambda: ref.flash_attention_ref(q, k, v),
                                                  3 if b > 1 else 10)
        t["sdpa"] = sdpa_times(q, k, v, reps=50)
        t["library_ms"], t["library_backend"] = fastest(t["sdpa"])
        t["bound_ms"], t["bound_by"] = attn_bound_ms(
            2 * (2 * b * h * s * d) + 2 * (2 * b * hkv * s * d), 4 * b * h * d * s * (s + 1) / 2)
        timings[f"prefill_{s}" if b == 1 else f"prefill_{b}x{s}"] = t
    lens = torch.from_numpy(lens_np).to(dev)
    q = torch.randn((LM_SLOTS, h, 1, d), generator=g, device=dev).to(bf)
    ck = torch.randn((LM_SLOTS, LM_MAX_SEQ, hkv, d), generator=g, device=dev)
    cv = torch.randn((LM_SLOTS, LM_MAX_SEQ, hkv, d), generator=g, device=dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    kb, vb = kt.to(bf).contiguous(), vt.to(bf).contiguous()
    dmask = (torch.arange(LM_MAX_SEQ, device=dev)[None] < lens[:, None])[:, None, None]
    t = {"variant": fa.select_variant(q, kt, vt, lens, None),
         "splits": list(fa.split_plan(LM_SLOTS, hkv, LM_MAX_SEQ))}
    t["ms"], t["eager_ms"] = both(lambda: fa.flash_attention(q, kt, vt, kv_lens=lens), 100)
    t["scalar_ms"], t["scalar_eager_ms"] = both(lambda: scalar(q, kt, vt, kv_lens=lens), 100)
    t["plain_ms"], t["plain_eager_ms"] = both(
        lambda: ref.flash_attention_ref(q, kt, vt, kv_lens=lens), 20)
    t["sdpa"] = sdpa_times(q, kb, vb, reps=100, mask=dmask)
    t["library_ms"], t["library_backend"] = fastest(t["sdpa"])
    # the kernel's own function: bf16 q upcast to f32 against the f32 cache
    # views, the kv_lens mask
    t["sdpa_same"] = sdpa_times(q, kt, vt, reps=100, mask=dmask, q_dtype=torch.float32)
    t["same_library_ms"], t["same_library_backend"] = fastest(t["sdpa_same"])
    keys = int(lens_np.sum())
    t["bound_ms"], t["bound_by"] = attn_bound_ms(keys * hkv * d * 2 * 4 + 2 * (
        2 * LM_SLOTS * h * d) + 4 * LM_SLOTS, 4 * h * d * keys)
    t["kv_lens"] = lens_np.tolist()
    timings["decode"] = t

    def f(x):
        return "not measured" if x is None else f"{x:.4f}"

    def sdpa_line(times):
        return ", ".join(f"{n} refused" if x is None else
                         f"{n} {f(x['ms'])} ({f(x['eager_ms'])} eager)"
                         for n, x in times.items())

    for name, t in timings.items():
        same = ("" if "sdpa_same" not in t else
                f"; SDPA on the same function (q upcast to f32, the f32 cache, the "
                f"kv_lens mask): {sdpa_line(t['sdpa_same'])}")
        print(f"flash_attention {name} (ms per call on the device; eager in brackets): "
              f"{t['variant']} {f(t['ms'])} ({f(t['eager_ms'])}), scalar "
              f"{f(t['scalar_ms'])} ({f(t['scalar_eager_ms'])}), plain {f(t['plain_ms'])} "
              f"({f(t['plain_eager_ms'])}), bound {t['bound_ms']:.5f} ({t['bound_by']}); "
              f"SDPA{' on a bf16 copy of the cache' if name == 'decode' else ''}: "
              f"{sdpa_line(t['sdpa'])}{same}; {smi}", flush=True)
    return timings


def _replay(lm, params, cfg, reqs, dev, max_seq: int = LM_MAX_SEQ):
    """Teacher-forced logits of the served tokens through ``lm_prefill`` and
    ``serve_step``: chunks of LM_SLOTS requests, right-padded prompts,
    per-slot positions.  Returns per chunk ((T, B, V) logits, (T, B) mask of
    the steps that produced a served token, (T, B) served tokens)."""
    out = []
    for i in range(0, len(reqs), LM_SLOTS):
        chunk = reqs[i:i + LM_SLOTS]
        n, plen = len(chunk), max(len(r.prompt) for r in chunk)
        steps = max(r.max_new_tokens for r in chunk)
        toks = np.zeros((n, plen), np.int32)
        served = np.zeros((steps, n), np.int64)
        valid = np.zeros((steps, n), bool)
        for j, r in enumerate(chunk):
            toks[j, :len(r.prompt)] = r.prompt
            served[:len(r.output), j] = r.output
            served[len(r.output):, j] = r.output[-1]
            valid[:len(r.output), j] = True
        lens = np.array([len(r.prompt) for r in chunk], np.int32)
        logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(toks).to(dev)},
                                      max_seq, cache_dtype=torch.float32,
                                      prompt_lens=torch.from_numpy(lens).to(dev))
        all_logits = [logits]
        for t in range(steps - 1):
            logits, cache = lm.serve_step(params, cfg, cache,
                                          torch.from_numpy(served[t]).to(dev),
                                          torch.from_numpy(lens + t).to(dev))
            all_logits.append(logits)
        del cache
        out.append((torch.stack(all_logits), torch.from_numpy(valid).to(dev),
                    torch.from_numpy(served).to(dev)))
    return out


def serve_modes(engine, cfg, prompt_lens, new_tokens, n_requests: int = LM_REQUESTS,
                modes=("run", "run_lockstep")) -> dict:
    """Serve ``n_requests`` requests of the seeded workload with continuous
    batching (``run``) and in lockstep (or the given ``modes``), each with
    kernel 5's counts set to 0
    just before it; print each mode's rates, latencies and kernel-5
    launches.  Requires every request back with its tokens in the vocab and
    every launch of kernel 5 in a prefill or a decode step.  Returns {mode:
    (requests in submission order, {"prefill", "decode", "variants",
    "stats"}, the per-slot depths of every decode step)}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.loadgen import latency_percentiles, lm_workload

    # attribute each launch of kernel 5 (and of each of its variants) to
    # prefill or decode; keep the per-slot depths of every decode step
    counts = {"prefill": 0, "decode": 0}
    variants = {phase: dict.fromkeys(fa.VARIANTS, 0) for phase in counts}
    depths = []

    def counted(phase, fn):
        def wrapped(*args):
            before = fa.LAUNCHES["flash_attention"]
            before_v = dict(fa.VARIANT_LAUNCHES)
            out = fn(*args)
            counts[phase] += fa.LAUNCHES["flash_attention"] - before
            for name in fa.VARIANTS:
                variants[phase][name] += fa.VARIANT_LAUNCHES[name] - before_v[name]
            if phase == "decode":
                depths.append(np.array(args[2], np.int32))
            return out
        return wrapped

    prefill, decode = engine._prefill, engine._decode_step
    engine._prefill = counted("prefill", prefill)
    engine._decode_step = counted("decode", decode)
    runs = {}
    try:
        for mode in modes:
            engine.stats = {k: type(v)() for k, v in engine.stats.items()}
            counts.update(prefill=0, decode=0)
            for phase in variants:
                variants[phase] = dict.fromkeys(fa.VARIANTS, 0)
            depths.clear()
            fa.reset_launches()
            reqs = lm_workload(cfg.vocab_size, n_requests, prompt_lens=prompt_lens,
                               new_tokens=new_tokens, seed=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = getattr(engine, mode)(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pct = latency_percentiles(done)
            st = engine.stats
            step_ms = 1e3 * st["decode_seconds"] / max(st["decode_steps"], 1)
            print(f"serve {cfg.name} {mode}: {len(done)} requests in {wall:.3f} s; decode "
                  f"{engine.tokens_per_second:.1f} tok/s ({st['tokens']} tokens, "
                  f"{st['decode_steps']} steps, {st['decode_seconds']:.3f} s, "
                  f"{step_ms:.3f} ms/step); prefill {engine.prefill_tokens_per_second:.1f} "
                  f"tok/s ({st['prefill_tokens']} tokens, {st['prefill_seconds']:.3f} s); "
                  f"latency p50 {pct['p50']:.4f} s p99 {pct['p99']:.4f} s mean "
                  f"{pct['mean']:.4f} s; slot utilisation {engine.slot_utilization:.4f}; "
                  f"flash_attention launches prefill {counts['prefill']} "
                  f"{variants['prefill']} decode {counts['decode']} {variants['decode']}",
                  flush=True)
            require(fa.LAUNCHES["flash_attention"] == counts["prefill"] + counts["decode"],
                    f"every flash_attention launch of {mode} is in prefill or decode")
            require(len(done) == n_requests and all(
                r.output is not None and len(r.output) == r.max_new_tokens
                and 0 <= r.output.min() and r.output.max() < cfg.vocab_size for r in done),
                f"{mode}: every request returned with max_new_tokens tokens in the vocab")
            order = {id(r): i for i, r in enumerate(reqs)}
            stats = {"wall_s": wall, "decode_tok_s": engine.tokens_per_second,
                     "prefill_tok_s": engine.prefill_tokens_per_second,
                     "decode_step_ms": step_ms, "p50_s": pct["p50"], "p99_s": pct["p99"],
                     "slot_utilisation": engine.slot_utilization,
                     "decode_steps": st["decode_steps"], "tokens": st["tokens"]}
            runs[mode] = (sorted(done, key=lambda r: order[id(r)]),
                          {**counts, "variants": {ph: dict(c) for ph, c in variants.items()},
                           "stats": stats},
                          list(depths))
    finally:
        # back to the class's methods: bound methods kept on the instance
        # would make a cycle that holds the engine's parameters until the
        # next garbage collection
        del engine._prefill, engine._decode_step
    return runs


def lm_serving_path(dev, smi: str) -> dict:
    """Serve the seeded workload on the full-width dense LM with continuous
    batching and in lockstep, check the tokens and the kernel against plain
    attention, time kernel 5; returns its ``kernels`` entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.loadgen import lm_workload

    cfg = get_config(LM_ARCH)
    worst = attention_checks(dev, cfg)
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    n_params = sum(t.numel() for t in leaves)
    print(f"lm: {cfg.name} at full width ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} q heads over {cfg.num_kv_heads} KV heads, head dim {cfg.hdim}, "
          f"ff {cfg.d_ff}, vocab {cfg.vocab_size}), {n_params} parameters "
          f"({sum(t.numel() * t.element_size() for t in leaves)} bytes bf16), init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    require(n_params == lm.param_count(cfg), f"parameter count == param_count "
                                             f"({n_params})")
    engine = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    # warm-up (cuBLAS handles, the caching allocator); not counted
    engine.run(lm_workload(cfg.vocab_size, 2, prompt_lens=(8,), new_tokens=(2,), seed=1))
    torch.cuda.synchronize()

    runs = {**serve_modes(engine, cfg, LM_PROMPTS, LM_NEW, modes=("run",)),
            **serve_modes(engine, cfg, LM_PROMPTS, LM_NEW, n_requests=LM_LOCKSTEP_REQUESTS,
                          modes=("run_lockstep",))}
    for mode, (_, c, _) in runs.items():
        require(c["prefill"] > 0 and c["decode"] > 0,
                f"flash_attention launched in prefill and in decode ({mode})")
        require(c["variants"]["prefill"]["prefill_wgmma"] == c["prefill"],
                f"every prefill launch of {mode} ran prefill_wgmma ({c['variants']['prefill']})")
        require(c["variants"]["decode"]["decode_splitkv"] == c["decode"],
                f"every decode launch of {mode} ran decode_splitkv ({c['variants']['decode']})")

    # the lockstep workload is the first LM_LOCKSTEP_REQUESTS of run's
    by_mode = [np.concatenate([r.output for r in runs[m][0][:LM_LOCKSTEP_REQUESTS]])
               for m in runs]
    print(f"run vs run_lockstep: {np.mean(by_mode[0] == by_mode[1]):.4f} of "
          f"{by_mode[0].size} greedy tokens equal (bf16 prefill in other batch shapes)")

    # teacher-forced replay: kernel vs plain attention on the card
    served = runs["run"][0]
    kernel_replay = _replay(lm, params, cfg, served, dev)
    n_launch = fa.LAUNCHES["flash_attention"]

    def plain(q, k, v, **kw):
        return ref.flash_attention_ref(q, k, v, **kw)

    with mock.patch.object(ops, "flash_attention", plain):
        plain_replay = _replay(lm, params, cfg, served, dev)
    require(fa.LAUNCHES["flash_attention"] == n_launch,
            "the plain replay launched no kernel")
    err, agree, match_k, match_p, n = 0.0, 0, 0, 0, 0
    for (lk, valid, tok), (lp, _, _) in zip(kernel_replay, plain_replay):
        require(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all()),
                "replay logits are finite")
        err = max(err, float(((lk - lp).abs().amax(-1))[valid].max()))
        ak, ap = lk.argmax(-1), lp.argmax(-1)
        agree += int((ak == ap)[valid].sum())
        match_k += int((ak == tok)[valid].sum())
        match_p += int((ap == tok)[valid].sum())
        n += int(valid.sum())
    print(f"replay of {n} served tokens, teacher-forced: logits kernel vs plain attention "
          f"max abs diff {err:.4f}; greedy agreement kernel/plain {agree / n:.4f}, "
          f"served/kernel replay {match_k / n:.4f}, served/plain replay {match_p / n:.4f}")
    require(err <= LOGIT_ATOL, f"teacher-forced logits with the kernel == with the plain "
                               f"attention (max abs diff {err:.4f} <= {LOGIT_ATOL})")
    del kernel_replay, plain_replay

    # kernel 5 at the main path's shapes: prefill and the decode step at the
    # median depths of the continuous-batching run
    run_depths = runs["run"][2]
    timings = attention_timings(dev, cfg, run_depths[len(run_depths) // 2] + 1, smi)
    # where a serving step's time goes: decode at the first chunk's depths
    chunk = served[:LM_SLOTS]
    plen = max(len(r.prompt) for r in chunk)
    toks = np.zeros((LM_SLOTS, plen), np.int32)
    for j, r in enumerate(chunk):
        toks[j, :len(r.prompt)] = r.prompt
    lens_np = np.array([len(r.prompt) for r in chunk], np.int32)
    logits, cache = engine._prefill(toks, lens_np)
    profile_serving(engine, lm, cache, logits.argmax(-1).cpu().numpy(), lens_np)
    del cache

    launches = {m: c for m, (_, c, _) in runs.items()}
    by_variant = {name: sum(c["variants"][ph][name] for c in launches.values()
                            for ph in c["variants"]) for name in fa.VARIANTS}
    main = timings[f"prefill_{PREFILL_S[-1]}"]
    dec = timings["decode"]
    keep = ("ms", "eager_ms", "scalar_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_backend")
    h, d = cfg.num_heads, cfg.hdim
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:105",
            "launches": sum(c["prefill"] + c["decode"] for c in launches.values()),
            "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "library_backend": main["library_backend"],
            "shape": [1, h, PREFILL_S[-1], d],
            "variants": {
                "prefill_wgmma": {"launches": by_variant["prefill_wgmma"],
                                  **{k: main[k] for k in keep},
                                  "shape": [1, h, PREFILL_S[-1], d]},
                "decode_splitkv": {"launches": by_variant["decode_splitkv"],
                                   **{k: dec[k] for k in keep},
                                   "same_library_ms": dec["same_library_ms"],
                                   "same_library_backend": dec["same_library_backend"],
                                   "shape": [LM_SLOTS, h, 1, d],
                                   "kv_lens": dec["kv_lens"]},
                "scalar": {"launches": by_variant["scalar"]}},
            "launches_by_run": launches, "timings": timings,
            "logit_max_abs_diff": err, "greedy_agreement": agree / n}


def run_launcher(steps: int, ckpt_dir: str) -> str:
    """``python -m repro_torch.launch.train`` on the card as a subprocess;
    returns its standard output."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
           "--steps", str(steps), "--ckpt-dir", ckpt_dir]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(ROOT),
                       timeout=300)
    print(f"launcher {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; last lines: "
          f"{' | '.join(r.stdout.strip().splitlines()[-3:])}", flush=True)
    require(r.returncode == 0, f"the launcher ran {steps} steps on the card "
                               f"({r.stderr.strip().splitlines()[-1:] if r.returncode else ''})")
    return r.stdout


def run_dryrun() -> dict:
    """``python -m repro_torch.launch.train --arch LM_ARCH --shape
    DRYRUN_CELL --dry-run`` as a subprocess: the dry run of the full
    config on the (16, 16) mesh, on the CPU (a fake process group, meta
    tensors).  Checks its ``OK`` line and its JSON; returns the record."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
           "--shape", DRYRUN_CELL, "--dry-run"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=str(ROOT),
                       timeout=300)
    ok = [l for l in r.stdout.splitlines() if l.startswith("[dryrun] OK")]
    print(f"dry run {' '.join(cmd[1:])}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {ok[-1] if ok else 'no OK line'}", flush=True)
    require(r.returncode == 0 and len(ok) == 1,
            f"the launcher's dry run of {LM_ARCH} x {DRYRUN_CELL} passed "
            f"({r.stderr.strip().splitlines()[-1:] if r.returncode else ''})")
    path = ROOT / "experiments" / "dryrun_torch" / f"{LM_ARCH}_{DRYRUN_CELL}_16x16.json"
    rec = json.loads(path.read_text())
    require(rec["n_chips"] == 256 and rec["flops_per_device"] > 0
            and rec["collective_bytes_per_device"] > 0
            and all(math.isfinite(v) and v > 0 for v in rec["terms"].values()),
            f"the dry run's record has finite terms ({rec['terms']})")
    return rec


class LauncherRuns:
    """The LM training launcher on the card, run and then resumed from its
    step-5 checkpoint, on a thread, and its dry run of the full config on
    the CPU, on another: subprocesses started beside the kernel build (the
    launcher builds no kernel and nothing of them is timed) and joined
    before the first timed phase."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_launcher_")
        self.out, self.error, self.seconds, self.dryrun = None, None, None, None
        self.dry_error = None
        self.thread = threading.Thread(target=self._run)
        self.thread.start()
        self.dry_thread = threading.Thread(target=self._run_dryrun)
        self.dry_thread.start()

    def _run(self):
        t0 = time.perf_counter()
        try:
            self.out = [run_launcher(n, self.tmp.name) for n in LM_LAUNCHER_STEPS]
        except BaseException as e:      # re-raised by join, on the main thread
            self.error = e
        self.seconds = time.perf_counter() - t0

    def _run_dryrun(self):
        try:
            self.dryrun = run_dryrun()
        except BaseException as e:      # re-raised by join, on the main thread
            self.dry_error = e

    def join(self) -> float:
        """Wait for the runs and check the resume; returns the launcher's
        seconds."""
        self.thread.join()
        self.dry_thread.join()
        self.tmp.cleanup()
        for err in (self.error, self.dry_error):
            if err is not None:
                raise err
        first, second = self.out
        require("resumed" not in first and "resumed from step 5" in second
                and "step    5 loss" in second,
                "the launcher resumed from its step-5 checkpoint")
        return self.seconds


def profile_lm_steps(step, steps: int) -> dict:
    """Trace ``steps`` calls of ``step`` with torch.profiler: wall ms a step
    (profiler on), device busy ms and share, kernels and host operator
    calls a step and the five kernels that take most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    averages = profile_rows(prof)
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print("LM training profile: the profiler recorded no device time")
        return {"wall_ms": wall_ms, "busy_ms": None, "busy_share": None,
                "kernels": None, "operator_calls": None, "top": [], "by_kind_ms": None}
    busy_ms = device_busy_us(prof) / 1e3 / steps
    require(busy_ms <= wall_ms, f"device busy {busy_ms:.3f} ms/step (the union of its "
                                f"intervals) within the wall {wall_ms:.3f} ms/step")
    top = [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3 / steps,
            "count": e.count / steps}
           for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]]
    # device ms a step by kind, from the kernel names: f32 matrix products
    # (cuBLAS/CUTLASS sgemm: the training attention's einsums), the other
    # matrix products (the bf16 projections and head), everything else
    kinds = {"gemm_f32": 0.0, "gemm_other": 0.0, "other": 0.0}
    for e in events:
        name = e.key.lower()
        kind = ("other" if not ("gemm" in name or "nvjet" in name) else
                "gemm_f32" if ("sgemm" in name or "f32f32" in name) else "gemm_other")
        kinds[kind] += e.self_device_time_total / 1e3 / steps
    host = [e for e in averages if e.device_type == DeviceType.CPU]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "kernels": sum(e.count for e in events) / steps,
            "operator_calls": sum(e.count for e in host) / steps, "top": top,
            "by_kind_ms": kinds}


def lm_training_path(dev, smi: str, launcher_s: float) -> dict:
    """Train the full-width dense LM on the card (the launcher ran at the
    start, ``launcher_s`` seconds: ``LauncherRuns``): one step against a
    CPU copy, gradients with no kernel-5 launch,
    the training forward against the serving prefill, timed and profiled
    steps, the compressed-gradient example's step and a lossy checkpoint of
    the trained parameters.  Returns the readings and the codec kernels'
    launches on the path."""
    import dataclasses
    import importlib.util
    import shutil
    from repro_torch.compression import (decode_tree, encode_tree, get_codec,
                                         tree_flatten_with_path, tree_map)
    from repro_torch.configs import get_config
    from repro_torch.core.grad_compress import tree_collective_bytes
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import zfp_codec
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamConfig

    def flat(tree):
        return dict(tree_flatten_with_path(tree)[0])

    res = {"launcher_s": launcher_s}
    launches = dict.fromkeys(zfp_codec.LAUNCHES, 0)
    opt_cfg = AdamConfig(lr=LM_TRAIN_LR, grad_clip=1.0)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_lm_train_")
    try:
        # -- one step on the card against a CPU copy: full width, 2 layers, f32
        cfg2 = dataclasses.replace(get_config(LM_ARCH), num_layers=LM_CPU_LAYERS,
                                   param_dtype="float32")
        p_card = lm.init_lm(torch.Generator(device=dev).manual_seed(1), cfg2)
        p_cpu = tree_map(lambda t: t.cpu(), p_card)
        b_card = launch.make_batch(np.random.default_rng(1), cfg2, 1, LM_CPU_SEQ, dev)
        b_cpu = {k: v.cpu() for k, v in b_card.items()}
        seen = []
        real_adam = launch.apply_adam

        def capture(grads, *args):
            seen.append(grads)
            return real_adam(grads, *args)

        t0 = time.perf_counter()
        with mock.patch.object(launch, "apply_adam", capture):
            new_card, _, l_card = launch.train_step(p_card, launch.adam_init_tree(p_card),
                                                    b_card, cfg2, opt_cfg)
            new_cpu, _, l_cpu = launch.train_step(p_cpu, launch.adam_init_tree(p_cpu),
                                                  b_cpu, cfg2, opt_cfg)
        g_card, g_cpu = flat(seen[0]), flat(seen[1])
        grad_err = max(float((g_card[k].cpu() - g).abs().max()) /
                       max(float(g.abs().max()), 1e-30) for k, g in g_cpu.items())
        diffs = torch.cat([(t.cpu() - flat(new_cpu)[k]).abs().flatten()
                           for k, t in flat(new_card).items()])
        worst, above = float(diffs.max()), int((diffs > LM_CPU_Q99).sum())
        # the criterion counts exactly (p99 < LM_CPU_Q99 iff under 1% of the
        # elements exceed it); the printed p99 is read off every 50th element
        q99 = float(np.quantile(diffs[::50].numpy(), 0.99))
        res["cpu_check"] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
                            "grad_err": grad_err, "param_max": worst, "param_q99": q99,
                            "param_above": above, "param_count": diffs.numel(),
                            "seconds": time.perf_counter() - t0}
        print(f"LM card vs CPU, one train_step at full width, {LM_CPU_LAYERS} layers, f32, "
              f"1 x {LM_CPU_SEQ}: {res['cpu_check']}", flush=True)
        require(abs(float(l_card) - float(l_cpu)) <= LM_CPU_LOSS_RTOL * abs(float(l_cpu)),
                f"LM loss on the card {float(l_card):.7f} == CPU {float(l_cpu):.7f} "
                f"(rtol {LM_CPU_LOSS_RTOL})")
        require(grad_err <= LM_CPU_GRAD_RTOL, f"every LM gradient on the card == CPU "
                                              f"(worst {grad_err:.2e} of its tensor's max "
                                              f"<= {LM_CPU_GRAD_RTOL})")
        require(above < 0.01 * diffs.numel() and worst <= 2 * LM_TRAIN_LR,
                f"updated LM parameters on the card == CPU: p99 |d| {q99:.2e} < "
                f"{LM_CPU_Q99}, max {worst:.2e} <= 2 lr, {above} of {diffs.numel()} "
                f"elements above {LM_CPU_Q99}")
        del p_card, p_cpu, new_card, new_cpu, seen, g_card, g_cpu, diffs
        torch.cuda.empty_cache()

        # -- the full-width model: every parameter gets a gradient on the card
        cfg = get_config(LM_ARCH)
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        fa.reset_launches()
        loss, grads = launch.loss_and_grads(
            params, cfg, launch.make_batch(rng, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev))
        torch.cuda.synchronize()
        g = flat(grads)
        require(all(bool(torch.isfinite(t).all()) for t in g.values())
                and bool(torch.isfinite(loss)),
                f"every one of {len(g)} LM gradients is finite on the card "
                f"(loss {float(loss):.4f})")
        nonzero = {w: float(g[f"layers/{w}"].float().abs().max())
                   for w in ("wq", "wk", "wv", "wo")}
        require(all(v > 0 for v in nonzero.values()),
                f"wq/wk/wv/wo have nonzero gradients on the card (max |g| {nonzero})")
        require(fa.LAUNCHES["flash_attention"] == 0,
                "no flash_attention launch in the training forward and backward")
        del grads, g

        # -- the training forward against the serving prefill (kernel 5)
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, LM_FWD_PROMPT)).astype(np.int32)).to(dev)
        with torch.no_grad():
            hidden, _ = lm.lm_forward(params, cfg, {"tokens": toks})
            n_fwd = fa.LAUNCHES["flash_attention"]
            train_logits = (hidden[:, -1] @ lm._head_weight(params, cfg)).float()
            del hidden
            before = dict(fa.VARIANT_LAUNCHES)
            serve_logits, cache = lm.lm_prefill(params, cfg, {"tokens": toks},
                                                LM_FWD_PROMPT)
            del cache
        n_prefill = fa.LAUNCHES["flash_attention"] - n_fwd
        wgmma = fa.VARIANT_LAUNCHES["prefill_wgmma"] - before["prefill_wgmma"]
        fwd_err = float((train_logits - serve_logits).abs().max())
        res["forward_vs_prefill"] = {"max_abs_diff": fwd_err, "kernel5_launches": n_prefill,
                                     "argmax_equal": bool((train_logits.argmax(-1) ==
                                                           serve_logits.argmax(-1)).all())}
        require(n_fwd == 0 and n_prefill == wgmma == cfg.num_layers,
                f"lm_forward launched no kernel 5, lm_prefill {n_prefill} "
                f"({wgmma} prefill_wgmma, one a layer)")
        require(fwd_err <= LOGIT_ATOL, f"lm_forward's last-token logits == lm_prefill's "
                                       f"(kernel 5) on {LM_FWD_PROMPT} tokens: max abs diff "
                                       f"{fwd_err:.4f} <= {LOGIT_ATOL}")

        # -- LM_TRAIN_STEPS steps of train_step, fresh tokens each step
        opt = launch.adam_init_tree(params)
        fa.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for _ in range(LM_TRAIN_STEPS):
            batch = launch.make_batch(rng, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss = launch.train_step(params, opt, batch, cfg, opt_cfg)
            losses.append(float(loss))
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        require(fa.LAUNCHES["flash_attention"] == 0,
                f"no flash_attention launch in {LM_TRAIN_STEPS} training steps")
        require(all(np.isfinite(losses)), f"{LM_TRAIN_STEPS} finite LM losses")
        require({t.dtype for t in flat(opt.m).values()} == {torch.float32}
                and {t.dtype for t in flat(params).values()} == {torch.bfloat16},
                "Adam's m and v are f32 after the first step, the parameters bf16")
        med = statistics.median(step_s)
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        shapes = lm._layer_param_shapes(cfg)
        n_mm = (sum(int(np.prod(shapes[w])) for w in
                    ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")) * cfg.num_layers
                + cfg.d_model * cfg.vocab_size)
        mm_flops = 6 * n_mm * tokens
        attn_fwd = 4 * LM_TRAIN_BATCH * cfg.num_heads * LM_TRAIN_SEQ ** 2 * cfg.hdim \
            * cfg.num_layers
        res["train"] = {"losses": losses, "step_s": step_s, "median_s": med,
                        "tokens_per_s": tokens / med, "max_memory_allocated": peak,
                        "matmul_params": n_mm, "matmul_flops": mm_flops,
                        "attention_flops": 3 * attn_fwd, "attention_remat_flops": attn_fwd,
                        "share_matmul": mm_flops / (med * BF16_TENSOR_FLOPS),
                        "share_with_attention": (mm_flops + 3 * attn_fwd)
                        / (med * BF16_TENSOR_FLOPS)}
        print(f"LM training: {LM_TRAIN_STEPS} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step median {med:.4f} s "
              f"(first {step_s[0]:.4f} s), {tokens / med:.1f} tokens/s; peak "
              f"{peak / 1e9:.2f} GB; 6NT {mm_flops:.3e} + attention f32 {3 * attn_fwd:.3e} "
              f"(+ remat {attn_fwd:.3e}) FLOP: {100 * res['train']['share_matmul']:.2f}% "
              f"({100 * res['train']['share_with_attention']:.2f}% with attention) of "
              f"989 TFLOP/s; {smi}", flush=True)
        prof_rng = np.random.default_rng(100)

        def one_step():
            nonlocal params, opt
            params, opt, loss = launch.train_step(
                params, opt, launch.make_batch(prof_rng, cfg, LM_TRAIN_BATCH,
                                               LM_TRAIN_SEQ, dev), cfg, opt_cfg)
            float(loss)

        res["profile"] = profile_lm_steps(one_step, LM_TRAIN_PROFILE)
        print(f"LM training profile over {LM_TRAIN_PROFILE} steps: {res['profile']}",
              flush=True)

        # -- the compressed-gradient example's step at full width
        spec = importlib.util.spec_from_file_location(
            "lm_pretrain_torch", ROOT / "examples" / "lm_pretrain_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        comp_step = example.make_step(cfg, opt_cfg, LM_GRAD_BITS)
        residual = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        # step 0's ghat + r against gf, leaf by leaf: the step writes a leaf's
        # r right after its compress_decompress, so each call settles the
        # previous leaf (one gf kept at a time; a tree of them is 7.6 GB)
        r_leaves = list(flat(residual).values())
        pending, calls = [], [0]
        ef = {"equal_to_gf": 0, "elements": 0, "bound_ok": True}
        real_cd = example.compress_decompress

        def settle():
            while pending:
                gf, gh, r = pending.pop()
                ef["equal_to_gf"] += int(torch.eq(gh + r, gf).sum())
                ef["elements"] += gf.numel()
                ef["bound_ok"] &= bool(torch.equal(r, gf - gh))
                err = (gh.double() + r.double() - gf.double()).abs()
                ef["bound_ok"] &= bool((err <= 2.0 ** -24 * (gf.double() - gh.double())
                                        .abs()).all())

        def check_ef(gf, bits):
            settle()
            gh = real_cd(gf, bits)
            pending.append((gf, gh, r_leaves[calls[0]]))
            calls[0] += 1
            return gh

        comp_s, comp_launches, comp_losses = [], [], []
        for i in range(LM_COMP_STEPS):
            batch = launch.make_batch(rng, cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with mock.patch.object(example, "compress_decompress",
                                   check_ef if i == 0 else real_cd):
                (params, opt, residual, loss, ghat), got = count_launches(
                    launches, lambda: comp_step(params, opt, residual, batch))
            comp_losses.append(float(loss))
            comp_s.append(time.perf_counter() - t0)
            comp_launches.append(got)
            if i == 0:
                settle()
                res["ghat_plus_r"] = {k: ef[k] for k in ("equal_to_gf", "elements")}
                print(f"compressed step 0: ghat + r == gf bit for bit at "
                      f"{ef['equal_to_gf']} of {ef['elements']} elements", flush=True)
                require(ef["elements"] == sum(t.numel() for t in r_leaves),
                        "every gradient leaf went through the codec in step 0")
                require(ef["bound_ok"], "r == gf - ghat in f32 on every leaf, and ghat + r "
                                        "recovers gf within that subtraction's rounding")
        require(all(c["zfp_encode_blocks"] > 0 and c["zfp_decode_blocks_fa"] > 0
                    for c in comp_launches),
                f"kernels 4 and 1 launched in every compressed step ({comp_launches})")
        raw, wire = tree_collective_bytes(ghat, LM_GRAD_BITS)
        res["compressed"] = {"step_s": comp_s, "median_s": statistics.median(comp_s),
                             "uncompressed_median_s": med, "losses": comp_losses,
                             "launches_per_step": comp_launches, "raw_bytes": raw,
                             "wire_bytes": wire, "wire_ratio": raw / wire}
        print(f"LM compressed step ({LM_GRAD_BITS} bits): median "
              f"{res['compressed']['median_s']:.4f} s against {med:.4f} s uncompressed; "
              f"launches a step {comp_launches}; wire {raw} -> {wire} bytes "
              f"({raw / wire:.4f}x); {smi}", flush=True)
        require(all(np.isfinite(comp_losses)), "finite compressed-step losses")
        del opt, residual, ghat, r_leaves
        torch.cuda.empty_cache()

        # -- a lossy fixed-rate checkpoint of the trained parameters
        params_ck, depth = params, cfg.num_layers
        free = shutil.disk_usage(tmp.name).free
        need = 2 * 1.9 * sum(t.numel() for t in flat(params).values())
        if free < need:                  # cut the depth, never the width
            depth = max(1, int(cfg.num_layers * free / need))
            params_ck = {**params, "layers": {k: v[:depth] for k, v in
                                              params["layers"].items()}}
            print(f"checkpoint: {free / 1e9:.1f} GB free, cut to {depth} layers")
        ck = os.path.join(tmp.name, "fr14")
        t0 = time.perf_counter()
        path, _ = count_launches(launches, lambda: ckpt.save_checkpoint(
            ck, LM_TRAIN_STEPS, {"params": params_ck}, lossy_bits=LM_LOSSY_BITS))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        (state, meta), _ = count_launches(launches, lambda: ckpt.restore_checkpoint(
            path, {"params": params_ck}))
        restore_s = time.perf_counter() - t0
        codec = get_codec("fixed_rate", bits_per_value=LM_LOSSY_BITS)
        enc, tmeta = encode_tree(codec, {"params": params_ck}, min_size=ckpt.MIN_LOSSY_SIZE)
        want = decode_tree(enc, tmeta, codec=codec)
        del enc
        got = list(flat(state).values())
        orig = list(flat({"params": params_ck}).values())
        require(len(got) == len(want) == len(orig) and all(
            a.shape == o.shape and a.dtype == o.dtype and torch.equal(a, w)
            for a, w, o in zip(got, want, orig)),
            f"the FR-{LM_LOSSY_BITS} checkpoint restores every leaf's shape and dtype, "
            f"equal to decode_tree(encode_tree(leaf)) on the card bit for bit")
        res["checkpoint"] = {"layers": depth, "raw_bytes": meta["raw_bytes"],
                             "stored_bytes": meta["stored_bytes"],
                             "stored_over_raw": meta["stored_bytes"] / meta["raw_bytes"],
                             "save_s": save_s, "restore_s": restore_s}
        print(f"LM FR-{LM_LOSSY_BITS} checkpoint ({depth} layers): {res['checkpoint']}",
              flush=True)
        del state, want, got, params, params_ck
        torch.cuda.empty_cache()
    finally:
        tmp.cleanup()
    res["launches"] = launches
    print(json.dumps({"lm_training": res}), flush=True)
    return res


def window_keys(q_pos: np.ndarray, window) -> int:
    """Keys a causal (windowed) query at each position attends: sum of
    min(pos + 1, window)."""
    q_pos = np.asarray(q_pos, np.int64)
    return int(np.minimum(q_pos + 1, window or np.iinfo(np.int64).max).sum())


def group_attention_checks(dev, cfg, prefills, kv_lens, max_seq: int, windows, seed: int,
                           what: str, causal: bool = True) -> float:
    """Kernel 5 against its plain version at a model's shapes (its q heads
    over its KV heads, its head dim; bf16): prefills of the given (batch,
    length) or (batch, queries, keys) and decode, bf16 q against the f32
    cache of ``max_seq`` positions, one row per ``kv_lens`` entry (None:
    LM_SLOTS rows over every position, no ``kv_lens``), each with every
    window of ``windows``; ``causal`` or not.  Returns the largest error."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    bf = torch.bfloat16
    mode = "causal" if causal else "non-causal"

    def rn(shape, dt=bf):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    worst = 0.0
    for pf in prefills:
        b, sq, sk = pf if len(pf) == 3 else (pf[0], pf[1], pf[1])
        q, k, v = rn((b, h, sq, d)), rn((b, hkv, sk, d)), rn((b, hkv, sk, d))
        for window in windows:
            worst = max(worst, check_attention(
                f"{what} {mode} prefill {b}x{h}x{sq}x{d} over {sk} keys x {hkv} KV heads, "
                f"window {window}", q, k, v, "prefill_wgmma", causal=causal, window=window))
    n = LM_SLOTS if kv_lens is None else len(kv_lens)
    ck, cv = rn((n, max_seq, hkv, d), torch.float32), rn((n, max_seq, hkv, d), torch.float32)
    lens = None if kv_lens is None else torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = rn((n, h, 1, d))
    for window in windows:
        worst = max(worst, check_attention(
            f"{what} {mode} decode bf16 q ({n},{h},1,{d}) against the f32 cache of "
            f"{max_seq} positions, window {window}, kv_lens "
            f"{'none' if kv_lens is None else list(kv_lens)}", q, ck.transpose(1, 2),
            cv.transpose(1, 2), "decode_splitkv", kv_lens=lens, window=window, causal=causal))
    return worst


def group_attention_timings(dev, cfg, s: int, max_seq: int, lens_np, smi: str,
                            window, seed: int, what: str, causal: bool = True) -> dict:
    """Kernel 5's times at a model's serving shapes: the prefill of ``s``
    tokens and the decode step of LM_SLOTS slots at the given depths
    (``lens_np``; None: no ``kv_lens``, every one of the cache's
    ``max_seq`` positions) against the f32 cache, with ``window`` (None:
    none), ``causal`` or not; beside the plain version, each SDPA backend (a
    window or the depths as a mask) and the bound, which counts only the
    keys each query attends."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    h, hkv, d, w = cfg.num_heads, cfg.num_kv_heads, cfg.hdim, window
    bf = torch.bfloat16
    out = {}
    q = torch.randn((1, h, s, d), generator=g, device=dev).to(bf)
    k = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf)
    v = torch.randn((1, hkv, s, d), generator=g, device=dev).to(bf)
    pos = torch.arange(s, device=dev)
    mask = None if w is None else (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - w)
    kw = {"window": w, "causal": causal}
    t = {"variant": fa.select_variant(q, k, v, None, w), "window": w, "causal": causal,
         "shape": [1, h, s, d]}
    t["ms"] = graph_ms(lambda: fa.flash_attention(q, k, v, **kw), 50)
    t["eager_ms"] = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=50)
    t["plain_ms"] = graph_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 5)
    t["sdpa"] = sdpa_times(q, k, v, reps=20, mask=mask, causal=causal)
    t["library_ms"], t["library_backend"] = fastest(t["sdpa"])
    keys = window_keys(np.arange(s), w) if causal else s * s
    t["bound_ms"], t["bound_by"] = attn_bound_ms(
        2 * (2 * h * s * d) + 2 * (2 * hkv * s * d), 4 * h * d * keys)
    out["prefill"] = t
    lens = None if lens_np is None else torch.from_numpy(lens_np).to(dev)
    q = torch.randn((LM_SLOTS, h, 1, d), generator=g, device=dev).to(bf)
    ck = torch.randn((LM_SLOTS, max_seq, hkv, d), generator=g, device=dev)
    cv = torch.randn((LM_SLOTS, max_seq, hkv, d), generator=g, device=dev)
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    dmask = None
    if lens is not None:
        kpos = torch.arange(max_seq, device=dev)[None]
        dmask = kpos < lens[:, None]
        if w is not None:
            dmask = dmask & (kpos >= lens[:, None] - w)
        dmask = dmask[:, None, None]
    t = {"variant": fa.select_variant(q, kt, vt, lens, w), "window": w, "causal": causal,
         "shape": [LM_SLOTS, h, 1, d],
         "kv_lens": None if lens_np is None else lens_np.tolist()}
    kw = {"kv_lens": lens, "window": w, "causal": causal}
    t["ms"] = graph_ms(lambda: fa.flash_attention(q, kt, vt, **kw), 100)
    t["eager_ms"] = cuda_ms(lambda: fa.flash_attention(q, kt, vt, **kw), reps=100)
    t["plain_ms"] = graph_ms(lambda: ref.flash_attention_ref(q, kt, vt, **kw), 20)
    t["sdpa"] = sdpa_times(q, kt.to(bf).contiguous(), vt.to(bf).contiguous(), reps=100,
                           mask=dmask, causal=causal)
    t["library_ms"], t["library_backend"] = fastest(t["sdpa"])
    # the kernel's own function: bf16 q upcast to f32 against the f32 cache
    t["sdpa_same"] = sdpa_times(q, kt, vt, reps=100, mask=dmask, q_dtype=torch.float32,
                                causal=causal)
    t["same_library_ms"], t["same_library_backend"] = fastest(t["sdpa_same"])
    keys = (LM_SLOTS * max_seq if lens_np is None else
            window_keys(lens_np - 1, w) if causal else int(lens_np.sum()))
    t["bound_ms"], t["bound_by"] = attn_bound_ms(keys * hkv * d * 2 * 4 + 2 * (
        2 * LM_SLOTS * h * d) + (0 if lens_np is None else 4 * LM_SLOTS), 4 * h * d * keys)
    out["decode"] = t

    def f(x):
        return "not measured" if x is None else f"{x:.4f}"

    for name, t in out.items():
        print(f"flash_attention {what} {'causal' if causal else 'non-causal'} {name} "
              f"{t['shape']} over {hkv} KV heads, window {w} "
              f"(ms per call on the device; eager in brackets): {t['variant']} {f(t['ms'])} "
              f"({f(t.get('eager_ms'))}), plain {f(t['plain_ms'])}, bound "
              f"{t['bound_ms']:.5f} ({t['bound_by']}); SDPA"
              f"{'' if w is None else ' with the window as a mask'}"
              f"{' on a bf16 copy of the cache' if name == 'decode' else ''}: "
              + ", ".join(f"{n} refused" if x is None else f"{n} {f(x['ms'])}"
                          for n, x in t["sdpa"].items())
              + ("" if "sdpa_same" not in t else
                 "; SDPA on the same function (q upcast to f32, the f32 cache): "
                 + ", ".join(f"{n} refused" if x is None else f"{n} {f(x['ms'])}"
                             for n, x in t["sdpa_same"].items()))
              + f"; {smi}", flush=True)
    return out


def recurrent_family(dev, name: str, smi: str, launches: dict) -> dict:
    """One family of the SSM and hybrid path at full width (see REC_ARCHS):
    serve, solo against batched, forward against prefill, a decode step's
    profile, training, and card against CPU.  Adds the codec kernels'
    launches to ``launches``; returns the readings."""
    import dataclasses
    import importlib.util
    from repro_torch.compression import (decode_tree, encode_tree, get_codec,
                                         tree_flatten_with_path, tree_map)
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.loadgen import lm_workload
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamConfig

    def flat(tree):
        return dict(tree_flatten_with_path(tree)[0])

    cfg = get_config(name)
    res = {"attention": {"launches": 0, "variants": dict.fromkeys(fa.VARIANTS, 0)}}
    if cfg.hybrid:
        # group 5, D 64: the longest and the shortest prompts' prefills and
        # decode rows whose kv_lens cross the window, with it and without
        res["attention"]["max_abs_err"] = group_attention_checks(
            dev, cfg, ((1, REC_PROMPTS[name][-1]), (2, REC_PROMPTS[name][0])),
            HYBRID_KV_LENS, REC_MAX_SEQ[name], (cfg.attn_window, None), 3, "hybrid")
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    leaves = flat(params)
    n_params = sum(t.numel() for t in leaves.values())
    print(f"lm: {name} at full width ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.ssm_heads} SSM heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv}"
          + (f", {cfg.num_heads} q heads over {cfg.num_kv_heads} KV heads x {cfg.hdim}, ff "
             f"{cfg.d_ff}, window {cfg.attn_window}, global layers {cfg.global_attn_layers}"
             if cfg.hybrid else "")
          + f", vocab {cfg.vocab_size}), {n_params} parameters "
          f"({sum(t.numel() * t.element_size() for t in leaves.values())} bytes), init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    require(n_params == lm.param_count(cfg) == REC_PARAMS[name],
            f"{name}: parameter count == param_count == {REC_PARAMS[name]} ({n_params})")
    require({t.dtype for k, t in leaves.items() if k.split("/")[-1] in
             ("ssm_A", "ssm_D", "ssm_dt_bias")} == {torch.float32},
            f"{name}: ssm_A, ssm_D and ssm_dt_bias are f32 in the bf16 parameters")

    # -- serve: continuous batching and lockstep
    max_seq = REC_MAX_SEQ[name]
    engine = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_seq=max_seq, device=dev)
    engine.run(lm_workload(cfg.vocab_size, 2, prompt_lens=(8,), new_tokens=(2,), seed=1))
    torch.cuda.synchronize()
    n_run, n_lock = REC_REQUESTS[name]
    runs = {**serve_modes(engine, cfg, REC_PROMPTS[name], LM_NEW, n_requests=n_run,
                          modes=("run",)),
            **serve_modes(engine, cfg, REC_PROMPTS[name], LM_NEW, n_requests=n_lock,
                          modes=("run_lockstep",))}
    for mode, (_, c, _) in runs.items():
        v = c["variants"]
        if cfg.hybrid:
            require(0 < c["prefill"] == v["prefill"]["prefill_wgmma"]
                    and 0 < c["decode"] == v["decode"]["decode_splitkv"]
                    and v["prefill"]["scalar"] == v["decode"]["scalar"] == 0,
                    f"{name} {mode}: every prefill launch ran prefill_wgmma and every "
                    f"decode launch decode_splitkv, none the scalar variant ({v})")
        else:
            require(c["prefill"] == c["decode"] == 0, f"{name} {mode}: no kernel-5 launch")
        res["attention"]["launches"] += c["prefill"] + c["decode"]
        for ph in v:
            for k, n in v[ph].items():
                res["attention"]["variants"][k] += n
    res["serve"] = {mode: {**c["stats"], "prefill_launches": c["prefill"],
                           "decode_launches": c["decode"]}
                    for mode, (_, c, _) in runs.items()}
    served = runs["run"][0]
    by_mode = [np.concatenate([r.output for r in runs[m][0][:n_lock]]) for m in runs]
    res["run_vs_lockstep_equal"] = float(np.mean(by_mode[0] == by_mode[1]))
    print(f"{name} run vs run_lockstep: {res['run_vs_lockstep_equal']:.4f} of "
          f"{by_mode[0].size} greedy tokens equal", flush=True)

    # -- requests served alone against the batch.  In f32 (the weights cast
    # up) the teacher-forced logits of a request alone and in its padded
    # batch of LM_SLOTS must agree to SOLO_F32_ATOL: pads and neighbours do
    # not reach a row.  In bf16 they differ by rounding in other batch
    # shapes, amplified through the layers, and a random model's greedy
    # choice often comes down to a near tie: served alone, a request's
    # tokens must equal the batch's up to the first step where they part,
    # and there the two tokens' bf16 logits alone must lie within twice the
    # largest bf16 teacher-forced difference (a tie).
    alone = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_seq=max_seq, device=dev)
    chunk = served[:LM_SLOTS]
    batch_tf = _replay(lm, params, cfg, chunk, dev, max_seq)[0][0]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = tree_map(torch.Tensor.float, params)
    batch_tf32 = _replay(lm, p32, cfg32, chunk, dev, max_seq)[0][0]
    res["solo"] = []
    for row, r in enumerate(served[:REC_SOLO]):
        out = alone.run([Request(prompt=r.prompt.copy(),
                                 max_new_tokens=r.max_new_tokens)])[0].output
        n = len(r.output)
        solo_tf = _replay(lm, params, cfg, [r], dev, max_seq)[0][0]
        diff = float((solo_tf[:n, 0] - batch_tf[:n, row]).abs().max())
        diff32 = float((_replay(lm, p32, cfg32, [r], dev, max_seq)[0][0][:n, 0]
                        - batch_tf32[:n, row]).abs().max())
        part = next((t for t in range(n) if out[t] != r.output[t]), n)
        gap = 0.0 if part == n else float(
            (solo_tf[part, 0, int(out[part])] - solo_tf[part, 0, int(r.output[part])]).abs())
        res["solo"].append({"prompt": len(r.prompt), "tokens": n,
                            "equal": int(np.sum(out == r.output)), "first_difference": part,
                            "tie_gap": gap, "teacher_forced_max_abs_diff": diff,
                            "teacher_forced_max_abs_diff_f32": diff32})
        print(f"{name} request {row} ({len(r.prompt)} prompt tokens) alone against the "
              f"batch: {res['solo'][-1]}", flush=True)
        require(diff32 <= SOLO_F32_ATOL,
                f"{name}: request {row} alone == in its padded batch, teacher-forced f32 "
                f"logits: max abs diff {diff32:.2e} <= {SOLO_F32_ATOL}")
        upto = ("the end" if part == n else
                f"a tie ({gap:.4f} <= 2 x {diff:.4f}, the bf16 teacher-forced difference)")
        require(gap <= 2 * diff, f"{name}: request {row} served alone gives the batch's "
                                 f"tokens ({part} of {n}) up to {upto}")
    del alone, batch_tf, batch_tf32, p32

    # -- lm_prefill's last-token logits against lm_forward's
    fa.reset_launches()
    plen = REC_FWD_PROMPT[name]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, plen)).astype(np.int32)).to(dev)
    with torch.no_grad():
        hidden, _ = lm.lm_forward(params, cfg, {"tokens": toks})
        n_fwd = fa.LAUNCHES["flash_attention"]
        train_logits = (hidden[:, -1] @ lm._head_weight(params, cfg)).float()
        del hidden
        serve_logits, cache = lm.lm_prefill(params, cfg, {"tokens": toks}, plen)
        del cache
    n_prefill = fa.LAUNCHES["flash_attention"] - n_fwd
    err = float((train_logits - serve_logits).abs().max())
    res["forward_vs_prefill"] = {"tokens": plen, "max_abs_diff": err,
                                 "kernel5_launches": n_prefill,
                                 "argmax_equal": bool((train_logits.argmax(-1) ==
                                                       serve_logits.argmax(-1)).all())}
    require(n_fwd == 0 and n_prefill == (cfg.num_layers if cfg.hybrid else 0)
            == fa.VARIANT_LAUNCHES["prefill_wgmma"],
            f"{name}: lm_forward launched no kernel 5, lm_prefill {n_prefill} (prefill_wgmma, "
            f"one an attention layer)")
    require(err <= LOGIT_ATOL, f"{name}: lm_forward's last-token logits == lm_prefill's on "
                               f"{plen} tokens: max abs diff {err:.4f} <= {LOGIT_ATOL}")

    # -- a decode step's wall, busy share and kernels, at the first chunk's depths
    chunk = served[:LM_SLOTS]
    plen = max(len(r.prompt) for r in chunk)
    ptoks = np.zeros((LM_SLOTS, plen), np.int32)
    for j, r in enumerate(chunk):
        ptoks[j, :len(r.prompt)] = r.prompt
    lens_np = np.array([len(r.prompt) for r in chunk], np.int32)
    logits, cache = engine._prefill(ptoks, lens_np)
    cur = logits.argmax(-1).to(torch.int32)
    depth = torch.from_numpy(lens_np).to(dev)

    def decode_step():
        out, _ = lm.serve_step(params, cfg, cache, cur, depth)
        torch.argmax(out, -1).cpu()

    for _ in range(2):
        decode_step()
    res["decode_profile"] = profile_lm_steps(decode_step, REC_PROFILE_STEPS)
    print(f"{name} decode step profile ({LM_SLOTS} slots at depths {lens_np.tolist()}): "
          f"{res['decode_profile']}; {smi}", flush=True)
    del cache, engine
    if cfg.hybrid:
        depths = runs["run"][2]
        res["attention"]["timings"] = group_attention_timings(
            dev, cfg, REC_PROMPTS[name][-1], max_seq, depths[len(depths) // 2] + 1, smi,
            cfg.attn_window, 4, "hybrid")
    torch.cuda.empty_cache()

    # -- training at full width
    batch_n, seq, steps = REC_TRAIN[name]
    opt_cfg = AdamConfig(lr=LM_TRAIN_LR, grad_clip=1.0)
    rng = np.random.default_rng(0)
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = launch.loss_and_grads(params, cfg, launch.make_batch(rng, cfg, batch_n,
                                                                       seq, dev))
    g = flat(grads)
    require(all(bool(torch.isfinite(t).all()) for t in g.values())
            and bool(torch.isfinite(loss)),
            f"{name}: every one of {len(g)} gradients is finite on the card "
            f"(loss {float(loss):.4f})")
    moved = [k for k in ("ssm_in", "ssm_conv_w", "ssm_A", "ssm_D", "ssm_dt_bias", "ssm_norm",
                         "ssm_out") + (("wq", "wk", "wv", "wo") if cfg.hybrid else ())
             if float(g[f"layers/{k}"].float().abs().max()) > 0]
    require(len(moved) == (11 if cfg.hybrid else 7),
            f"{name}: the SSM{' and attention' if cfg.hybrid else ''} leaves have nonzero "
            f"gradients ({moved})")
    del grads, g
    opt = launch.adam_init_tree(params)
    losses, step_s = [], []
    for _ in range(steps):
        batch = launch.make_batch(rng, cfg, batch_n, seq, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = launch.train_step(params, opt, batch, cfg, opt_cfg)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(fa.LAUNCHES["flash_attention"] == 0, f"{name}: no kernel-5 launch in training")
    require(all(np.isfinite(losses)), f"{name}: {steps} finite losses")
    med = statistics.median(step_s[1:] or step_s)
    res["train"] = {"batch": batch_n, "seq": seq, "losses": losses, "step_s": step_s,
                    "median_s": med, "tokens_per_s": batch_n * seq / med,
                    "max_memory_allocated": peak}
    print(f"{name} training: {steps} steps of {batch_n} x {seq}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; step median {med:.4f} s (first {step_s[0]:.4f} s), "
          f"{batch_n * seq / med:.1f} tokens/s; peak {peak / 1e9:.2f} GB; {smi}", flush=True)

    if not cfg.hybrid:
        # -- the compressed-gradient example's step and a lossy checkpoint
        spec = importlib.util.spec_from_file_location(
            "lm_pretrain_torch", ROOT / "examples" / "lm_pretrain_torch.py")
        example = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(example)
        comp_step = example.make_step(cfg, opt_cfg, LM_GRAD_BITS)
        residual = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        n_leaves, comp_s, comp_launches, comp_losses = len(flat(params)), [], [], []
        for _ in range(REC_COMP_STEPS):
            batch = launch.make_batch(rng, cfg, batch_n, seq, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (params, opt, residual, loss, _), got = count_launches(
                launches, lambda: comp_step(params, opt, residual, batch))
            comp_losses.append(float(loss))
            comp_s.append(time.perf_counter() - t0)
            comp_launches.append(got)
        require(all(c["zfp_encode_blocks"] == c["zfp_decode_blocks_fa"] == n_leaves
                    for c in comp_launches) and all(np.isfinite(comp_losses)),
                f"{name}: kernels 4 and 1 launched once a leaf ({n_leaves}) in every "
                f"compressed step, finite losses ({comp_launches})")
        res["compressed"] = {"step_s": comp_s, "median_s": statistics.median(comp_s),
                             "losses": comp_losses, "launches_per_step": comp_launches}
        print(f"{name} compressed step ({LM_GRAD_BITS} bits): median "
              f"{res['compressed']['median_s']:.4f} s; launches a step {comp_launches[-1]}",
              flush=True)
        del residual
        tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_rec_")
        try:
            path, _ = count_launches(launches, lambda: ckpt.save_checkpoint(
                tmp.name, steps, {"params": params}, lossy_bits=LM_LOSSY_BITS))
            (state, meta), _ = count_launches(launches, lambda: ckpt.restore_checkpoint(
                path, {"params": params}))
        finally:
            tmp.cleanup()
        codec = get_codec("fixed_rate", bits_per_value=LM_LOSSY_BITS)
        enc, tmeta = encode_tree(codec, {"params": params}, min_size=ckpt.MIN_LOSSY_SIZE)
        want = decode_tree(enc, tmeta, codec=codec)
        got = list(flat(state).values())
        orig = list(flat({"params": params}).values())
        require(len(got) == len(want) == len(orig) and all(
            a.shape == o.shape and a.dtype == o.dtype and torch.equal(a, w)
            for a, w, o in zip(got, want, orig)),
            f"{name}: the FR-{LM_LOSSY_BITS} checkpoint restores every leaf, equal to "
            f"decode_tree(encode_tree(leaf)) bit for bit")
        res["checkpoint"] = {"raw_bytes": meta["raw_bytes"],
                             "stored_bytes": meta["stored_bytes"]}
        del state, want, got, enc
    del params, opt
    torch.cuda.empty_cache()

    # -- card against CPU: one loss and its gradients, 2 layers, f32
    cfg2 = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS, param_dtype="float32")
    p_card = lm.init_lm(torch.Generator(device=dev).manual_seed(1), cfg2)
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    b_card = launch.make_batch(np.random.default_rng(1), cfg2, 1, LM_CPU_SEQ, dev)
    l_card, g_card = launch.loss_and_grads(p_card, cfg2, b_card)
    l_cpu, g_cpu = launch.loss_and_grads(p_cpu, cfg2, {k: v.cpu() for k, v in b_card.items()})
    g_card, g_cpu = flat(g_card), flat(g_cpu)
    grad_err = max(float((g_card[k].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                   for k, g in g_cpu.items())
    res["cpu_check"] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
                        "grad_err": grad_err}
    print(f"{name} card vs CPU, loss and gradients at full width, {LM_CPU_LAYERS} layers, "
          f"f32, 1 x {LM_CPU_SEQ}: {res['cpu_check']}", flush=True)
    require(abs(float(l_card) - float(l_cpu)) <= LM_CPU_LOSS_RTOL * abs(float(l_cpu)),
            f"{name}: loss on the card {float(l_card):.7f} == CPU {float(l_cpu):.7f} "
            f"(rtol {LM_CPU_LOSS_RTOL})")
    require(grad_err <= LM_CPU_GRAD_RTOL, f"{name}: every gradient on the card == CPU "
                                          f"(worst {grad_err:.2e} of its tensor's max <= "
                                          f"{LM_CPU_GRAD_RTOL})")
    del p_card, p_cpu, g_card, g_cpu
    torch.cuda.empty_cache()
    return res


def recurrent_lm_path(dev, smi: str) -> dict:
    """The SSM and hybrid families at full width, one after the other
    (:func:`recurrent_family`); returns their readings, the codec kernels'
    launches and kernel 5's on the path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import zfp_codec
    res = {"launches": dict.fromkeys(zfp_codec.LAUNCHES, 0),
           "attention": {"launches": 0, "variants": dict.fromkeys(fa.VARIANTS, 0)}}
    for name in REC_ARCHS:
        t0 = time.perf_counter()
        r = recurrent_family(dev, name, smi, res["launches"])
        r["seconds"] = time.perf_counter() - t0
        res[name] = r
        res["attention"]["launches"] += r["attention"]["launches"]
        for k, n in r["attention"]["variants"].items():
            res["attention"]["variants"][k] += n
    print(json.dumps({"recurrent_lm": res}, default=str), flush=True)
    return res


def sharded_lm_path(dev, smi: str) -> dict:
    """The multi-device launch path on one card: ``internlm2-1.8b`` at full
    width with ``SHARD_LAYERS`` layers in bf16, parameters and batches as
    DTensors on a one-rank NCCL ``make_host_mesh()``.

    * the dry run's ``make_train_step`` against the plain ``train_step``:
      loss, every gradient (``loss_and_grads``, bit for bit; the control,
      the sharded gradients of a batch with one label changed, must not
      be) and the updated parameters (bit for bit), the readings printed;
      both timed;
    * ``lm_prefill`` and ``SHARD_DECODE`` ``serve_step`` calls on the mesh
      (kernel 5 under ``local_map``: ``prefill_wgmma`` and
      ``decode_splitkv`` must run) against the plain ones, logits to
      ``LOGIT_ATOL``;
    * the pod-compressed step on a one-pod (1, 1, 1) mesh at
      ``SHARD_BITS`` bits: its exchanged gradients equal
      ``compress_decompress`` of each leaf bit for bit (the fixed-rate tree
      codec: kernel 4 encodes, kernel 1 decodes the stacked payloads), and
      the step's loss and parameters are finite.

    Before it, :func:`partial_attention_checks` holds kernel 5's partial
    entry (which a one-rank mesh never reaches) against its plain version.
    Every launch count is set to 0 before the phase and read after it."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.compression import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.core.grad_compress import as_codec, compress_decompress
    from repro_torch.distributed.sharding import (batch_specs, distribute_tree,
                                                  gather_tree, opt_specs, param_specs)
    from repro_torch.kernels import flash_attention, zfp_codec
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamConfig

    def flat(tree):
        return dict(tree_flatten_with_path(tree)[0])

    def ulps(got, want):
        return {k: bf16_ulps(got[k], w) if float(w.float().abs().max()) else
                float(got[k].float().abs().max()) for k, w in want.items()}

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=SHARD_LAYERS,
                              param_dtype="bfloat16")
    res = {"partial": partial_attention_checks(dev, cfg, smi)}
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(7), cfg)
    b, s = SHARD_TRAIN
    batch = launch.make_batch(np.random.default_rng(7), cfg, b, s, dev)
    opt_cfg = AdamConfig(lr=SHARD_PARAM_LR, grad_clip=1.0)
    zfp_codec.reset_launches()
    flash_attention.reset_launches()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    try:
        mesh = make_host_mesh(dev, store_dir=tmp.name)
        pspecs = param_specs(params)
        dparams = distribute_tree(params, mesh, pspecs)
        dbatch = distribute_tree(batch, mesh, batch_specs(cfg, "train", False))

        def sharded_grads(b_):
            lm.set_constraint_mesh(mesh)
            try:
                loss_, grads_ = launch.loss_and_grads(
                    dparams, cfg, distribute_tree(b_, mesh, batch_specs(cfg, "train", False)))
                return float(loss_.full_tensor()), flat(gather_tree(grads_))
            finally:
                lm.set_constraint_mesh(None)

        # -- loss and gradients, sharded and plain; the control
        loss_s, grads_s = sharded_grads(batch)
        loss_p, grads_p = launch.loss_and_grads(params, cfg, batch)
        loss_p, grads_p = float(loss_p), flat(grads_p)
        same = sum(bool(torch.equal(grads_s[k], g)) for k, g in grads_p.items())
        by_leaf = ulps(grads_s, grads_p)
        g_rel = max(by_leaf.values())
        control = dict(batch, labels=batch["labels"].clone())
        control["labels"][SHARD_CONTROL_TOKEN] = (control["labels"][SHARD_CONTROL_TOKEN]
                                                  + 1) % cfg.vocab_size
        _, grads_c = sharded_grads(control)
        same_c = sum(bool(torch.equal(grads_c[k], g)) for k, g in grads_p.items())
        c_rel = max(ulps(grads_c, grads_p).values())
        print(f"sharded vs plain, {LM_ARCH} x {SHARD_LAYERS} layers bf16 on a one-rank "
              f"mesh: loss {loss_s!r} vs {loss_p!r}; gradients: {same} of "
              f"{len(grads_p)} leaves bit for bit; bf16 ulps of each leaf's max: "
              + ", ".join(f"{k} {v:.2f}" for k, v in by_leaf.items())
              + f"; control (label {SHARD_CONTROL_TOKEN} changed): {same_c} of "
              f"{len(grads_p)} leaves bit for bit, worst {c_rel:.2f} ulps", flush=True)
        require(loss_s == loss_p, f"the sharded loss {loss_s!r} == the plain loss {loss_p!r}")
        require(same == len(grads_p), f"sharded gradients == plain, bit for bit ({same} of "
                                      f"{len(grads_p)} leaves; worst {g_rel:.2f} bf16 ulps "
                                      f"of a leaf's max)")
        require(same_c < len(grads_p), "the control's gradients (one label changed) "
                                       "differ from the plain ones")
        del grads_s, grads_p, grads_c

        # -- one training step each, then SHARD_STEPS timed
        step_s = dryrun.make_train_step(cfg)

        def sharded_step():
            lm.set_constraint_mesh(mesh)
            try:
                opt = distribute_tree(launch.adam_init_tree(params), mesh, opt_specs(pspecs))
                return step_s(dparams, opt, dbatch)
            finally:
                lm.set_constraint_mesh(None)

        def plain_step():
            return launch.train_step(params, launch.adam_init_tree(params), batch, cfg,
                                     opt_cfg)

        new_s = flat(gather_tree(sharded_step()[0]))
        new_p = flat(plain_step()[0])
        p_same = sum(bool(torch.equal(new_s[k], w)) for k, w in new_p.items())
        print(f"updated parameters: {p_same} of {len(new_p)} leaves bit for bit", flush=True)
        require(p_same == len(new_p), "sharded updated parameters == plain, bit for bit")
        del new_s, new_p
        times = {}
        for name, fn in (("sharded", sharded_step), ("plain", plain_step),
                         ("sharded_again", sharded_step), ("plain_again", plain_step)):
            ts = []
            for _ in range(SHARD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                del out
            times[name] = statistics.median(ts)
        res["train"] = {"sharded_s": min(times["sharded"], times["sharded_again"]),
                        "plain_s": min(times["plain"], times["plain_again"]),
                        "steps": SHARD_STEPS, "tokens": b * s, "loss": loss_s,
                        "grad_worst_ulps": g_rel, "grad_leaves_equal": same,
                        "control_leaves_equal": same_c, "control_worst_ulps": c_rel,
                        "param_leaves_equal": p_same}
        print(f"train step ({b} x {s} tokens): sharded {times['sharded']:.4f} / "
              f"{times['sharded_again']:.4f} s, plain {times['plain']:.4f} / "
              f"{times['plain_again']:.4f} s (median of {SHARD_STEPS}, in turns; the "
              f"difference is DTensor's host work; {smi})", flush=True)

        # -- prefill and decode through kernel 5 under local_map
        bs, prompt, max_seq = SHARD_SERVE
        toks = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (bs, prompt + SHARD_DECODE)).astype(np.int32)).to(dev)
        dtoks = distribute_tree({"t": toks}, mesh, {"t": batch_specs(cfg, "prefill", False)
                                                     ["tokens"]})["t"]
        before = dict(flash_attention.VARIANT_LAUNCHES)
        lm.set_constraint_mesh(mesh)
        try:
            logits_s, cache_s = lm.lm_prefill(dparams, cfg, {"tokens": dtoks[:, :prompt]},
                                              max_seq)
            out_s = [logits_s.full_tensor()]
            for i in range(SHARD_DECODE):
                logits_s, cache_s = lm.serve_step(dparams, cfg, cache_s, dtoks[:, prompt + i],
                                                  prompt + i)
                out_s.append(logits_s.full_tensor())
            torch.cuda.synchronize()
        finally:
            lm.set_constraint_mesh(None)
        ran = {v: flash_attention.VARIANT_LAUNCHES[v] - before[v] for v in before}
        logits_p, cache_p = lm.lm_prefill(params, cfg, {"tokens": toks[:, :prompt]}, max_seq)
        out_p = [logits_p]
        for i in range(SHARD_DECODE):
            logits_p, cache_p = lm.serve_step(params, cfg, cache_p, toks[:, prompt + i],
                                              prompt + i)
            out_p.append(logits_p)
        diff = max(float((a - b_).abs().max()) for a, b_ in zip(out_s, out_p))
        print(f"sharded prefill ({bs} x {prompt}) and {SHARD_DECODE} decode steps: kernel 5 "
              f"variants {ran}; logits vs plain max |diff| {diff:.3e}", flush=True)
        require(ran["prefill_wgmma"] == SHARD_LAYERS and
                ran["decode_splitkv"] == SHARD_LAYERS * SHARD_DECODE and ran["scalar"] == 0,
                f"the sharded prefill ran prefill_wgmma and the decode decode_splitkv ({ran})")
        require(diff <= LOGIT_ATOL, f"sharded logits within {LOGIT_ATOL} of plain ({diff})")
        res["serve"] = {"variants": ran, "logits_max_diff": diff}
        del cache_s, cache_p

        # -- the pod-compressed step on a one-pod mesh: kernels 4 and 3
        pod_mesh = init_device_mesh(dev.type, (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        local = distribute_tree(params, pod_mesh["data", "model"], pspecs)
        lm.set_constraint_mesh(pod_mesh)
        try:
            _, grads = launch.loss_and_grads(local, cfg, distribute_tree(
                batch, pod_mesh["data", "model"], batch_specs(cfg, "train", False)))
            g32 = {k: v.to_local().float() for k, v in flat(grads).items()}
            mean = flat(dryrun.exchange(g32, pod_mesh, as_codec(SHARD_BITS), 1))
            exact = all(torch.equal(mean[k], compress_decompress(g, SHARD_BITS))
                        for k, g in g32.items())
            opt = distribute_tree(launch.adam_init_tree(params), pod_mesh["data", "model"],
                                  opt_specs(pspecs))
            new, _, loss_c = dryrun.make_train_step_podcompressed(cfg, pod_mesh, SHARD_BITS)(
                local, opt, distribute_tree(batch, pod_mesh, batch_specs(cfg, "train", True)))
            finite = math.isfinite(float(loss_c)) and all(
                bool(torch.isfinite(v.to_local().float()).all()) for v in flat(new).values())
        finally:
            lm.set_constraint_mesh(None)
        require(exact, f"the one-pod exchange at {SHARD_BITS} bits == compress_decompress "
                       f"of every leaf, bit for bit")
        require(finite, "the pod-compressed step's loss and parameters are finite")
        res["pod"] = {"bits": SHARD_BITS, "bit_exact": exact, "loss": float(loss_c)}
        del grads, g32, mean, new, local
    finally:
        lm.set_constraint_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    res["launches"] = dict(zfp_codec.LAUNCHES)
    res["attention"] = {"launches": flash_attention.LAUNCHES["flash_attention"],
                        "variants": dict(flash_attention.VARIANT_LAUNCHES),
                        "max_abs_err": res["partial"]["max_abs_err"]}
    print(f"sharded phase launches: {res['launches']}, kernel 5 {res['attention']}",
          flush=True)
    # the fixed-rate tree codec encodes through kernel 4 and decodes its
    # stacked payloads through kernel 1 (at 2 W planes a block)
    for name in ("zfp_encode_blocks", "zfp_decode_blocks_fa"):
        require(res["launches"][name] > 0, f"{name} launched by the pod exchange")
    print(json.dumps({"sharded_lm": res}))
    return res


def partial_attention_checks(dev, cfg, smi: str) -> dict:
    """Kernel 5's partial entry on the card at the shapes the sharded decode
    gives it where "model" splits ``SHARD_SERVE``'s bf16 cache in 2 and in
    4: bf16 q (B, H, 1, Dh) over each shard, the ``SHARD_DECODE`` decode
    ends past the prompt (so a shard before the end sees every key, moved
    by ``q_shift``, one holds the end, and one past it sees none); and 3
    queries with a 200-key window (some rows of the shard holding the end
    see none of its keys, and the window cuts the first shard).  Each
    shard's (out, lse) against the plain partial version, and the shards
    merged by their lse against the plain attention over the whole cache,
    to the f32 limit of ``ATTN_ATOL`` (both outputs are f32).  Times one
    2-way shard's launch against its plain version and the whole-cache
    decode.  Returns {"max_abs_err", "checks", "ms", "plain_ms",
    "whole_ms"}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    bs, prompt, max_seq = SHARD_SERVE
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hdim
    g = torch.Generator(device=dev).manual_seed(9)

    def rn(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    ck, cv = rn((bs, max_seq, hkv, d)), rn((bs, max_seq, hkv, d))
    tol = ATTN_ATOL[torch.float32]
    worst, checks = 0.0, 0

    def shard_args(q, shards, r, end, window=None):
        sl = max_seq // shards
        k0 = r * sl
        n = min(max(end - k0, 0), sl)
        return ((q.transpose(1, 2), ck[:, k0:k0 + sl].transpose(1, 2),
                 cv[:, k0:k0 + sl].transpose(1, 2)),
                dict(kv_lens=torch.full((bs,), n, dtype=torch.int32, device=dev),
                     q_shift=max(end - k0 - n, 0), window=window))

    for shards, (sq, window), i in itertools.product((2, 4), ((1, None), (3, 200)),
                                                     range(SHARD_DECODE)):
        end = prompt + i + 1
        q = rn((bs, sq, h, d))
        outs, lses = [], []
        for r in range(shards):
            args, kw = shard_args(q, shards, r, end, window)
            o, lse = fa.flash_attention_partial(*args, **kw)
            o_p, lse_p = ref.flash_attention_partial_ref(*args, **kw)
            err = max(float((o - o_p).abs().max()), float((lse - lse_p).abs().max()))
            require(o.dtype == lse.dtype == torch.float32 and err <= tol,
                    f"flash_attention_partial == plain (shard {r} of {shards}, Sq {sq}, "
                    f"window {window}, end {end}, {int(kw['kv_lens'][0])} keys, q_shift "
                    f"{kw['q_shift']}): max err {err:.3e} <= {tol}")
            worst, checks = max(worst, err), checks + 1
            outs.append(o)
            lses.append(lse)
        lse = torch.stack(lses)
        w = torch.exp(lse - lse.amax(0))
        merged = (torch.stack(outs) * w[..., None]).sum(0) / w.sum(0)[..., None]
        want, _ = ref.flash_attention_partial_ref(
            q.transpose(1, 2), ck[:, :end].transpose(1, 2), cv[:, :end].transpose(1, 2),
            window=window)
        err = float((merged - want).abs().max())
        require(err <= tol, f"{shards} partials merged == plain attention over the {end} "
                            f"keys (Sq {sq}, window {window}): max err {err:.3e} <= {tol}")
        worst, checks = max(worst, err), checks + 1
    q = rn((bs, 1, h, d))
    end = prompt + SHARD_DECODE
    args, kw = shard_args(q, 2, 0, end)
    whole = (q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
    lens = torch.full((bs,), end, dtype=torch.int32, device=dev)
    reps = 200
    res = {"max_abs_err": worst, "checks": checks,
           "ms": cuda_ms(lambda: fa.flash_attention_partial(*args, **kw), reps),
           "plain_ms": cuda_ms(lambda: ref.flash_attention_partial_ref(*args, **kw), reps),
           "whole_ms": cuda_ms(lambda: fa.flash_attention(*whole, kv_lens=lens), reps)}
    print(f"kernel 5's partial entry: {checks} checks (shards of 2 and 4; Sq 1, and 3 with a "
          f"window of 200; ends "
          f"{prompt + 1}..{prompt + SHARD_DECODE}), max err {worst:.3e}; one of 2 shards "
          f"({bs} x {h} heads over {max_seq // 2} keys) {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, the whole-cache decode {res['whole_ms']:.4f} ms "
          f"({smi})", flush=True)
    return res


def sharded_serving_rank(rank: int, world: int, port: int, device_type: str = "cuda") -> dict:
    """One rank of ``--ranks``: ``internlm2-1.8b`` at full width with
    ``SHARD_LAYERS`` layers in bf16 (the same seeded weights on every
    rank, rank 0's broadcast) on a (data 2, model world / 2) NCCL mesh over
    the cards, ``SHARD_SERVE``'s prefill and ``SHARD_DECODE`` decode steps
    sharded (the cache's sequence split over "model"), against the plain
    ones on the rank's own card (``device_type="cpu"``: gloo on the CPU, to
    try the path without cards).  Returns the launches of the sharded run
    and the largest logit difference over the ranks."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.compression import tree_flatten_with_path
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_specs, distribute_tree, param_specs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    on_card = device_type == "cuda"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=SHARD_LAYERS,
                                  param_dtype="bfloat16")
        params = lm.init_lm(torch.Generator(device=dev).manual_seed(7), cfg)
        for _, leaf in tree_flatten_with_path(params)[0]:
            dist.broadcast(leaf, 0)
        mesh = init_device_mesh(device_type, (2, world // 2),
                                mesh_dim_names=("data", "model"))
        dparams = distribute_tree(params, mesh, param_specs(params))
        bs, prompt, max_seq = SHARD_SERVE
        toks = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (bs, prompt + SHARD_DECODE)).astype(np.int32)).to(dev)
        dtoks = distribute_tree({"t": toks}, mesh, {"t": batch_specs(cfg, "prefill", False)
                                                     ["tokens"]})["t"]
        fa.reset_launches()
        lm.set_constraint_mesh(mesh)
        try:
            logits, cache = lm.lm_prefill(dparams, cfg, {"tokens": dtoks[:, :prompt]}, max_seq)
            out_s = [logits.full_tensor()]
            for i in range(SHARD_DECODE):
                logits, cache = lm.serve_step(dparams, cfg, cache, dtoks[:, prompt + i],
                                              prompt + i)
                out_s.append(logits.full_tensor())
        finally:
            lm.set_constraint_mesh(None)
        ran = {"variants": dict(fa.VARIANT_LAUNCHES), **fa.PARTIAL_LAUNCHES}
        del cache
        logits, cache = lm.lm_prefill(params, cfg, {"tokens": toks[:, :prompt]}, max_seq)
        out_p = [logits]
        for i in range(SHARD_DECODE):
            logits, cache = lm.serve_step(params, cfg, cache, toks[:, prompt + i], prompt + i)
            out_p.append(logits)
        diff = torch.tensor([max(float((a - b).abs().max()) for a, b in zip(out_s, out_p))],
                            device=dev)
        dist.all_reduce(diff, dist.ReduceOp.MAX)
        return {"rank": rank, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                "launches": ran, "logits_max_diff": float(diff)}
    finally:
        dist.destroy_process_group()


def multi_card_serving(world: int) -> int:
    """``--ranks world``: kernel 5 built once, then ``world - 1`` ranks of
    this script started beside this one (rank 0), each on its own card, all
    stopped by the end.  Requires on rank 0 that the sharded prefill ran
    ``prefill_wgmma``, that every sharded decode step of every layer ran the
    partial entry, and that the logits equal the plain ones to
    ``LOGIT_ATOL`` on every rank."""
    import socket
    from repro_torch.kernels import flash_attention as fa
    smi = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines())
    require(torch.cuda.device_count() >= world and world % 2 == 0,
            f"--ranks {world} needs an even count and as many cards "
            f"({torch.cuda.device_count()} here)")
    fa.build()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--ranks", str(world),
                               "--rank", str(r), "--port", str(port)])
             for r in range(1, world)]
    try:
        res = sharded_serving_rank(0, world, port)
        codes = [p.wait(timeout=MULTI_CARD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ran = res["launches"]
    print(f"sharded serving across {world} cards ({res['mesh']}): kernel 5 {ran}; logits "
          f"vs plain max |diff| {res['logits_max_diff']:.3e} (cards: {smi})", flush=True)
    require(codes == [0] * (world - 1), f"every rank ran to its end ({codes})")
    require(ran["variants"]["prefill_wgmma"] == SHARD_LAYERS
            and ran["flash_attention_partial"] == SHARD_LAYERS * SHARD_DECODE
            and ran["variants"]["decode_splitkv"] == SHARD_LAYERS * SHARD_DECODE
            and ran["variants"]["scalar"] == 0,
            f"the sharded prefill ran prefill_wgmma and every decode step the partial "
            f"entry ({ran})")
    require(res["logits_max_diff"] <= LOGIT_ATOL,
            f"sharded logits within {LOGIT_ATOL} of plain ({res['logits_max_diff']})")
    print(json.dumps({"multi_card_serving": res}))
    return 0


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    got, want = got.float(), want.float()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def moe_tied_router_check(dev, cfg, lp) -> dict:
    """On the card: with a zero router every score ties, so every token
    takes experts 0..k-1 (``jax.lax.top_k``'s order), each at weight 1/k;
    the experts' queues fill in token order, so the first ``cap`` tokens
    are kept and the rest dropped (y = 0).  The kept rows against the k
    experts applied one by one."""
    from repro_torch.models import lm
    e, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    n = 64
    cap = max(math.ceil(n * k / e * cfg.capacity_factor), 4)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((1, n, d), generator=g, device=dev).to(torch.bfloat16)
    _, ids = lm.top_k(torch.full((n, e), 1.0 / e, device=dev), k)
    tied = {**lp, "router": torch.zeros_like(lp["router"])}
    with torch.no_grad():
        y, _ = lm.moe_block(tied, x, cfg)
        want = sum(((torch.nn.functional.silu(x[0, :cap] @ lp["e_gate"][j])
                     * (x[0, :cap] @ lp["e_up"][j])) @ lp["e_down"][j]).float() / k
                   for j in range(k))
    ulps = bf16_ulps(y[0, :cap], want)
    res = {"tokens": n, "cap": cap, "experts": ids[0].tolist(), "kept_vs_one_by_one_ulps": ulps}
    print(f"tied router on the card: {res}", flush=True)
    require(bool((ids == torch.arange(k, device=dev)).all()),
            f"a tied router picks experts 0..{k - 1} for every token, as jax.lax.top_k")
    require(not bool(y[0, cap:].any()) and bool(y[0, :cap].abs().amax(-1).gt(0).all()),
            f"tokens past the experts' capacity ({cap}) are dropped (y = 0), the first {cap} "
            f"kept")
    require(ulps <= MOE_TIED_ULPS, f"kept rows == the {k} experts applied one by one at "
                                   f"weight 1/{k}: {ulps:.2f} <= {MOE_TIED_ULPS} bf16 ulps")
    return res


def moe_lm_path(dev, smi: str) -> dict:
    """The MoE family at full width (see MOE_ARCHS): qwen3 served, checked
    alone against batched, profiled and trained; arctic's dense residual at
    2 layers; kernel 5 at their groups.  Returns the readings and kernel
    5's launches on the path."""
    import dataclasses
    from repro_torch.compression import tree_flatten_with_path, tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.serving.loadgen import lm_workload
    from repro_torch.train.optimizer import AdamConfig

    def flat(tree):
        return dict(tree_flatten_with_path(tree)[0])

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def init(c, what):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p = lm.init_lm(gen(0), c)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in flat(p).values())
        print(f"lm: {c.name} at full width ({c.num_layers} layers{what}, d {c.d_model}, "
              f"{c.num_heads} q heads over {c.num_kv_heads} KV heads x {c.hdim}, "
              f"{c.num_experts} experts of ff {c.d_ff}, top {c.experts_per_token}, dense "
              f"residual {c.moe_dense_ff or 'none'}, vocab {c.vocab_size}), {n} parameters "
              f"({sum(t.numel() * t.element_size() for t in flat(p).values())} bytes), init "
              f"{time.perf_counter() - t0:.2f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        return p, n

    def last_logits(params, c, plain=False):
        """(lm_forward's, lm_prefill's) last-token f32 logits on a seeded
        MOE_PROMPTS[-1]-token prompt, lm_prefill through kernel 5 or, with
        ``plain``, through its plain version; and kernel 5's launches."""
        fa.reset_launches()
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, c.vocab_size, (1, MOE_PROMPTS[-1])).astype(np.int32)).to(dev)
        with torch.no_grad():
            hidden, _ = lm.lm_forward(params, c, {"tokens": toks})
            n_fwd = fa.LAUNCHES["flash_attention"]
            train_logits = (hidden[:, -1] @ lm._head_weight(params, c)).float()
            del hidden
            with (mock.patch.object(ops, "flash_attention", ref.flash_attention_ref) if plain
                  else contextlib.nullcontext()):
                serve_logits, cache = lm.lm_prefill(params, c, {"tokens": toks},
                                                    MOE_PROMPTS[-1])
            del cache
        return train_logits, serve_logits, n_fwd, fa.LAUNCHES["flash_attention"] - n_fwd

    def logit_diff(a, b):
        return {"max_abs_diff": float((a - b).abs().max()),
                "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())}

    def forward_vs_prefill(params, c, what=""):
        """lm_forward's last-token logits against lm_prefill's (kernel 5) to
        LOGIT_ATOL, as the dense and recurrent phases hold them."""
        train_logits, serve_logits, n_fwd, n_pre = last_logits(params, c)
        out = {"tokens": MOE_PROMPTS[-1], "layers": c.num_layers,
               **logit_diff(train_logits, serve_logits), "kernel5_launches": n_pre}
        print(f"{c.name}{what} lm_forward vs lm_prefill on {MOE_PROMPTS[-1]} tokens: {out}",
              flush=True)
        require(n_fwd == 0 and n_pre == c.num_layers == fa.VARIANT_LAUNCHES["prefill_wgmma"],
                f"{c.name}{what}: lm_forward launched no kernel 5, lm_prefill one "
                f"prefill_wgmma a layer ({n_pre})")
        require(out["max_abs_diff"] <= LOGIT_ATOL,
                f"{c.name}{what}: lm_forward's last-token logits == lm_prefill's (kernel 5) on "
                f"{MOE_PROMPTS[-1]} tokens: max abs diff {out['max_abs_diff']:.4f} <= "
                f"{LOGIT_ATOL}")
        return out

    def full_depth_witness(params, c):
        """At full depth bf16 routing amplifies rounding: the attention's
        last-bit differences flip near-tied experts, and a flipped expert
        moves a token's residual stream by a whole expert's output.  So the
        full-depth forward and prefill are only read here, beside the same
        prefill with kernel 5 swapped for its plain version: a prefill that
        differs from itself, by the attention's rounding alone, as much as
        it differs from the forward."""
        train_logits, serve_logits, _, _ = last_logits(params, c)
        _, plain_logits, _, n_plain = last_logits(params, c, plain=True)
        out = {"tokens": MOE_PROMPTS[-1], "layers": c.num_layers,
               "forward_vs_prefill": logit_diff(train_logits, serve_logits),
               "prefill_vs_plain_prefill": logit_diff(serve_logits, plain_logits),
               "forward_vs_plain_prefill": logit_diff(train_logits, plain_logits)}
        print(f"{c.name} at full depth, last-token logits on {MOE_PROMPTS[-1]} tokens: {out}",
              flush=True)
        require(n_plain == 0, f"{c.name}: the plain prefill launched no kernel")
        require(all(bool(torch.isfinite(t).all())
                    for t in (train_logits, serve_logits, plain_logits)),
                f"{c.name}: the full-depth forward's and prefills' logits are finite")
        return out

    res = {"attention": {"launches": 0, "variants": dict.fromkeys(fa.VARIANTS, 0)},
           "seconds": {}}
    t_section = [time.perf_counter()]

    def section(name):
        now = time.perf_counter()
        res["seconds"][name] = now - t_section[0]
        t_section[0] = now

    def add_launches(runs, name):
        for mode, (_, c, _) in runs.items():
            v = c["variants"]
            require(0 < c["prefill"] == v["prefill"]["prefill_wgmma"]
                    and 0 < c["decode"] == v["decode"]["decode_splitkv"]
                    and v["prefill"]["scalar"] == v["decode"]["scalar"] == 0,
                    f"{name} {mode}: every prefill launch ran prefill_wgmma and every decode "
                    f"launch decode_splitkv, none the scalar variant ({v})")
            res["attention"]["launches"] += c["prefill"] + c["decode"]
            for ph in v:
                for k, n in v[ph].items():
                    res["attention"]["variants"][k] += n

    cfg = get_config(MOE_ARCHS[0])
    acfg = dataclasses.replace(get_config(MOE_ARCHS[1]), num_layers=ARCTIC_LAYERS)
    res["attention"]["max_abs_err"] = max(
        group_attention_checks(dev, c, ((1, MOE_PROMPTS[-1]),), CHECK_KV_LENS, LM_MAX_SEQ,
                               (None,), seed, c.name)
        for c, seed in ((cfg, 5), (acfg, 6)))
    print(f"MoE phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at its start",
          flush=True)
    section("kernel5_checks")

    # -- qwen3-moe-30b-a3b at full width and depth: serve
    params, n_params = init(cfg, "")
    require(n_params == lm.param_count(cfg) == MOE_PARAMS,
            f"{cfg.name}: parameter count == param_count == {MOE_PARAMS} ({n_params})")
    engine = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    engine.run(lm_workload(cfg.vocab_size, 2, prompt_lens=(8,), new_tokens=(2,), seed=1))
    torch.cuda.synchronize()
    runs = {**serve_modes(engine, cfg, MOE_PROMPTS, LM_NEW, n_requests=MOE_REQUESTS,
                          modes=("run",)),
            **serve_modes(engine, cfg, MOE_PROMPTS, LM_NEW, n_requests=MOE_LOCKSTEP_REQUESTS,
                          modes=("run_lockstep",))}
    add_launches(runs, cfg.name)
    res["serve"] = {mode: {**c["stats"], "prefill_launches": c["prefill"],
                           "decode_launches": c["decode"], "variants": c["variants"]}
                    for mode, (_, c, _) in runs.items()}
    # the lockstep workload is the first MOE_LOCKSTEP_REQUESTS of run's
    by_mode = [np.concatenate([r.output for r in runs[m][0][:MOE_LOCKSTEP_REQUESTS]])
               for m in runs]
    res["run_vs_lockstep_equal"] = float(np.mean(by_mode[0] == by_mode[1]))
    res["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{cfg.name} run vs run_lockstep: {res['run_vs_lockstep_equal']:.4f} of "
          f"{by_mode[0].size} greedy tokens equal; peak "
          f"{res['serve_peak_bytes'] / 1e9:.2f} GB", flush=True)

    section("qwen3_init_and_serve")

    # -- a decode step's wall, busy share, kernels and operator calls, at the
    # first chunk's depths, beside the bound of reading its weights
    served = runs["run"][0]
    chunk = served[:LM_SLOTS]
    plen = max(len(r.prompt) for r in chunk)
    ptoks = np.zeros((LM_SLOTS, plen), np.int32)
    for j, r in enumerate(chunk):
        ptoks[j, :len(r.prompt)] = r.prompt
    lens_np = np.array([len(r.prompt) for r in chunk], np.int32)
    logits, cache = engine._prefill(ptoks, lens_np)
    cur = logits.argmax(-1).to(torch.int32)
    depth = torch.from_numpy(lens_np).to(dev)

    def decode_step():
        out, _ = lm.serve_step(params, cfg, cache, cur, depth)
        torch.argmax(out, -1).cpu()

    for _ in range(2):
        decode_step()
    prof = profile_lm_steps(decode_step, MOE_PROFILE_STEPS)
    shapes = lm._layer_param_shapes(cfg)
    expert_bytes = 2 * cfg.num_layers * sum(math.prod(shapes[w]) for w in lm._EXPERT_LEAVES)
    weight_bytes = 2 * (lm.param_count(cfg) - cfg.vocab_size * cfg.d_model)   # embed: 8 rows
    prof.update(expert_bytes=expert_bytes, expert_bound_ms=1e3 * expert_bytes / HBM_BYTES_PER_S,
                weight_bytes=weight_bytes, weight_bound_ms=1e3 * weight_bytes / HBM_BYTES_PER_S)
    res["decode_profile"] = prof
    print(f"{cfg.name} decode step profile ({LM_SLOTS} slots at depths {lens_np.tolist()}): "
          f"{prof}; {smi}", flush=True)
    del cache

    # -- one prefill of MOE_PROMPTS[-1] tokens, timed
    prompt = np.arange(MOE_PROMPTS[-1], dtype=np.int32)[None] % cfg.vocab_size
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine._prefill(prompt, np.array([MOE_PROMPTS[-1]]))
        torch.argmax(logits, -1).cpu()
        times.append(time.perf_counter() - t0)
        del cache
    res["prefill_1024_ms"] = 1e3 * statistics.median(times[1:])
    print(f"{cfg.name} one prefill of {MOE_PROMPTS[-1]} tokens: median "
          f"{res['prefill_1024_ms']:.2f} ms of {len(times) - 1} (first {1e3 * times[0]:.2f}); "
          f"{smi}", flush=True)
    res["full_depth_logits"] = full_depth_witness(params, cfg)
    # the prefill path against the forward where routing is still stable:
    # the model's first MOE_FWD_LAYERS layers (views of its stacked leaves)
    fcfg = dataclasses.replace(cfg, num_layers=MOE_FWD_LAYERS)
    res["forward_vs_prefill"] = forward_vs_prefill(
        {**params, "layers": {k: v[:MOE_FWD_LAYERS] for k, v in params["layers"].items()}},
        fcfg, f" (first {MOE_FWD_LAYERS} layers)")

    section("qwen3_profile_prefill_forward")

    # -- alone against batched with lossless dispatch (capacity_factor E / k)
    lossless = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    leng = ServeEngine(params, lossless, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    reqs = lm_workload(cfg.vocab_size, MOE_SOLO, prompt_lens=(MOE_PROMPTS[0],),
                       new_tokens=(MOE_SOLO_NEW,), seed=3)
    done = leng.run(reqs)
    order = {id(r): i for i, r in enumerate(reqs)}
    done = sorted(done, key=lambda r: order[id(r)])
    res["solo"] = []
    for row, r in enumerate(done):
        out = leng.run([Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens)])[0]
        n = len(r.output)
        part = next((t for t in range(n) if out.output[t] != r.output[t]), n)
        gap = diff = 0.0
        if part < n:        # parted: the batch's tokens teacher-forced, alone and batched
            solo_tf = _replay(lm, params, lossless, [r], dev)[0][0]
            batch_tf = _replay(lm, params, lossless, done, dev)[0][0]
            diff = float((solo_tf[:n, 0] - batch_tf[:n, row]).abs().max())
            gap = float((solo_tf[part, 0, int(out.output[part])]
                         - solo_tf[part, 0, int(r.output[part])]).abs())
            del solo_tf, batch_tf
        res["solo"].append({"prompt": len(r.prompt), "tokens": n,
                            "equal": int(np.sum(out.output == r.output)),
                            "first_difference": part, "tie_gap": gap,
                            "teacher_forced_max_abs_diff": diff})
        print(f"{cfg.name} request {row} alone against the batch, lossless dispatch: "
              f"{res['solo'][-1]}", flush=True)
        upto = ("the end" if part == n else
                f"a tie ({gap:.4f} <= 2 x {diff:.4f}, the bf16 teacher-forced difference)")
        require(gap <= 2 * diff, f"{cfg.name}: request {row} served alone gives the batch's "
                                 f"tokens ({part} of {n}) up to {upto}")
    del leng

    # -- a tied router on the card, and the reference's group rule
    res["tied_router"] = moe_tied_router_check(
        dev, cfg, {k: v[0] for k, v in params["layers"].items()})
    rng = np.random.default_rng(4)
    plen = cfg.moe_group // 2          # three prompts: 1,536 tokens, not a multiple
    three = [Request(rng.integers(0, cfg.vocab_size, plen).astype(np.int32), max_new_tokens=2)
             for _ in range(3)]
    try:
        engine.run(three)
        refused = ""
    except ValueError as e:
        refused = str(e)
    print(f"{cfg.name}: a prefill group of three {plen}-token prompts: {refused!r}", flush=True)
    require("moe_group" in refused, f"{cfg.name}: a prefill group of 3 x {plen} tokens (above "
                                    f"moe_group {cfg.moe_group}, not a multiple) raises the "
                                    f"ValueError, as the reference's reshape fails")
    run_depths = runs["run"][2]
    qwen_lens = run_depths[len(run_depths) // 2] + 1
    del engine, params, runs, served, done
    free()
    section("qwen3_solo_tied_group_rule")

    # -- training at full width, MOE_TRAIN_LAYERS layers
    tcfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    params, n_params = init(tcfg, f", reduced from {cfg.num_layers}")
    require(n_params == lm.param_count(tcfg) == MOE_TRAIN_PARAMS,
            f"{cfg.name} at {MOE_TRAIN_LAYERS} layers: {MOE_TRAIN_PARAMS} parameters "
            f"({n_params})")
    opt_cfg = AdamConfig(lr=LM_TRAIN_LR, grad_clip=1.0)
    rng = np.random.default_rng(0)
    batch_n, seq = MOE_TRAIN
    fa.reset_launches()
    loss, grads = launch.loss_and_grads(params, tcfg, launch.make_batch(rng, tcfg, batch_n,
                                                                        seq, dev))
    g = flat(grads)
    require(all(bool(torch.isfinite(t).all()) for t in g.values())
            and bool(torch.isfinite(loss)),
            f"{cfg.name}: every one of {len(g)} gradients is finite on the card "
            f"(loss {float(loss):.4f})")
    moved = [k for k in ("router", "e_gate", "e_up", "e_down", "wq", "wk", "wv", "wo")
             if float(g[f"layers/{k}"].float().abs().max()) > 0]
    require(len(moved) == 8, f"{cfg.name}: the router, expert and attention leaves have "
                             f"nonzero gradients ({moved})")
    del grads, g
    opt = launch.adam_init_tree(params)
    params, opt, loss = launch.train_step(params, opt, launch.make_batch(
        rng, tcfg, batch_n, seq, dev), tcfg, opt_cfg)                   # warm-up
    float(loss)
    losses, step_s = [], []
    for _ in range(MOE_TRAIN_STEPS):
        batch = launch.make_batch(rng, tcfg, batch_n, seq, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = launch.train_step(params, opt, batch, tcfg, opt_cfg)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(fa.LAUNCHES["flash_attention"] == 0, f"{cfg.name}: no kernel-5 launch in training")
    require(all(np.isfinite(losses)), f"{cfg.name}: {MOE_TRAIN_STEPS} finite losses")
    require(peak <= MOE_PEAK_LIMIT, f"{cfg.name}: training peak {peak / 1e9:.2f} GB <= "
                                    f"{MOE_PEAK_LIMIT / 1e9:.0f} GB")
    med = statistics.median(step_s)
    res["train"] = {"layers": MOE_TRAIN_LAYERS, "batch": batch_n, "seq": seq,
                    "losses": losses, "step_s": step_s, "median_s": med,
                    "tokens_per_s": batch_n * seq / med, "max_memory_allocated": peak}
    print(f"{cfg.name} training ({MOE_TRAIN_LAYERS} layers): {MOE_TRAIN_STEPS} steps of "
          f"{batch_n} x {seq} after a warm-up, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
          f"median {med:.4f} s, {batch_n * seq / med:.1f} tokens/s; peak {peak / 1e9:.2f} GB; "
          f"{smi}", flush=True)
    del params, opt
    free()
    section("train")

    # -- card against CPU: one loss and its gradients, 1 layer, f32
    cfg1 = dataclasses.replace(cfg, num_layers=1, param_dtype="float32")
    p_card = lm.init_lm(gen(1), cfg1)
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    b_card = launch.make_batch(np.random.default_rng(1), cfg1, 1, LM_CPU_SEQ, dev)
    t0 = time.perf_counter()
    l_card, g_card = launch.loss_and_grads(p_card, cfg1, b_card)
    l_cpu, g_cpu = launch.loss_and_grads(p_cpu, cfg1, {k: v.cpu() for k, v in b_card.items()})
    # the control: the f32 config's expert products in bf16 on the card
    block = lm.moe_block
    with mock.patch.object(lm, "moe_block", lambda lp, x, c: block(
            {**lp, **{k: lp[k].to(torch.bfloat16) for k in lm._EXPERT_LEAVES}}, x, c)):
        _, g_ctl = launch.loss_and_grads(p_card, cfg1, b_card)
    g_card, g_cpu, g_ctl = flat(g_card), flat(g_cpu), flat(g_ctl)

    def spread(got):                    # compared on the card: 1.2e9 values
        out = {}
        for k, g in g_cpu.items():
            want = g.to(dev)
            out[k] = float((got[k] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            del want
        return out

    rel, ctl = spread(g_card), spread(g_ctl)
    res["cpu_check"] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
                        "grad_worst_rel": max(rel.values()),
                        "bf16_experts_worst_rel": max(ctl.values()),
                        "seconds": time.perf_counter() - t0}
    print(f"{cfg.name} card vs CPU, loss and gradients at full width, 1 layer, f32, 1 x "
          f"{LM_CPU_SEQ}: {res['cpu_check']}; per leaf (of its max) {rel}; the control with "
          f"bf16 expert products, per leaf {ctl}", flush=True)
    require(abs(float(l_card) - float(l_cpu)) <= LM_CPU_LOSS_RTOL * abs(float(l_cpu)),
            f"{cfg.name}: loss on the card {float(l_card):.7f} == CPU {float(l_cpu):.7f} "
            f"(rtol {LM_CPU_LOSS_RTOL})")
    require(max(rel.values()) <= MOE_CARD_GRAD_RTOL,
            f"{cfg.name}: every gradient on the card == CPU (worst {max(rel.values()):.2e} of "
            f"its tensor's max <= {MOE_CARD_GRAD_RTOL})")
    require(max(ctl.values()) > MOE_CARD_GRAD_RTOL,
            f"{cfg.name}: the limit fails the control, bf16 expert products on the card "
            f"(worst {max(ctl.values()):.2e} > {MOE_CARD_GRAD_RTOL})")
    del p_card, p_cpu, g_card, g_cpu, g_ctl, b_card
    free()
    section("cpu_check")

    # -- arctic-480b at full width, ARCTIC_LAYERS layers: the dense residual
    params, n_params = init(acfg, f", reduced from {get_config(MOE_ARCHS[1]).num_layers}")
    require(n_params == lm.param_count(acfg) == ARCTIC_PARAMS,
            f"{acfg.name} at {ARCTIC_LAYERS} layers: {ARCTIC_PARAMS} parameters ({n_params})")
    res["arctic_forward_vs_prefill"] = forward_vs_prefill(params, acfg)
    engine = ServeEngine(params, acfg, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ, device=dev)
    engine.run(lm_workload(acfg.vocab_size, 2, prompt_lens=(8,), new_tokens=(2,), seed=1))
    runs = serve_modes(engine, acfg, MOE_PROMPTS, (MOE_SOLO_NEW,), n_requests=ARCTIC_REQUESTS,
                       modes=("run",))
    add_launches(runs, acfg.name)
    res["arctic_serve"] = {**runs["run"][1]["stats"],
                           "prefill_launches": runs["run"][1]["prefill"],
                           "decode_launches": runs["run"][1]["decode"],
                           "variants": runs["run"][1]["variants"],
                           "peak_bytes": torch.cuda.max_memory_allocated()}
    print(f"{acfg.name} ({ARCTIC_LAYERS} layers) peak "
          f"{res['arctic_serve']['peak_bytes'] / 1e9:.2f} GB", flush=True)
    arctic_depths = runs["run"][2]
    arctic_lens = arctic_depths[len(arctic_depths) // 2] + 1
    del engine, params, runs
    free()
    section("arctic")

    # -- kernel 5 at the groups of both models: prefill and the served decode
    res["attention"]["timings"] = {
        c.name: group_attention_timings(dev, c, MOE_PROMPTS[-1], LM_MAX_SEQ, lens, smi, None,
                                        seed, c.name)
        for c, lens, seed in ((cfg, qwen_lens, 8), (acfg, arctic_lens, 9))}
    section("kernel5_timings")
    print(f"MoE phase seconds by section: {res['seconds']}", flush=True)
    print(json.dumps({"moe_lm": res}, default=str), flush=True)
    return res


@contextlib.contextmanager
def served_attention():
    """While entered: counts the calls of ``ops.flash_attention`` by
    ``causal`` and refuses the plain attentions (``lm.attention_train``,
    ``ref.flash_attention_ref``), so that a served path must take kernel 5
    at every attention call.  Yields the counts."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    calls = {"causal": 0, "non_causal": 0}
    real = ops.flash_attention

    def counted(*args, **kw):
        calls["causal" if kw.get("causal", True) else "non_causal"] += 1
        return real(*args, **kw)

    def refuse(name):
        def call(*args, **kw):
            raise CheckFailed(f"{name} reached from a served path")
        return call

    with mock.patch.object(ops, "flash_attention", counted), \
            mock.patch.object(lm, "attention_train", refuse("lm.attention_train")), \
            mock.patch.object(ref, "flash_attention_ref", refuse("ref.flash_attention_ref")):
        yield calls


def served_decode(lm, params, cfg, batch: dict, lens, start: torch.Tensor, max_seq: int,
                  steps: int, feed=None):
    """``lm_prefill`` of ``batch`` (rows right-padded to ``lens``, or None),
    f32 cache, then ``steps`` ``serve_step``s at the per-slot positions
    ``start + t``, each fed the greedy token (read back to the host, as the
    engine does) or ``feed[t]``.  Returns (logits (steps + 1, B, V) f32,
    tokens (steps + 1, B), {"prefill_s", "decode_s", "decode_step_ms"})."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.lm_prefill(params, cfg, batch, max_seq, cache_dtype=torch.float32,
                                  prompt_lens=lens)
    out_l, out_t = [logits], [logits.argmax(-1)]
    out_t[-1].cpu()
    t1 = time.perf_counter()
    for t in range(steps):
        cur = (out_t[-1] if feed is None else feed[t]).to(torch.int32)
        logits, cache = lm.serve_step(params, cfg, cache, cur, start + t)
        out_l.append(logits)
        out_t.append(logits.argmax(-1))
        out_t[-1].cpu()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del cache
    return torch.stack(out_l), torch.stack(out_t), {
        "prefill_s": t1 - t0, "decode_s": t2 - t1, "decode_step_ms": 1e3 * (t2 - t1) / steps}


def frontend_inputs(cfg, b: int, n: int, seed: int, dev) -> dict:
    """Seeded N(0, 1) f32 inputs of a family's frontend: the VLM's (b, n,
    frontend_dim) image embeddings or the encoder-decoder's frames."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, n, cfg.frontend_dim)).astype(np.float32)).to(dev)
    return {"encoder_embeds" if cfg.encoder_layers else "frontend_embeds": x}


def frontend_family(dev, name: str, smi: str) -> dict:
    """One family of the VLM and encoder-decoder path at full width (see
    FRONT_ARCHS): serve, decode against the forward, (the encoder-decoder)
    one request alone against its batch, a decode step's profile,
    training, and card against CPU.  Returns the readings, kernel 5's
    launches among them."""
    import dataclasses
    from repro_torch.compression import tree_flatten_with_path, tree_map
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.loadgen import lm_workload
    from repro_torch.train.optimizer import AdamConfig

    def flat(tree):
        return dict(tree_flatten_with_path(tree)[0])

    cfg = get_config(name)
    enc = cfg.encoder_layers > 0
    n_layers, n_enc = cfg.num_layers, cfg.encoder_layers
    res = {"attention": {"launches": 0, "variants": dict.fromkeys(fa.VARIANTS, 0)},
           "launches_by_run": {}, "seconds": {}}
    t_section = [time.perf_counter()]

    def section(what):
        now = time.perf_counter()
        res["seconds"][what] = now - t_section[0]
        t_section[0] = now

    def served(what, calls, before, causal, non_causal, prefill, decode):
        """Kernel 5's launches of a served run against its attention calls."""
        ran = {n: fa.VARIANT_LAUNCHES[n] - before[n] for n in fa.VARIANTS}
        want = {"prefill_wgmma": prefill, "decode_splitkv": decode, "scalar": 0}
        require(calls == {"causal": causal, "non_causal": non_causal}
                and sum(ran.values()) == causal + non_causal and ran == want,
                f"{name} {what}: every attention call launched kernel 5, none the plain "
                f"attention ({calls} calls; variants {ran}, {want} required)")
        res["attention"]["launches"] += sum(ran.values())
        for k, n in ran.items():
            res["attention"]["variants"][k] += n
        res["launches_by_run"][what] = {"calls": dict(calls), "variants": ran}

    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flat(params).values())
    print(f"lm: {name} at full width ({n_layers} layers"
          + (f", {n_enc} encoder layers" if enc else "")
          + f", d {cfg.d_model}, {cfg.num_heads} q heads over {cfg.num_kv_heads} KV heads x "
          f"{cfg.hdim}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.frontend} frontend of "
          f"width {cfg.frontend_dim}"
          + (f", {cfg.frontend_seq} image tokens" if cfg.frontend_seq else "")
          + f"), {n_params} parameters "
          f"({sum(t.numel() * t.element_size() for t in flat(params).values())} bytes), init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    require(n_params == lm.param_count(cfg) == FRONT_PARAMS[name],
            f"{name}: parameter count == param_count == {FRONT_PARAMS[name]} ({n_params})")
    head = lm._head_weight(params, cfg)

    if not enc:
        # -- the engine serves the VLM from tokens alone
        engine = ServeEngine(params, cfg, batch_slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                             device=dev)
        engine.run(lm_workload(cfg.vocab_size, 2, prompt_lens=(8,), new_tokens=(2,), seed=1))
        torch.cuda.synchronize()
        runs = serve_modes(engine, cfg, LM_PROMPTS, LM_NEW, n_requests=FRONT_REQUESTS,
                           modes=("run",))
        _, c, _ = runs["run"]
        v = c["variants"]
        require(0 < c["prefill"] == v["prefill"]["prefill_wgmma"]
                and 0 < c["decode"] == v["decode"]["decode_splitkv"]
                and v["prefill"]["scalar"] == v["decode"]["scalar"] == 0,
                f"{name} run: every prefill launch ran prefill_wgmma and every decode launch "
                f"decode_splitkv, none the scalar variant ({v})")
        res["attention"]["launches"] += c["prefill"] + c["decode"]
        for ph in v:
            for k, n in v[ph].items():
                res["attention"]["variants"][k] += n
        res["serve"] = {**c["stats"], "prefill_launches": c["prefill"],
                        "decode_launches": c["decode"], "variants": v}
        res["launches_by_run"]["run"] = {"prefill_launches": c["prefill"],
                                         "decode_launches": c["decode"]}
        served_reqs = runs["run"][0]
        section("serve")

        # -- an image request: lm_prefill of image and prompt, greedy decode
        f_img, plen = cfg.frontend_seq, cfg.frontend_seq + VLM_IMAGE_PROMPT
        prompt = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (1, VLM_IMAGE_PROMPT)).astype(np.int32)).to(dev)
        image = frontend_inputs(cfg, 1, f_img, 6, dev)
        before = dict(fa.VARIANT_LAUNCHES)
        with served_attention() as calls:
            logits, toks, times = served_decode(
                lm, params, cfg, {"tokens": prompt, **image}, None,
                torch.full((1,), plen, dtype=torch.int32, device=dev), plen + FRONT_NEW,
                FRONT_NEW)
        served("image", calls, before, n_layers * (1 + FRONT_NEW), 0, n_layers,
               n_layers * FRONT_NEW)
        gen = toks[:FRONT_NEW, 0][None].to(torch.int32)
        with torch.no_grad():
            hidden, _ = lm.lm_forward(params, cfg, {"tokens": torch.cat([prompt, gen], 1),
                                                    **image})
            fwd = (hidden[:, plen - 1:plen + FRONT_NEW] @ head).float()[0]
            del hidden
        dec = logits[:, 0]
        err = float((fwd - dec).abs().max())
        res["image"] = {"image_tokens": f_img, "prompt": VLM_IMAGE_PROMPT,
                        "new_tokens": FRONT_NEW, **times, "decode_vs_forward": err,
                        "argmax_equal": float((fwd.argmax(-1) == dec.argmax(-1))
                                              .float().mean())}
        print(f"{name} image request ({f_img} image tokens + {VLM_IMAGE_PROMPT} prompt "
              f"tokens, {FRONT_NEW} greedy steps from position {plen}): {res['image']}; {smi}",
              flush=True)
        require(err <= LOGIT_ATOL, f"{name}: the image request's decode logits == "
                                   f"lm_forward's, teacher-forced (max abs diff {err:.4f} <= "
                                   f"{LOGIT_ATOL})")
        require(bool(torch.isfinite(dec).all()) and dec.shape == (FRONT_NEW + 1,
                                                                  cfg.vocab_size),
                f"{name}: finite ({FRONT_NEW + 1}, {cfg.vocab_size}) decode logits")
        del logits, fwd, dec

        # -- a decode step of 8 slots at the run's first chunk's depths
        chunk = served_reqs[:LM_SLOTS]
        ptoks = np.zeros((LM_SLOTS, max(len(r.prompt) for r in chunk)), np.int32)
        for j, r in enumerate(chunk):
            ptoks[j, :len(r.prompt)] = r.prompt
        lens_np = np.array([len(r.prompt) for r in chunk], np.int32)
        logits, cache = engine._prefill(ptoks, lens_np)
        del engine
    else:
        # -- FRONT_REQUESTS requests through lm_prefill and serve_step
        rng = np.random.default_rng(7)
        lens_np = np.array([ENC_PROMPTS[i % len(ENC_PROMPTS)] for i in range(FRONT_REQUESTS)],
                           np.int32)
        ptoks = np.zeros((FRONT_REQUESTS, lens_np.max()), np.int32)
        for j, n in enumerate(lens_np):
            ptoks[j, :n] = rng.integers(0, cfg.vocab_size, n)
        toks_t = torch.from_numpy(ptoks).to(dev)
        lens = torch.from_numpy(lens_np).to(dev)
        frames = frontend_inputs(cfg, FRONT_REQUESTS, ENC_FRAMES, 8, dev)
        max_seq = int(lens_np.max()) + FRONT_NEW
        served_decode(lm, params, cfg, {"tokens": toks_t[:2, :8], **{
            k: x[:2, :16] for k, x in frames.items()}}, None,
            torch.full((2,), 8, dtype=torch.int32, device=dev), 16, 2)        # warm-up
        before = dict(fa.VARIANT_LAUNCHES)
        with served_attention() as calls:
            logits, toks, times = served_decode(lm, params, cfg, {"tokens": toks_t, **frames},
                                                lens, lens, max_seq, FRONT_NEW)
        served("served", calls, before, n_layers * (1 + FRONT_NEW),
               n_enc + n_layers * (1 + FRONT_NEW), n_enc + 2 * n_layers,
               2 * n_layers * FRONT_NEW)
        n_tok = FRONT_REQUESTS * (FRONT_NEW + 1)
        res["serve"] = {"requests": FRONT_REQUESTS, "frames": ENC_FRAMES,
                        "prompts": lens_np.tolist(), "new_tokens": FRONT_NEW + 1, **times,
                        "decode_tok_s": FRONT_REQUESTS * FRONT_NEW / times["decode_s"],
                        "prefill_tok_s": int(lens_np.sum()) / times["prefill_s"],
                        "tokens": n_tok}
        print(f"{name} served {FRONT_REQUESTS} requests ({ENC_FRAMES} frames each, prompts "
              f"{lens_np.tolist()}, {FRONT_NEW + 1} tokens each): {res['serve']}; {smi}",
              flush=True)
        require(bool(torch.isfinite(logits).all()) and bool((toks >= 0).all())
                and bool((toks < cfg.vocab_size).all()),
                f"{name}: finite logits, tokens in the vocab")
        section("serve")

        # -- the decode against lm_forward, teacher-forced: each row its prompt
        # and its served tokens (causal: the pads after them reach nothing)
        full = torch.zeros((FRONT_REQUESTS, max_seq), dtype=torch.int32, device=dev)
        full[:, :ptoks.shape[1]] = toks_t
        rows = torch.arange(FRONT_REQUESTS, device=dev)[:, None]
        cols = lens[:, None] + torch.arange(FRONT_NEW, device=dev)[None]
        full[rows, cols] = toks[:FRONT_NEW].T.to(torch.int32)
        with torch.no_grad():
            hidden, _ = lm.lm_forward(params, cfg, {"tokens": full, **frames})
            at = torch.cat([cols - 1, cols[:, -1:]], 1)             # lens - 1 .. lens + 31
            fwd = (hidden[rows, at] @ head).float()                 # (B, T, V)
            del hidden
        err = float((fwd - logits.transpose(0, 1)).abs().max())
        agree = float((fwd.argmax(-1) == logits.transpose(0, 1).argmax(-1)).float().mean())
        res["decode_vs_forward"] = {"max_abs_diff": err, "argmax_equal": agree}
        print(f"{name} decode vs lm_forward, teacher-forced: {res['decode_vs_forward']}",
              flush=True)
        require(err <= LOGIT_ATOL, f"{name}: decode logits == lm_forward's, teacher-forced "
                                   f"(max abs diff {err:.4f} <= {LOGIT_ATOL})")
        del fwd

        # -- one request alone against its batch: tokens equal up to a tie
        row, n0 = 0, int(lens_np[0])
        one = {"tokens": toks_t[:1, :n0], **{k: x[:1] for k, x in frames.items()}}
        start = lens[:1]
        _, solo_t, _ = served_decode(lm, params, cfg, one, None, start, n0 + FRONT_NEW,
                                     FRONT_NEW)
        solo_tf, _, _ = served_decode(lm, params, cfg, one, None, start, n0 + FRONT_NEW,
                                      FRONT_NEW, feed=toks[:, row:row + 1])
        diff = float((solo_tf[:, 0] - logits[:, row]).abs().max())
        out, want = solo_t[:, 0].cpu().numpy(), toks[:, row].cpu().numpy()
        n = len(want)
        part = next((t for t in range(n) if out[t] != want[t]), n)
        gap = 0.0 if part == n else float(
            (solo_tf[part, 0, int(out[part])] - solo_tf[part, 0, int(want[part])]).abs())
        res["solo"] = {"prompt": n0, "tokens": n, "equal": int(np.sum(out == want)),
                       "first_difference": part, "tie_gap": gap,
                       "teacher_forced_max_abs_diff": diff}
        print(f"{name} request {row} ({n0} prompt tokens) alone against the batch: "
              f"{res['solo']}", flush=True)
        upto = ("the end" if part == n else
                f"a tie ({gap:.4f} <= 2 x {diff:.4f}, the bf16 teacher-forced difference)")
        require(gap <= 2 * diff, f"{name}: request {row} served alone gives the batch's "
                                 f"tokens ({part} of {n}) up to {upto}")
        del logits, solo_tf
        logits, cache = lm.lm_prefill(params, cfg, {"tokens": toks_t, **frames}, max_seq,
                                      cache_dtype=torch.float32, prompt_lens=lens)
    section("check")

    # -- a decode step's wall, busy share, kernels and operator calls
    cur = logits.argmax(-1).to(torch.int32)
    depth = torch.from_numpy(lens_np).to(dev)

    def decode_step():
        out, _ = lm.serve_step(params, cfg, cache, cur, depth)
        torch.argmax(out, -1).cpu()

    for _ in range(2):
        decode_step()
    res["decode_profile"] = profile_lm_steps(decode_step, FRONT_PROFILE_STEPS)
    print(f"{name} decode step profile ({len(lens_np)} slots at depths {lens_np.tolist()}): "
          f"{res['decode_profile']}; {smi}", flush=True)
    del cache, logits, head
    gc.collect()
    torch.cuda.empty_cache()
    section("profile")

    # -- training at full width, seeded frontend inputs
    batch_n, seq = FRONT_TRAIN[name]
    n_front = seq if enc else cfg.frontend_seq
    rng = np.random.default_rng(0)
    opt_cfg = AdamConfig(lr=LM_TRAIN_LR, grad_clip=1.0)

    def batch():
        b = launch.make_batch(rng, cfg, batch_n, seq, dev)
        b.update(frontend_inputs(cfg, batch_n, n_front, int(rng.integers(1 << 30)), dev))
        return b

    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = launch.loss_and_grads(params, cfg, batch())
    g = flat(grads)
    require(all(bool(torch.isfinite(t).all()) for t in g.values())
            and bool(torch.isfinite(loss)),
            f"{name}: every one of {len(g)} gradients is finite on the card "
            f"(loss {float(loss):.4f})")
    want = ["frontend_proj", "layers/wq", "layers/wo", "layers/w_down"] + (
        ["layers/ln_x", "layers/xwq", "layers/xwk", "layers/xwv", "layers/xwo",
         "enc_layers/wq", "enc_layers/w_down", "enc_norm"] if enc else [])
    moved = [k for k in want if float(g[k].float().abs().max()) > 0]
    require(moved == want, f"{name}: nonzero gradients of {want} ({moved})")
    del grads, g
    opt = launch.adam_init_tree(params)
    params, opt, loss = launch.train_step(params, opt, batch(), cfg, opt_cfg)   # warm-up
    float(loss)
    losses, step_s = [], []
    for _ in range(FRONT_TRAIN_STEPS):
        b = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = launch.train_step(params, opt, b, cfg, opt_cfg)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(fa.LAUNCHES["flash_attention"] == 0, f"{name}: no kernel-5 launch in training")
    require(all(np.isfinite(losses)), f"{name}: {FRONT_TRAIN_STEPS} finite losses")
    require(peak <= FRONT_PEAK_LIMIT, f"{name}: training peak {peak / 1e9:.2f} GB <= "
                                      f"{FRONT_PEAK_LIMIT / 1e9:.0f} GB")
    med = statistics.median(step_s)
    tokens = batch_n * seq
    res["train"] = {"batch": batch_n, "seq": seq, "frontend": n_front, "losses": losses,
                    "step_s": step_s, "median_s": med, "tokens_per_s": tokens / med,
                    "max_memory_allocated": peak}
    print(f"{name} training: {FRONT_TRAIN_STEPS} steps of {batch_n} x ({n_front} "
          f"{'frames' if enc else 'image tokens'} + {seq} tokens) after a warm-up, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; step median {med:.4f} s, "
          f"{tokens / med:.1f} tokens/s; peak {peak / 1e9:.2f} GB; {smi}", flush=True)
    del params, opt, b
    gc.collect()
    torch.cuda.empty_cache()
    section("train")

    # -- card against CPU: one loss and its gradients, LM_CPU_LAYERS layers, f32
    cfg2 = dataclasses.replace(cfg, num_layers=LM_CPU_LAYERS, param_dtype="float32",
                               encoder_layers=LM_CPU_LAYERS if enc else 0,
                               frontend_seq=0 if enc else FRONT_CPU_IMAGE)
    p_card = lm.init_lm(torch.Generator(device=dev).manual_seed(1), cfg2)
    p_cpu = tree_map(lambda t: t.cpu(), p_card)
    b_card = launch.make_batch(np.random.default_rng(1), cfg2, 1, LM_CPU_SEQ, dev)
    b_card.update(frontend_inputs(cfg2, 1, LM_CPU_SEQ if enc else FRONT_CPU_IMAGE, 2, dev))
    l_card, g_card = launch.loss_and_grads(p_card, cfg2, b_card)
    l_cpu, g_cpu = launch.loss_and_grads(p_cpu, cfg2, {k: v.cpu() for k, v in b_card.items()})
    g_card, g_cpu = flat(g_card), flat(g_cpu)
    grad_err = max(float((g_card[k].cpu() - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                   for k, g in g_cpu.items())
    res["cpu_check"] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
                        "grad_err": grad_err}
    print(f"{name} card vs CPU, loss and gradients at full width, {LM_CPU_LAYERS} layers"
          + (f" and {LM_CPU_LAYERS} encoder layers" if enc else
             f", {FRONT_CPU_IMAGE} image tokens")
          + f", f32, 1 x {LM_CPU_SEQ}: {res['cpu_check']}", flush=True)
    require(abs(float(l_card) - float(l_cpu)) <= LM_CPU_LOSS_RTOL * abs(float(l_cpu)),
            f"{name}: loss on the card {float(l_card):.7f} == CPU {float(l_cpu):.7f} "
            f"(rtol {LM_CPU_LOSS_RTOL})")
    require(grad_err <= LM_CPU_GRAD_RTOL, f"{name}: every gradient on the card == CPU "
                                          f"(worst {grad_err:.2e} of its tensor's max <= "
                                          f"{LM_CPU_GRAD_RTOL})")
    del p_card, p_cpu, g_card, g_cpu
    gc.collect()
    torch.cuda.empty_cache()
    section("cpu_check")
    return res


def frontend_lm_path(dev, smi: str) -> dict:
    """The VLM and encoder-decoder families at full width (see
    FRONT_ARCHS): kernel 5 against its plain version and timed at their
    shapes, then each family (:func:`frontend_family`).  Returns the
    readings and kernel 5's launches on the path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    vcfg, scfg = (get_config(n) for n in FRONT_ARCHS)
    t0 = time.perf_counter()
    worst = max([
        group_attention_checks(dev, vcfg, ((1, vcfg.frontend_seq + VLM_IMAGE_PROMPT),),
                               CHECK_KV_LENS, LM_MAX_SEQ, (None,), 10, vcfg.name),
        group_attention_checks(dev, scfg, ((FRONT_REQUESTS, ENC_PROMPTS[-1]),),
                               CHECK_KV_LENS, LM_MAX_SEQ, (None,), 11,
                               f"{scfg.name} decoder"),
        group_attention_checks(dev, scfg, ((FRONT_REQUESTS, ENC_FRAMES),) + ENC_CROSS, None,
                               ENC_DECODE_KEYS[0], (None,), 12,
                               f"{scfg.name} encoder and cross", causal=False)]
        + [group_attention_checks(dev, scfg, (), None, keys, (None,), 13 + i,
                                  f"{scfg.name} cross", causal=False)
           for i, keys in enumerate(ENC_DECODE_KEYS[1:])])
    timings = group_attention_timings(dev, scfg, ENC_FRAMES, ENC_FRAMES, None, smi, None, 14,
                                      f"{scfg.name} encoder / cross", causal=False)
    res = {"attention": {"launches": 0, "variants": dict.fromkeys(fa.VARIANTS, 0),
                         "max_abs_err": worst, "timings": {scfg.name: timings}},
           "launches_by_run": {}, "seconds": {"kernel5": time.perf_counter() - t0}}
    for name in FRONT_ARCHS:
        t0 = time.perf_counter()
        r = frontend_family(dev, name, smi)
        res[name] = r
        res["seconds"][name] = time.perf_counter() - t0
        res["attention"]["launches"] += r["attention"]["launches"]
        for k, n in r["attention"]["variants"].items():
            res["attention"]["variants"][k] += n
        res["launches_by_run"][name] = r["launches_by_run"]
    print(f"VLM and encoder-decoder phase seconds: {res['seconds']}", flush=True)
    print(json.dumps({"frontend_lm": res}, default=str), flush=True)
    return res


def _as_bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def deciding_l1_near_e(sample: np.ndarray, e: float, dev, max_ulp: int = 2) -> list:
    """Where the card's and the CPU's searches of one sample end apart: the
    tolerances t0 * 2^k (k = -8..8) both searches can reach, the L1 each
    device gives there, and every k where the two decide ``l1 <= e``
    differently.  Returns those [(k, l1 on the card, l1 on the CPU)] and
    fails unless there is one and each of its L1s lies within ``max_ulp``
    ulp of ``e``."""
    from repro_torch.compression import FixedAccuracyCodec
    from repro_torch.core.tolerance import C_D
    codec = FixedAccuracyCodec()
    e32 = np.float32(e)
    t0 = (np.float32(16.0) * e32) * (np.float32(1.0) / np.float32(C_D[2]))
    ts = np.array([t0 * np.float32(2.0 ** k) for k in range(-8, 9)], np.float32)
    xs = np.repeat(sample[None], len(ts), axis=0)
    l1 = {}
    for where in (dev, torch.device("cpu")):
        x = torch.from_numpy(xs).to(where)
        l1[where.type], _ = codec.stats(codec.precompute(x), torch.from_numpy(ts).to(where))
    card, cpu = l1[dev.type].cpu().numpy(), l1["cpu"].numpy()
    flips = [(k, float(a), float(b)) for k, a, b in zip(range(-8, 9), card, cpu)
             if (a <= e32) != (b <= e32)]
    ulp = float(np.spacing(e32))
    require(bool(flips) and all(abs(a - e32) <= max_ulp * ulp and abs(b - e32) <= max_ulp * ulp
                                for _, a, b in flips),
            f"the card's and the CPU's searches part where an L1 lies within {max_ulp} ulp "
            f"of e ({flips})")
    return flips


def ensemble_gather_check(data, cond, idx_np: np.ndarray, what: str) -> None:
    """One ensemble step's gather on the card: ``DeviceEnsembleSource.gather``
    of (M, B) indices from one shared store or per-member stores (padded and
    stacked), bit for bit against the plain gathered decode (CPU) of the
    same arrays at the same offset indices, and against each member's store
    decoding its own row of indices."""
    from repro_torch.kernels import ref
    from repro_torch.train.source import make_ensemble_source
    source = make_ensemble_source(data, cond)
    idx = source.fetch(idx_np)
    _, got = source.gather(idx)
    st = source.store
    flat = (idx if source.offsets is None else idx + source.offsets).reshape(-1)
    rows = [a[flat].cpu() for a in (st.payload, st.emax, st.nplanes)]
    want = ref.zfp_decode_blocks_fa_gather_ref(*rows, torch.arange(flat.numel()),
                                               st.padded_shape, st.shape)
    stores = data if isinstance(data, list) else [data] * idx.shape[0]
    own = [same_bits(got[m], s.decode_indices(idx[m])) for m, s in enumerate(stores)]
    require(same_bits(got.reshape(want.shape), want) and all(own),
            f"{what}: one step's gather of {tuple(idx.shape)} indices from "
            f"{tuple(st.payload.shape)} words == the plain gathered decode of the same "
            f"arrays and each member's own store decode, bit for bit (per member {own})")


# cuDNN's layout changes: its generic transposes (around grouped NCHW
# convolutions) and its NCHW <-> NHWC conversions
LAYOUT_KERNELS = ("genericTranspose", "nchwToNhwc", "nhwcToNchw")


def device_time(prof, per: int):
    """(device busy ms per unit, the share of the kernels' time in cuDNN's
    layout changes, ``LAYOUT_KERNELS``) from a torch.profiler run over
    ``per`` units; (None, None) where it recorded no device time."""
    from torch.autograd import DeviceType
    events = [e for e in profile_rows(prof)
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in events)
    if not total:
        return None, None
    layout = sum(e.self_device_time_total for e in events
                 if any(k in e.key for k in LAYOUT_KERNELS))
    return device_busy_us(prof) / 1e3 / per, layout / total


def profile_fleet(engine, cond_np: np.ndarray, fleet, cfg, steps: int = 10) -> dict:
    """Time 2 * ``steps`` serving fleet steps one by one (condition upload,
    the member-folded forward of every member, mean and width, read back: the
    read back syncs) and trace ``steps`` more with torch.profiler; beside
    them the same work with the members run one after another through one
    skeleton.  Prints both profiles and returns per way the median ms
    (profiler off), the wall ms, kernels, device busy ms and share with
    the profiler on, and the share of device time in cuDNN's layout
    changes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.surrogate import functional_forward, init_surrogate, member_params
    skeleton = init_surrogate(cfg, 0, engine.device)
    members = [member_params(fleet, m) for m in range(engine.num_members)]

    def loop_step():
        cond = torch.from_numpy(cond_np).to(engine.device)
        with torch.inference_mode():
            preds = torch.stack([functional_forward(skeleton, p, cond) for p in members])
            mean = preds.mean(dim=0)
            width = 2.0 * engine.sigmas * preds.std(dim=0, correction=0)
        return mean.cpu().numpy(), width.cpu().numpy()

    out = {}
    for way, step in (("folded", lambda: engine._step(cond_np)), ("loop", loop_step)):
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times = []
        for _ in range(2 * steps):
            t0 = time.perf_counter()
            step()
            times.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / steps
        print(f"fleet step, {engine.num_members} members "
              f"{'member-folded' if way == 'folded' else 'one after another'}: median "
              f"{statistics.median(times):.3f} ms over {2 * steps} steps (profiler off);",
              end=" ")
        kernels = print_profile(prof, wall_ms, steps, "step")
        busy_ms, layout = device_time(prof, steps)
        out[way] = {"median_ms": statistics.median(times), "wall_ms": wall_ms,
                    "kernels": kernels, "busy_ms": busy_ms,
                    "busy_share": None if busy_ms is None else busy_ms / wall_ms,
                    "layout_share": layout}
    return out


def surrogate_serving_path(dev, samples: np.ndarray, cond: np.ndarray, cfg, store,
                           fleet) -> dict:
    """Serve the certification phase's fleet (``fleet``: stacked state dict
    on the card) with ``SurrogateServeEngine``: closed loop, lockstep and
    open loop at half the closed loop's queries/s, each checked; the fleet
    step against its members and against a CPU copy; one traced run of the
    closed-loop serve, ``TRACE_STEPS`` device-resident steps and
    ``TRACE_STEPS`` host-streaming steps with the prefetch worker, its spans
    checked and summarised by ``tools/trace_report.py``.  Returns
    {"launches": kernel launches of the traced training runs, "qps",
    "fleet_ms"}."""
    from repro_torch.core.ensemble import init_ensemble
    from repro_torch.core.variability import compute_band
    from repro_torch.data import ShardedCompressedStore, channels_last
    from repro_torch.kernels import zfp_codec
    from repro_torch.models.surrogate import (SurrogateConfig, functional_forward,
                                              init_surrogate, member_params)
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import get_registry
    from repro_torch.serving import SurrogateServeEngine
    from repro_torch.serving.loadgen import latency_percentiles, surrogate_workload
    from repro_torch.sim.solver import PARAM_DIM
    from repro_torch.train.loop import TrainConfig, train_surrogate

    launches = {k: 0 for k in zfp_codec.LAUNCHES}
    members = int(next(iter(fleet.values())).shape[0])
    shape = (cfg.height, cfg.width, cfg.fields)

    def engine(params=fleet, config=cfg, device=DEV):
        return SurrogateServeEngine(params, config, batch_slots=SERVE_SLOTS,
                                    sigmas=SERVE_SIGMAS, device=device)

    def queries(rate=None):
        return surrogate_workload(PARAM_DIM, SERVE_QUERIES, rollout_lens=SERVE_ROLLOUTS,
                                  rate_qps=rate, seed=0)

    def serve(mode, rate=None):
        eng, qs = engine(), queries(rate)
        t0 = time.perf_counter()
        done = getattr(eng, mode)(qs)
        wall = time.perf_counter() - t0
        pct = latency_percentiles(done)
        print(f"surrogate {mode}{'' if rate is None else f' open loop at {rate:.1f} q/s'}: "
              f"{len(done)} queries, {eng.stats['steps']} fleet steps in {wall:.3f} s "
              f"({len(done) / wall:.1f} queries/s wall, {eng.queries_per_second:.1f} "
              f"queries/s of step time), p50 {1e3 * pct['p50']:.3f} ms, p99 "
              f"{1e3 * pct['p99']:.3f} ms, slot utilisation {eng.slot_utilization:.3f}",
              flush=True)
        require(len(done) == SERVE_QUERIES and all(
            q.mean.shape == q.width.shape == (q.steps,) + shape
            and bool(np.isfinite(q.mean).all()) and bool(np.isfinite(q.width).all())
            and bool((q.width >= 0).all()) for q in done),
            f"surrogate {mode}: every query returns finite (T, 96, 32, 6) mean and "
            f"width >= 0")
        return eng, qs, wall, pct

    engine().run(queries()[:SERVE_SLOTS])      # warm-up: allocator, cuDNN's choice
    closed_eng, closed_q, closed_wall, closed_pct = serve("run")
    lock_eng, lock_q, _, lock_pct = serve("run_lockstep")
    worst_m = max(float(np.abs(a.mean - b.mean).max()) for a, b in zip(closed_q, lock_q))
    worst_w = max(float(np.abs(a.width - b.width).max()) for a, b in zip(closed_q, lock_q))
    require(worst_m <= SERVE_ATOL and worst_w <= 4 * SERVE_SIGMAS * SERVE_ATOL,
            f"run == run_lockstep per query (mean {worst_m:.2e} <= {SERVE_ATOL}, width "
            f"{worst_w:.2e} <= {4 * SERVE_SIGMAS * SERVE_ATOL:.0e})")
    rate = 0.5 * SERVE_QUERIES / closed_wall
    _, _, open_wall, open_pct = serve("run", rate)

    # the counts are the CPU engine's on the same queries (they depend on
    # the rollouts and slots alone, so a narrow fleet serves for them)
    narrow = SurrogateConfig(height=32, width=16, base_channels=32)
    cpu_eng = engine(init_ensemble(narrow, range(members), "cpu"), narrow, "cpu")
    cpu_eng.run(queries())
    require(cpu_eng.stats["steps"] == closed_eng.stats["steps"]
            and cpu_eng.stats["field_evals"] == closed_eng.stats["field_evals"]
            and cpu_eng.slot_utilization == closed_eng.slot_utilization,
            f"closed-loop steps {closed_eng.stats['steps']}, field evaluations "
            f"{closed_eng.stats['field_evals']} and slot utilisation "
            f"{closed_eng.slot_utilization:.4f} == the CPU engine's "
            f"({cpu_eng.stats['steps']}, {cpu_eng.stats['field_evals']}, "
            f"{cpu_eng.slot_utilization:.4f})")
    # the first queries served on the CPU from a CPU copy of the fleet
    cpu_q = queries()[:SERVE_CPU_QUERIES]
    engine({k: v.cpu() for k, v in fleet.items()}, cfg, "cpu").run(cpu_q)
    worst_m = max(float(np.abs(a.mean - b.mean).max()) for a, b in zip(cpu_q, closed_q))
    worst_w = max(float(np.abs(a.width - b.width).max()) for a, b in zip(cpu_q, closed_q))
    require(worst_m <= SERVE_ATOL and worst_w <= 4 * SERVE_SIGMAS * SERVE_ATOL,
            f"the first {SERVE_CPU_QUERIES} queries on the card == on the CPU (mean "
            f"{worst_m:.2e} <= {SERVE_ATOL}, width {worst_w:.2e})")
    # one full batch: the fleet step against each member's own forward
    cond_np = np.stack([np.concatenate([q.params_vec, q.times[:1]])
                        for q in closed_q[:SERVE_SLOTS]]).astype(np.float32)
    cond_b = torch.from_numpy(cond_np).to(dev)
    mean, width = closed_eng.fleet_step(cond_b)
    skeleton = init_surrogate(cfg, 0, dev)
    with torch.inference_mode():
        preds = [functional_forward(skeleton, member_params(fleet, m), cond_b).cpu().numpy()
                 for m in range(members)]
    band = compute_band(preds, sigmas=SERVE_SIGMAS)
    err_m = float(np.abs(mean.cpu().numpy() - band.mean).max())
    err_w = float(np.abs(width.cpu().numpy() - (band.hi - band.lo)).max())
    print(f"fleet step vs each member's own forward: mean max err {err_m:.3e}, width "
          f"(hi - lo of compute_band) max err {err_w:.3e}; band width mean "
          f"{float(width.mean()):.4f}", flush=True)
    require(err_m <= SERVE_ATOL and err_w <= 4 * SERVE_SIGMAS * SERVE_ATOL,
            f"fleet step == the members' own forwards through compute_band (mean "
            f"{err_m:.2e} <= {SERVE_ATOL}, width {err_w:.2e})")
    prof = profile_fleet(closed_eng, cond_np, fleet, cfg)

    # one traced run: serve, device-resident steps, host-streaming steps
    reg = get_registry()
    step_hist = reg.histogram("train.dispatch_seconds")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trace_")
    tracer = obs_trace.configure(tmp.name, run="surrogate_serving")
    try:
        traced_eng = engine()
        traced_eng.run(queries())
        served = tracer.events()
        n = BATCH * TRACE_STEPS
        tols = np.full(n, TOLERANCE, np.float32)
        runs = {}
        for name, make, prefetch in (
                ("device-resident", lambda: store, 0),
                ("host-streaming sharded", lambda: ShardedCompressedStore(
                    samples[:n], tols, shard_size=SHARD_SIZE, device=DEV), 2)):
            step_hist.reset()
            first = len(tracer.events())
            compile_s = reg.gauge("train.compile_seconds")

            def run():
                return train_surrogate(
                    cfg, TrainConfig(epochs=1, batch_size=BATCH, lr=LR, seed=0,
                                     log_every=5, max_steps=TRACE_STEPS,
                                     prefetch=prefetch),
                    cond, make(), target_transform=channels_last, device=DEV)

            _, got = count_launches(launches, run)
            evs = tracer.events()[first:]
            runs[name] = evs
            compiles = [e for e in evs if e["name"] == "train.compile"]
            steps = [e for e in evs if e["name"] == "train.step"]
            print(f"traced {name} run: {len(steps)} steps, first step "
                  f"{1e3 * compile_s.value:.3f} ms (train.compile_seconds), steady "
                  f"median {1e3 * step_hist.percentile(50):.3f} ms over "
                  f"{step_hist.count} steps (train.dispatch_seconds, dispatch without "
                  f"a sync); launches {got}", flush=True)
            require(len(compiles) == 1 and len(steps) == TRACE_STEPS
                    and step_hist.count == TRACE_STEPS - 1,
                    f"{name}: train.compile once ({len(compiles)}), {TRACE_STEPS} "
                    f"train.step spans ({len(steps)}), train.dispatch_seconds count "
                    f"{step_hist.count} == {TRACE_STEPS - 1}")
        events = tracer.events()
    finally:
        paths = obs_trace.shutdown()
    try:
        count = lambda evs, name: sum(1 for e in evs if e["name"] == name)
        require(count(served, "surrogate_serve.query") == SERVE_QUERIES
                and count(served, "surrogate_serve.fleet_step")
                == traced_eng.stats["steps"],
                f"one surrogate_serve.query span per query "
                f"({count(served, 'surrogate_serve.query')}) and one fleet_step span "
                f"per step ({count(served, 'surrogate_serve.fleet_step')} of "
                f"{traced_eng.stats['steps']})")
        host = runs["host-streaming sharded"]
        fetch_tids = {e["tid"] for e in host if e["name"] == "train.fetch"}
        step_tids = {e["tid"] for e in host if e["name"] == "train.step"}
        require(fetch_tids and not fetch_tids & step_tids
                and count(host, "data.get_batch") >= TRACE_STEPS,
                f"train.fetch spans on the prefetch worker's thread, apart from the "
                f"train.step spans, and data.get_batch spans "
                f"({count(host, 'data.get_batch')})")
        require(count(events, "recompile") == 0, "no recompile instant in the traced run")
        out = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"),
                              tmp.name, "--json"], capture_output=True, text=True,
                             timeout=120)
        require(out.returncode == 0, f"tools/trace_report.py reads the trace "
                                     f"(exit {out.returncode}: {out.stderr[-300:]})")
        (report,) = json.loads(out.stdout).values()
        want = {"surrogate_serve.query", "surrogate_serve.fleet_step", "train.step",
                "train.fetch", "data.get_batch"}
        require(want <= set(report["stages"]),
                f"trace_report lists {sorted(want)} (got {sorted(report['stages'])})")
        print("trace_report: " + ", ".join(
            f"{k} {v['count']}x {v['total_s']:.4f} s"
            for k, v in sorted(report["stages"].items())) + f"; written {paths['trace']}",
            flush=True)
    finally:
        tmp.cleanup()
    print(json.dumps({"surrogate_serving": {
        "closed": {"queries_per_s": SERVE_QUERIES / closed_wall,
                   "step_queries_per_s": closed_eng.queries_per_second,
                   "p50_ms": 1e3 * closed_pct["p50"], "p99_ms": 1e3 * closed_pct["p99"],
                   "steps": closed_eng.stats["steps"],
                   "slot_utilization": closed_eng.slot_utilization},
        "lockstep": {"step_queries_per_s": lock_eng.queries_per_second,
                     "p50_ms": 1e3 * lock_pct["p50"], "p99_ms": 1e3 * lock_pct["p99"],
                     "steps": lock_eng.stats["steps"],
                     "slot_utilization": lock_eng.slot_utilization},
        "open": {"rate": rate, "queries_per_s": SERVE_QUERIES / open_wall,
                 "p50_ms": 1e3 * open_pct["p50"], "p99_ms": 1e3 * open_pct["p99"]},
        "fleet_step": prof, "members": members}}))
    return {"launches": launches, "qps": SERVE_QUERIES / closed_wall,
            "fleet_ms": prof["folded"]["median_ms"]}


def count_launches(launches: dict, fn):
    """Run one piece of a path with the codec kernels' counts set to 0 just
    before it; add what it launched to ``launches`` and return (its result,
    its own counts)."""
    from repro_torch.kernels import zfp_codec
    zfp_codec.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(zfp_codec.LAUNCHES)
    for k, v in got.items():
        launches[k] += v
    return out, got


def certification_path(dev, samples: np.ndarray, cond: np.ndarray, cfg, store,
                       single_ms: float) -> dict:
    """Main path steps 5-7 at full width: the seed ensemble against its
    members run one by one, Algorithm 1 fused against unfused on all
    samples (and against the CPU on ``CHECK_SAMPLES``), ``certify_tolerance``
    with device-resident candidate stores, and the ensemble on host-streaming
    sharded stores.  Returns {"launches": kernel launches on these paths,
    "ensemble_ms", "sweep_ms": dispatch medians}.  Launches made by the checks
    (the runs one by one, the CPU comparisons, the stores' bound checks)
    are not counted."""
    import dataclasses
    from repro_torch.core import ensemble as ens_mod
    from repro_torch.core import find_tolerance_batch
    from repro_torch.core.ensemble import BandArtifact, certify_tolerance, train_ensemble
    from repro_torch.data import (DeviceResidentCompressedStore, EnsembleLoader,
                                  ShardAwareLoader, ShardedCompressedStore, channels_last)
    from repro_torch.kernels import zfp_codec
    from repro_torch.models.surrogate import init_surrogate
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import get_registry
    from repro_torch.train.loop import TrainConfig, train_surrogate
    from repro_torch.train.source import make_loader

    launches = {k: 0 for k in zfp_codec.LAUNCHES}
    counted = functools.partial(count_launches, launches)
    hist = get_registry().histogram("ensemble.dispatch_seconds")
    n = len(samples)
    seeds = list(ENS_SEEDS)

    # (1) the ensemble equals its members run one by one
    tc = TrainConfig(epochs=1, batch_size=BATCH, lr=LR, log_every=1, max_steps=ENS_STEPS)

    def loader():
        return EnsembleLoader([make_loader(store, BATCH, seed=s) for s in seeds])

    hist.reset()
    ens, got = counted(lambda: train_ensemble(cfg, tc, cond, store, seeds,
                                              target_transform=channels_last,
                                              loader=loader(), device=DEV))
    ens_ms = 1e3 * hist.percentile(50)
    print(f"seed ensemble ({len(seeds)} members, device-resident): {ens.steps} steps "
          f"{ens.seconds:.3f} s, dispatch median {ens_ms:.3f} ms (steps 2..{ens.steps}; "
          f"single model, phase 4: {single_ms:.3f} ms); launches {got}", flush=True)
    require(ens.steps == ENS_STEPS and all(np.isfinite(l).all() for _, l in ens.losses),
            f"{ENS_STEPS} ensemble steps with finite losses")
    require(got["zfp_decode_blocks_fa"] == ENS_STEPS,
            f"zfp_decode_blocks_fa launched once per ensemble step for all "
            f"{len(seeds)} members ({got['zfp_decode_blocks_fa']} launches, "
            f"{ENS_STEPS} steps)")
    ensemble_gather_check(store, cond, next(iter(loader())),
                          f"{len(seeds)} members on one shared resident store")

    def apart(got_p, got_l, want, want_l, init):
        """How far a run is from the member run alone: the worst relative
        difference of the logged losses; the largest ||got - want|| /
        ||want - init|| over the parameter tensors the run alone moved; the
        max, 99th percentile and median of |got - want| over all of them."""
        loss = float(np.abs(np.asarray(got_l) / np.asarray(want_l) - 1).max())
        rel = max(float((got_p[k] - want[k]).norm() / (want[k] - init[k]).norm())
                  for k in want if bool((want[k] != init[k]).any()))
        d = torch.cat([(got_p[k] - want[k]).abs().flatten() for k in want]).cpu().numpy()
        return loss, rel, float(d.max()), float(np.quantile(d, 0.99)), float(np.median(d))

    members, others = loader(), loader()
    for m, s in enumerate(seeds):
        def alone(member_loader):
            model, losses = train_surrogate(cfg, dataclasses.replace(tc, seed=s), cond,
                                            store, target_transform=channels_last,
                                            loader=member_loader, device=DEV)
            return model.state_dict(), [l for _, l in losses]

        want, want_l = alone(members.loaders[m])
        init = init_surrogate(cfg, s, dev).state_dict()
        loss, rel, mx, q99, med = apart(ens.member_params(m), [l[m] for _, l in ens.losses],
                                        want, want_l, init)
        # planted fault: member m's seed trained on the next member's batches
        f_loss, f_rel, f_mx, f_q99, f_med = apart(
            *alone(others.loaders[(m + 1) % len(seeds)]), want, want_l, init)
        print(f"member {m} (seed {s}) against its run alone: losses worst rel {loss:.3e}, "
              f"params rel {rel:.3e}, max {mx:.3e}, 99th {q99:.3e}, median {med:.3e}; "
              f"planted fault (member {(m + 1) % len(seeds)}'s batches): losses {f_loss:.3e}, "
              f"params rel {f_rel:.3e}, max {f_mx:.3e}, 99th {f_q99:.3e}, median "
              f"{f_med:.3e}", flush=True)
        require(loss <= ENS_LOSS_RTOL and rel < ENS_PARAM_REL and mx < ENS_PARAM_MAX
                and q99 < ENS_PARAM_Q99 and med < ENS_PARAM_MEDIAN,
                f"ensemble member {m} (seed {s}) == its run alone: losses worst rel "
                f"{loss:.2e} <= {ENS_LOSS_RTOL}; params rel {rel:.2e} < {ENS_PARAM_REL}, "
                f"max {mx:.2e} < {ENS_PARAM_MAX}, 99th {q99:.2e} < {ENS_PARAM_Q99}, "
                f"median {med:.2e} < {ENS_PARAM_MEDIAN}")
        require(f_loss > ENS_LOSS_RTOL and f_rel > ENS_PARAM_REL,
                f"a member fed another member's batches fails both limits: losses "
                f"{f_loss:.2e} > {ENS_LOSS_RTOL}, params rel {f_rel:.2e} > {ENS_PARAM_REL}")

    # (2) Algorithm 1 on every sample: fused (plain PyTorch stats) == unfused
    # (kernels 2 + 1), bit for bit; the card against the CPU on CHECK_SAMPLES
    e = float(np.mean(ens.losses[-1][1]))
    es = np.full(n, e, np.float32)
    t0 = time.perf_counter()
    fused, got_f = counted(lambda: find_tolerance_batch(samples, es, device=DEV))
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unfused, got_u = counted(lambda: find_tolerance_batch(samples, es, fused=False,
                                                          device=DEV))
    unfused_s = time.perf_counter() - t0
    print(f"Algorithm 1 on {n} samples at e = {e:.7f}: fused {fused_s:.3f} s (launches "
          f"{got_f}), unfused {unfused_s:.3f} s (launches {got_u}); max iterations "
          f"{int(fused.iterations.max())}, iteration counts "
          f"{ {int(k): int(v) for k, v in zip(*np.unique(fused.iterations, return_counts=True))} }, "
          f"median tolerance {float(np.median(fused.tolerance)):.6g}, median ratio "
          f"{float(np.median(fused.ratio)):.4f}", flush=True)
    for field in ("tolerance", "compression_l1", "ratio", "iterations"):
        require(np.array_equal(_as_bits(getattr(fused, field)),
                               _as_bits(getattr(unfused, field))),
                f"Algorithm 1 fused == unfused bit for bit: {field} of {n} samples")
    require(got_u["zfp_encode_blocks_fa"] > 0 and got_u["zfp_decode_blocks_fa"] > 0,
            "the unfused search ran kernels 2 and 1")
    cpu = find_tolerance_batch(samples[:CHECK_SAMPLES], es[:CHECK_SAMPLES], device="cpu")
    apart = [i for i in range(CHECK_SAMPLES)
             if fused.tolerance[i] != cpu.tolerance[i]
             or fused.iterations[i] != cpu.iterations[i]]
    for i in apart:
        deciding_l1_near_e(samples[i], e, dev)
    keep = np.setdiff1d(np.arange(CHECK_SAMPLES), apart)
    require(all(np.array_equal(_as_bits(getattr(fused, f)[:CHECK_SAMPLES][keep]),
                               _as_bits(getattr(cpu, f)[keep]))
                for f in ("tolerance", "compression_l1", "ratio", "iterations")),
            f"Algorithm 1 on the card == the CPU plain path on {CHECK_SAMPLES} samples "
            f"(bit for bit; {len(apart)} apart, each where an L1 lies within 2 ulp of e)")

    # (3) certification end to end: device-resident candidate stores
    fields_cl = np.ascontiguousarray(samples.transpose(0, 2, 3, 1))
    builds, runs = [], []
    from_samples = DeviceResidentCompressedStore.from_samples
    real_train = ens_mod.train_ensemble

    def recording_build(*a, **k):
        t0 = time.perf_counter()
        st = from_samples(*a, **k)
        torch.cuda.synchronize()
        builds.append((st, time.perf_counter() - t0))
        return st

    def timed_train(*a, **k):
        hist.reset()
        res = real_train(*a, **k)
        runs.append((res.num_members, res.steps, 1e3 * hist.percentile(50)))
        return res

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cert_")
    tracer = obs_trace.configure(run="certify")
    try:
        with mock.patch.object(DeviceResidentCompressedStore, "from_samples",
                               staticmethod(recording_build)), \
                mock.patch.object(ens_mod, "train_ensemble", timed_train):
            t0 = time.perf_counter()
            res, got_c = counted(lambda: certify_tolerance(
                cfg, TrainConfig(epochs=CERT_EPOCHS, batch_size=BATCH, lr=LR,
                                 log_every=1),
                cond, fields_cl, eval_conditions=cond[:EVAL_SAMPLES],
                eval_targets=fields_cl[:EVAL_SAMPLES], seeds=seeds,
                multiples=CERT_MULTIPLES, shard_size=SHARD_SIZE, device_resident=True,
                artifact_dir=tmp.name, device=DEV))
            cert_s = time.perf_counter() - t0
        spans = {ev["name"]: ev for ev in tracer.events() if ev["ph"] == "X"}
        back = BandArtifact.load(tmp.name)
        require(back.seeds == seeds and set(back.trajectories) == set(res.band.trajectories)
                and all(np.array_equal(back.trajectories[k], v)
                        for k, v in res.band.trajectories.items()),
                "BandArtifact.load reads back the saved band")
        require(os.path.exists(os.path.join(tmp.name, "certification.json")),
                "certification.json written")
    finally:
        obs_trace.shutdown(write=False)
        tmp.cleanup()
    summary = res.summary()
    print(f"certify_tolerance: {cert_s:.3f} s; spans (s): " + ", ".join(
        f"{k} {spans[k]['dur']:.3f}" for k in ("certify.seed_ensemble", "certify.algorithm1",
                                              "certify.build_stores", "certify.lossy_sweep")
        if k in spans) + f"; Algorithm 1 max iterations "
          f"{spans['tolerance.search_batch']['args'].get('max_iterations')}; launches {got_c}")
    require(len(runs) == 2, f"certification trained two ensembles ({len(runs)})")
    (n_raw, steps_raw, raw_ms), (n_sweep, steps_sweep, sweep_ms) = runs
    print(f"dispatch medians: seed ensemble ({n_raw} members, raw store) {raw_ms:.3f} ms "
          f"over {steps_raw} steps, lossy sweep ({n_sweep} candidates, one stacked "
          f"resident payload) {sweep_ms:.3f} ms over {steps_sweep} steps; single model's "
          f"step (phase 4) {single_ms:.3f} ms")
    stores = [st for st, _ in builds]
    wmax = max(int(st.payload.shape[-1]) for st in stores)
    stacked = len(stores) * n * stores[0].nb * (wmax + 2) * 4
    print("candidate stores: " + "; ".join(
        f"x{m:g} build {sec:.3f} s, width {st.payload.shape[-1]}, ratio {st.ratio:.4f}"
        for m, (st, sec) in zip(CERT_MULTIPLES, builds)) +
        f"; stacked sweep payload resident {stacked} bytes ({stacked / 1e6:.1f} MB)")
    print("certification summary: " + json.dumps(summary))
    mb = res.max_benign
    print(f"certification verdict: model L1 e = {res.model_l1_error:.7f}; max benign "
          f"multiple {None if mb is None else mb.multiple}, ratio "
          f"{None if mb is None else round(mb.ratio, 4)}; per candidate " + ", ".join(
              f"x{c.multiple:g} {'benign' if c.benign else 'degraded'}"
              for c in res.candidates), flush=True)
    # the ratio grows with the multiple until every block keeps zero planes
    # (headers only: 2 bytes a block)
    ratios = [c.ratio for c in res.candidates]
    headers_only = samples[0].nbytes / (2 * stores[0].nb)
    require([c.multiple for c in res.candidates] == list(CERT_MULTIPLES)
            and all(b > a or a >= headers_only for a, b in zip(ratios, ratios[1:])),
            f"the ratio grows with the multiple ({[round(r, 4) for r in ratios]}; "
            f"headers only {headers_only:g})")
    require(steps_raw == steps_sweep == CERT_EPOCHS * (n // BATCH),
            f"seed ensemble and sweep ran {CERT_EPOCHS} epochs ({steps_raw}, "
            f"{steps_sweep} steps)")
    require(got_c["zfp_encode_blocks_fa"] >= len(CERT_MULTIPLES)
            and got_c["zfp_decode_blocks_fa"] >= steps_sweep,
            "certification encoded every candidate store (kernel 2) and decoded every "
            "sweep step (kernel 1)")
    for m, st in zip(CERT_MULTIPLES, stores):
        require(np.array_equal(st.tolerances, res.base_tolerances * np.float32(m)),
                f"x{m:g} store holds the base tolerances times {m:g}")
        within, worst = True, 0.0
        for i in range(0, n, 256):
            idx = torch.arange(i, min(i + 256, n), device=dev)
            err = (st.decode_indices(idx) - torch.from_numpy(samples[i:i + 256]).to(dev))
            err = err.abs().amax(dim=(1, 2, 3)).cpu().numpy()
            within &= bool((err <= st.tolerances[i:i + 256]).all())
            worst = max(worst, float((err / st.tolerances[i:i + 256]).max()))
        require(within, f"x{m:g} store decodes within its per-sample L-inf "
                        f"tolerances (worst error / tolerance {worst:.4f})")
    sweep_idx = next(iter(EnsembleLoader([
        ShardAwareLoader(n, BATCH, SHARD_SIZE, seed=seeds[0]) for _ in stores])))
    ensemble_gather_check(stores, cond, sweep_idx,
                          f"the sweep's {len(stores)} candidate stores, stacked")
    sweep_stores = stores
    del builds, res

    # (4) the ensemble on host-streaming sharded stores (kernel 3 per batch)
    tc_host = dataclasses.replace(tc, prefetch=2)

    def sharded(tol):
        return ShardedCompressedStore(samples, np.full(n, tol, np.float32),
                                      shard_size=SHARD_SIZE, device=DEV)

    def host_run(tols, member_seeds):
        """Build a store per tolerance, then train: one store shared by all
        members, or one store per member."""
        stores = [sharded(t) for t in tols]
        data = stores[0] if len(stores) == 1 else stores
        return stores, train_ensemble(cfg, tc_host, cond, data, member_seeds,
                                      target_transform=channels_last, device=DEV)

    for what, tols, member_seeds in (
            ("one shared sharded store (union fetch)", (TOLERANCE,), seeds),
            ("two per-member sharded stores", (TOLERANCE, 10 * TOLERANCE), [0, 0])):
        hist.reset()
        (stores, run), got_h = counted(lambda: host_run(tols, member_seeds))
        batches = sum(st.stats.batches for st in stores)
        print(f"host ensemble, {what}: {run.steps} steps, dispatch median "
              f"{1e3 * hist.percentile(50):.3f} ms, {batches} batches read, launches "
              f"{got_h}", flush=True)
        require(run.steps == ENS_STEPS and all(np.isfinite(l).all() for _, l in run.losses),
                f"{ENS_STEPS} finite ensemble steps from {what}")
        require(got_h["zfp_decode_blocks"] == batches >= ENS_STEPS * len(stores),
                f"zfp_decode_blocks decoded every batch from {what} "
                f"({got_h['zfp_decode_blocks']} launches, {batches} batches)")
    print(f"certification path: launches {launches}")
    return {"launches": launches, "ensemble_ms": ens_ms, "sweep_ms": sweep_ms,
            "sweep_stores": sweep_stores, "fleet": ens.params}


# checkpoint path (Queue 1 item 8 with item 5's checkpoints), on the same
# model and device-resident store: a fresh run of CKPT_EPOCHS epochs (102
# steps) saving every CKPT_EVERY steps against a run preempted at
# CKPT_KILL (not a save step) and resumed, under deterministic algorithms
# (and once more without, as a reading); lossy checkpoints of the trained
# state, the rows of benchmarks/checkpoint_io.py:95-140; one step's
# gradients through compressed_psum_tree on a one-rank NCCL group.  The
# residual codec's weights come from a ridge solve whose sums run in
# another order on the card than on the CPU: they are held to
# CKPT_WEIGHTS_ATOL and its restores to CKPT_RESIDUAL_REL of the tolerance
CKPT_EPOCHS, CKPT_EVERY, CKPT_KILL = 2, 20, 50
CKPT_FR_BITS = 13
CKPT_RESIDUAL_TOL = 1e-3
CKPT_WEIGHTS_ATOL = 1e-4
CKPT_RESIDUAL_REL = 1e-2
CKPT_RUN_STEPS, CKPT_RUN_EVERY = 10, 5
GRAD_FA_TOL = 1e-3


def _flat(tree) -> dict:
    from repro_torch.compression import tree_flatten_with_path
    return dict(tree_flatten_with_path(tree)[0])


def _same_trees(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(same_bits(fa[k].cpu(), fb[k].cpu()) for k in fa)


def _max_err(a, b) -> float:
    fa, fb = _flat(a), _flat(b)
    return max(float((fa[k].float().cpu() - fb[k].float().cpu()).abs().max()) for k in fa)


def _same_npz(card: str, cpu: str, what: str) -> None:
    """The .npz the card wrote against the one written from a CPU copy of
    the state: every array bit for bit, the residual codec's weights to
    CKPT_WEIGHTS_ATOL."""
    a = np.load(os.path.join(card, "arrays.npz"))
    b = np.load(os.path.join(cpu, "arrays.npz"))
    require(sorted(a.files) == sorted(b.files), f"{what}: the same arrays on the card and "
                                                f"the CPU ({len(a.files)})")
    worst_w, bad = 0.0, []
    for k in a.files:
        if k.endswith(".zfp/weights"):
            worst_w = max(worst_w, float(np.abs(a[k] - b[k]).max()))
        elif not (a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                  and a[k].tobytes() == b[k].tobytes()):
            bad.append(k)
    zfp = sum(k.endswith(".zfp/payload") for k in a.files)
    raw = sum(".zfp/" not in k for k in a.files)
    require(not bad, f"{what}: the streams of {zfp} compressed leaves and {raw} raw "
                     f"leaves equal the CPU's bit for bit (differ: {bad[:4]})")
    if any(k.endswith(".zfp/weights") for k in a.files):
        require(worst_w <= CKPT_WEIGHTS_ATOL, f"{what}: corrector weights within "
                                              f"{CKPT_WEIGHTS_ATOL} of the CPU's "
                                              f"({worst_w:.3e})")


def checkpoint_path(dev, store, cond: np.ndarray, cfg, smi: str) -> dict:
    """Queue 1 item 8 at full width: exact resume on the card, lossy
    checkpoints of the trained state held to their bounds and to the same
    saves from a CPU copy (plain versions), a certifying save inside
    ``train_surrogate``, the single-field fixed-rate helpers, and one
    step's gradients through ``compressed_psum_tree``.  Returns
    {"launches": kernel launches on these paths, and the numbers}.  The
    CPU copies launch nothing."""
    import torch.distributed as dist
    from repro_torch.compression import get_codec, tree_map
    from repro_torch.core.grad_compress import compressed_psum_tree, tree_collective_bytes
    from repro_torch.data import channels_last
    from repro_torch.kernels import ops, zfp_codec
    from repro_torch.models.surrogate import adam_state_to_jax, l1_loss, params_to_jax
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainConfig, train_surrogate
    from repro_torch.train.optimizer import AdamConfig, adam_init

    launches = {k: 0 for k in zfp_codec.LAUNCHES}
    counted = functools.partial(count_launches, launches)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    root = Path(tmp.name)
    out = {}
    try:
        # -- exact resume, with and without deterministic algorithms --------
        base = dict(epochs=CKPT_EPOCHS, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                    ckpt_every_steps=CKPT_EVERY)
        snaps = []

        def run(name, keep_last_two=False, **kw):
            stamps = []

            def hook(step, model, loss):
                stamps.append(time.perf_counter())
                if keep_last_two:          # parameters after the last two steps
                    cur = [p.detach().clone() for p in model.parameters()]
                    snaps[:] = (snaps[-1:] + [cur])
            tc = TrainConfig(**base, ckpt_dir=str(root / name), **kw)
            (model, losses), got = counted(lambda: train_surrogate(
                cfg, tc, cond, store, hooks=[hook], target_transform=channels_last,
                device=DEV))
            ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
            return model, losses, (statistics.median(ms) if ms else float("nan")), got

        resume = {}
        for det in (True, False):
            torch.use_deterministic_algorithms(det)
            try:
                tag = "det" if det else "nondet"
                fresh, fresh_l, fresh_ms, got_f = run(f"fresh_{tag}", keep_last_two=det)
                _, killed_l, _, _ = run(f"killed_{tag}", max_steps=CKPT_KILL)
                latest = ckpt.latest_checkpoint(str(root / f"killed_{tag}"))
                resumed, res_l, res_ms, _ = run(f"killed_{tag}")
            finally:
                torch.use_deterministic_algorithms(False)
            total = len(fresh_l)
            last_saved = CKPT_KILL - CKPT_KILL % CKPT_EVERY
            same_p = all(same_bits(a.detach(), b.detach()) for a, b in
                         zip(fresh.parameters(), resumed.parameters()))
            want_l = [(s, l) for s, l in fresh_l if s > last_saved]
            same_l = res_l == want_l
            resume[tag] = {"fresh_ms": fresh_ms, "resumed_ms": res_ms, "params": same_p,
                           "losses": same_l, "steps": total}
            print(f"checkpoint resume, deterministic={det}: {total} steps fresh (step "
                  f"median {fresh_ms:.3f} ms, launches {got_f}), preempted at "
                  f"{len(killed_l)}, resumed from {os.path.basename(latest)} for "
                  f"{len(res_l)} steps (median {res_ms:.3f} ms); final params "
                  f"bit-identical {same_p}, post-resume losses bit-identical {same_l}; "
                  f"{smi}", flush=True)
            require(latest.endswith(f"step_{last_saved:010d}"),
                    f"the preempted run's last checkpoint is step {last_saved}")
            require(len(killed_l) == CKPT_KILL and len(res_l) == total - last_saved,
                    f"preempted at {CKPT_KILL}, resumed for {total - last_saved} steps")
            if det:
                require(same_p and same_l, "exact resume on the card: final params and "
                                           "post-resume losses equal the fresh run's bit "
                                           "for bit (deterministic algorithms)")
                model, prev = fresh, snaps[0]
        out["resume"] = resume
        print(f"determinism: step median {resume['det']['fresh_ms']:.3f} ms deterministic, "
              f"{resume['nondet']['fresh_ms']:.3f} ms not; without it resume is "
              f"{'bit-identical' if resume['nondet']['params'] and resume['nondet']['losses'] else 'not bit-identical'}",
              flush=True)

        # -- lossy checkpoints of the trained state ---------------------------
        names = [n for n, _ in model.named_parameters()]
        live = {n: p.detach() for n, p in model.named_parameters()}
        template = {"params": params_to_jax(live),
                    "opt": adam_state_to_jax(adam_init(live, AdamConfig()))}
        final = ckpt.latest_checkpoint(str(root / "fresh_det"))
        (state, _), _ = counted(lambda: ckpt.restore_checkpoint(final, template))
        require(_same_trees(state["params"], template["params"]),
                f"the fresh run's final checkpoint ({os.path.basename(final)}) restores "
                f"its parameters bit for bit")
        prev_j = params_to_jax(dict(zip(names, prev)))
        t0 = time.perf_counter()
        tols, _ = counted(lambda: ckpt.certify_param_tolerances(prev_j, state["params"]))
        certify_s = time.perf_counter() - t0
        fs, fp = _flat(state["params"]), _flat(prev_j)
        disp = {k: float((fs[k] - fp[k]).abs().mean()) for k in tols}
        print(f"certified tolerances ({certify_s:.3f} s, {len(tols)} leaves): " + ", ".join(
            f"{k} {t:.3e} (displacement {disp[k]:.3e})" for k, t in sorted(tols.items())))
        n_big = sum(v.numel() >= ckpt.MIN_LOSSY_SIZE for v in _flat(state["params"]).values())
        require(len(tols) == n_big, f"every leaf of at least {ckpt.MIN_LOSSY_SIZE} values "
                                    f"certified ({len(tols)} of {n_big})")
        cpu_state = tree_map(lambda t: t.cpu(), state)
        rows = [("raw", {}, None),
                (f"fixed_rate{CKPT_FR_BITS}",
                 {"codec": get_codec("fixed_rate", bits_per_value=CKPT_FR_BITS)}, None),
                ("fixed_accuracy_certified",
                 {"codec": get_codec("fixed_accuracy"), "tolerances": {"params": tols}},
                 "per leaf"),
                ("fixed_accuracy_residual",
                 {"codec": get_codec("fixed_accuracy+residual",
                                     tolerance=CKPT_RESIDUAL_TOL)}, 2 * CKPT_RESIDUAL_TOL)]
        table = []
        for name, kw, bound in rows:
            save_s, restore_s = [], []
            for _ in range(2):             # the first call of each pays first-use costs
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path, _ = counted(lambda: ckpt.save_checkpoint(str(root / name), 1, state,
                                                               **kw))
                save_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                (back, meta), got = counted(lambda: ckpt.restore_checkpoint(path, state))
                restore_s.append(time.perf_counter() - t0)
            err = _max_err(back, state)
            ratio = meta["stored_bytes"] / meta["raw_bytes"]
            table.append({"mode": name, "stored_over_raw": ratio, "save_s": save_s,
                          "restore_s": restore_s, "max_err": err, "bound": bound})
            print(f"checkpoint {name}: stored/raw {ratio:.4f} ({meta['stored_bytes']} of "
                  f"{meta['raw_bytes']} bytes), save {save_s[0]:.4f} s (again "
                  f"{save_s[1]:.4f}), restore {restore_s[0]:.4f} s (again "
                  f"{restore_s[1]:.4f}), max restore error {err:.3e} (bound: "
                  f"{'none, the rate is fixed' if name.startswith('fixed_rate') else bound if bound else 0}); "
                  f"restore launches {got}; {smi}", flush=True)
            if name == "raw":
                require(_same_trees(back, state), "raw checkpoint restores bit for bit")
                continue
            fb, fs = _flat(back["params"]), _flat(state["params"])
            if bound == "per leaf":
                worst = max(float((fb[k] - fs[k]).abs().max()) / t for k, t in tols.items())
                require(worst <= 1.0 and _same_trees(back["opt"], state["opt"]),
                        f"certified restore: every certified leaf within its tolerance "
                        f"(worst {worst:.4f} of it), the optimizer state raw and exact")
            elif bound is not None:
                require(err <= bound + 1e-6, f"residual restore within 2 tol ({err:.3e} <= "
                                             f"{bound})")
            # the same save from a CPU copy (plain versions), and each restore
            cpu_path = ckpt.save_checkpoint(str(root / f"{name}_cpu"), 1, cpu_state, **kw)
            _same_npz(path, cpu_path, name)
            cpu_back, _ = ckpt.restore_checkpoint(path, cpu_state)
            if name.endswith("residual"):
                d = _max_err(back, cpu_back)
                require(d <= CKPT_RESIDUAL_REL * CKPT_RESIDUAL_TOL,
                        f"{name}: the card's restore within {CKPT_RESIDUAL_REL} tol of the "
                        f"CPU's ({d:.3e})")
            else:
                require(_same_trees(back, cpu_back), f"{name}: the card's restore equals "
                                                     f"the CPU's bit for bit")
        out["table"] = table

        # -- a certifying save inside train_surrogate --------------------------
        t0 = time.perf_counter()
        (m2, l2), got = counted(lambda: train_surrogate(
            cfg, TrainConfig(epochs=1, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                             max_steps=CKPT_RUN_STEPS, ckpt_every_steps=CKPT_RUN_EVERY,
                             ckpt_dir=str(root / "certifying"),
                             ckpt_codec=get_codec("fixed_accuracy")),
            cond, store, target_transform=channels_last, device=DEV))
        run_s = time.perf_counter() - t0
        latest = ckpt.latest_checkpoint(str(root / "certifying"))
        with open(os.path.join(latest, "manifest.json")) as f:
            meta = json.load(f)
        cert = meta["codec"].get("tolerances", {}).get("params", {})
        live2 = params_to_jax({n: p.detach() for n, p in m2.named_parameters()})
        (back, _), _ = counted(lambda: ckpt.restore_checkpoint(latest, {"params": live2}))
        fb, fl = _flat(back["params"]), _flat(live2)
        worst = max((float((fb[k] - fl[k]).abs().max()) / t for k, t in cert.items()),
                    default=float("inf"))
        print(f"certifying train_surrogate: {CKPT_RUN_STEPS} steps, saves at "
              f"{CKPT_RUN_EVERY}-step intervals, {run_s:.3f} s, launches {got}; "
              f"{len(cert)} certified leaves, stored/raw "
              f"{meta['stored_bytes'] / meta['raw_bytes']:.4f}, worst error "
              f"{worst:.4f} of its tolerance", flush=True)
        require(os.path.basename(latest) == f"step_{CKPT_RUN_STEPS:010d}"
                and len(cert) == n_big and worst <= 1.0,
                f"ckpt_codec=fixed_accuracy certifies {n_big} leaves at each save inside "
                f"train_surrogate, restored within them")

        # -- the single-field fixed-rate helpers (kernels 4 and 3) -------------
        leaf = state["params"]["up0_t"]["w"].reshape(-1, state["params"]["up0_t"]["w"].shape[-1])
        (cf, y), got = counted(lambda: (lambda c: (c, ops.decode_field(c)))(
            ops.encode_field(leaf, CKPT_FR_BITS)))
        ccf = ops.encode_field(leaf.cpu(), CKPT_FR_BITS)
        require(same_bits(cf.payload, ccf.payload) and same_bits(cf.emax, ccf.emax)
                and same_bits(y, ops.decode_field(ccf)),
                f"ops.encode_field/decode_field {tuple(leaf.shape)} at {CKPT_FR_BITS} bits "
                f"equal the CPU's bit for bit (launches {got})")

        # -- one step's gradients through compressed_psum_tree ------------------
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(str(root / "pg"), 1),
                                rank=0, world_size=1)
        try:
            cpu_group = dist.new_group(backend="gloo")
            t0 = time.perf_counter()
            dist.all_reduce(torch.zeros(1, device=dev))   # the communicator starts here
            torch.cuda.synchronize()
            print(f"process group: {dist.get_backend()}, first all_reduce "
                  f"{1e3 * (time.perf_counter() - t0):.1f} ms", flush=True)
            idx = torch.arange(BATCH, device=dev)
            model.zero_grad(set_to_none=True)
            l1_loss(model, torch.from_numpy(cond[:BATCH]).to(dev),
                    channels_last(store.decode_indices(idx))).backward()
            grads = params_to_jax({n: p.grad.detach() for n, p in model.named_parameters()})
            model.zero_grad(set_to_none=True)
            cpu_grads = tree_map(lambda t: t.cpu(), grads)
            raw_b, _ = tree_collective_bytes(grads, None)
            grad_rows = []
            for name, codec in (("fixed_rate8", 8), ("fixed_rate16", 16),
                                ("fixed_accuracy",
                                 get_codec("fixed_accuracy", tolerance=GRAD_FA_TOL))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (mean, res), got = counted(lambda: compressed_psum_tree(grads, None, codec))
                psum_ms = 1e3 * (time.perf_counter() - t0)
                fg, fm, fr = _flat(grads), _flat(mean), _flat(res)
                require(all(same_bits(fr[k], fg[k] - fm[k]) for k in fg),
                        f"grad {name}: residual = input - decoded, bit for bit (one rank)")
                if name == "fixed_accuracy":
                    e = max(float((fm[k] - fg[k]).abs().max()) for k in fg)
                    require(e <= GRAD_FA_TOL, f"grad {name}: mean within {GRAD_FA_TOL} "
                                              f"({e:.3e})")
                cmean, cres = compressed_psum_tree(cpu_grads, cpu_group, codec)
                require(_same_trees(mean, cmean) and _same_trees(res, cres),
                        f"grad {name}: mean and residual equal the CPU plain versions' "
                        f"(gloo) bit for bit")
                (_, wire_b), _ = counted(lambda: tree_collective_bytes(grads, codec))
                grad_rows.append({"codec": name, "raw_bytes": raw_b, "wire_bytes": wire_b,
                                  "psum_ms": psum_ms})
                print(f"grad {name}: tree_collective_bytes raw {raw_b} wire {wire_b} "
                      f"(ratio {raw_b / wire_b:.4f}), compressed_psum_tree "
                      f"{psum_ms:.3f} ms, launches {got}; {smi}", flush=True)
            out["grads"] = grad_rows
        finally:
            dist.destroy_process_group()
    finally:
        tmp.cleanup()
    print(f"checkpoint path: launches {launches}")
    out["launches"] = launches
    return out

SOLVER_PARAMS = {   # tests/test_solver.py's RT and PCHIP parameters
    "rt": dict(atwood=0.4, amplitude=0.03, mode=2.0),
    "pchip": dict(atwood=0.5, amplitude=0.03, pchip_seed=11, impulse=1.0),
}


def field_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-field difference over that field's largest magnitude."""
    got, want = got.cpu(), want.cpu()
    return max(float((got[..., f] - want[..., f]).abs().max() / want[..., f].abs().max())
               for f in range(want.shape[-1]))


def synced_s(fn):
    """(fn(), seconds) with the card drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solver_checks(dev) -> dict:
    """The port's solver on the card against the same solver on the CPU,
    graph against eager and run against run; returns per-member times."""
    from repro_torch.sim import solver
    from repro_torch.sim.ensemble import PCHIP_SPEC, RT_SPEC, sample_params
    from repro_torch.sim.solver import SimParams, run_simulation

    params = {k: SimParams(**v) for k, v in SOLVER_PARAMS.items()}
    for gname, grid in SOLVER_GRIDS:
        for name, p in params.items():
            rel = field_rel(run_simulation(p, **grid, device=DEV),
                            run_simulation(p, **grid, device="cpu"))
            require(rel <= SOLVER_SMALL_RTOL, f"solver {gname} {name}: card == CPU "
                    f"(worst field {rel:.3e} of its largest magnitude <= {SOLVER_SMALL_RTOL})")
    times = {}
    for spec, name in ((RT_SPEC, "rt"), (PCHIP_SPEC, "pchip")):
        grid = dict(ny=spec.ny, nx=spec.nx, nsteps=spec.nsteps, nsnaps=spec.nsnaps)
        p = params[name]
        one, graph_s = synced_s(lambda: run_simulation(p, **grid, device=DEV))
        two, graph2_s = synced_s(lambda: run_simulation(p, **grid, device=DEV))
        eager, eager_s = synced_s(lambda: solver._simulate(   # run_simulation's defaults
            p, **grid, lx=1.0, ly=3.0, dt=1.5e-3, g=4.0, dev=dev, graph=False))
        cpu_s = rel = None
        if name in SOLVER_FULL_CPU:
            t0 = time.perf_counter()
            cpu = run_simulation(p, **grid, device="cpu")
            cpu_s = time.perf_counter() - t0
            rel = field_rel(one, cpu)
        f = one.cpu().double()
        mass = f[..., 0].sum(dim=(1, 2))
        drift = float(((mass - mass[0]).abs() / mass[0]).max())
        ke = (0.5 * f[..., 0] * (f[..., 1] ** 2 + f[..., 2] ** 2)).sum(dim=(1, 2))
        ke_bound = KE_BOUND_PER_CELL * spec.ny * spec.nx
        times[spec.name] = {"graph_s": [graph_s, graph2_s], "eager_s": eager_s, "cpu_s": cpu_s}
        cpu_txt = ("CPU reference cut for the script's time" if rel is None else
                   f"CPU {cpu_s:.3f} s; card vs CPU {rel:.3e}")
        print(f"solver {spec.name} full ({spec.ny}x{spec.nx}, {spec.nsteps} steps, "
              f"{spec.nsnaps} snapshots), {name} parameters: card graph {graph_s:.3f} / "
              f"{graph2_s:.3f} s, card eager {eager_s:.3f} s, {cpu_txt}; mass drift "
              f"{drift:.3e}; kinetic energy max {float(ke.max()):.4g}", flush=True)
        if rel is not None:
            require(rel <= SOLVER_FULL_RTOL, f"solver {spec.name} full: card == CPU (worst "
                                             f"field {rel:.3e} <= {SOLVER_FULL_RTOL})")
        require(same_bits(one, two), f"solver {spec.name}: two runs give the same bits")
        require(same_bits(one, eager), f"solver {spec.name}: the CUDA graph gives the eager "
                                       f"run's bits")
        require(drift < 1e-5, f"solver {spec.name}: total mass drift {drift:.3e} < 1e-5")
        require(bool(torch.isfinite(f).all()) and abs(float(ke[0])) <= 1e-10
                and 0 < float(ke.max()) < ke_bound and float(f[..., 5].min()) >= 0
                and float(f[..., 5].max()) <= 1,
                f"solver {spec.name}: finite, starts at rest, kinetic energy grows and stays "
                f"under {ke_bound:g}, material in [0, 1]")
    # the production's first RT member: a reading, not a check (the
    # instability amplifies rounding further for the sampled parameters),
    # over the first SOLVER_READING steps (cut, for the script's time)
    p = sample_params(RT_SPEC, 1, 0)[0]
    rel = field_rel(run_simulation(p, **SOLVER_READING, device=DEV),
                    run_simulation(p, **SOLVER_READING, device="cpu"))
    print(f"solver rt, sample_params(RT_SPEC, 1, 0)[0], {SOLVER_READING}: card vs CPU "
          f"{rel:.3e} (a reading)", flush=True)
    return times


def profile_solver(dev) -> dict:
    """Kernels per RK3 step and the device's busy share over one RT_SPEC
    snapshot interval, run eagerly and replayed from its CUDA graph."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import solver
    from repro_torch.sim.ensemble import RT_SPEC, sample_params
    p = sample_params(RT_SPEC, 1, 0)[0]
    lx, ly, dt = 1.0, 3.0, 1.5e-3              # run_simulation's defaults
    rho, omega, rho1, rho2 = solver._initial_fields(p, RT_SPEC.ny, RT_SPEC.nx, lx, ly, dev)
    op = solver._Operators(RT_SPEC.ny, RT_SPEC.nx, lx, ly, p.diffusivity,
                           0.5 * (rho1 + rho2), dev)
    s = torch.stack([torch.fft.rfft2(omega), torch.fft.rfft2(rho)])
    g = torch.tensor(4.0, device=dev)
    steps = RT_SPEC.nsteps // (RT_SPEC.nsnaps - 1)
    graph, _ = solver._captured_interval(s, g, steps, dt, op)
    out = {}
    for what, fn in (("eager", lambda: solver._interval(s, g, steps, dt, op)),
                     ("graph", graph.replay)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        print(f"solver, one snapshot interval ({steps} RK3 steps and the snapshot), {what}:",
              end=" ")
        out[what] = print_profile(prof, wall_ms / steps, steps, "RK3 step")
    return out


def same_files(a: str, b: str) -> bool:
    """The shard files and manifest.json of two scenario directories hold
    the same bytes."""
    names = sorted(f for f in os.listdir(a) if f.startswith("shard_") or f == "manifest.json")
    if names != sorted(f for f in os.listdir(b) if f.startswith("shard_")
                       or f == "manifest.json"):
        return False
    return all(Path(a, f).read_bytes() == Path(b, f).read_bytes() for f in names)


def datagen_path(dev, tmp: str, cfg) -> dict:
    """Queue 1 item 7 on the card: the solver against the CPU; production of
    RT_SPEC and PCHIP_SPEC at full width through kernel 2 held bit for bit
    to an in-memory store of the same fields; kill and resume, sequential
    production, a fixed-rate plan through kernel 4 held to the plain
    encoder; then 30 training steps and certify_tolerance from the produced
    path.  Returns {"launches": kernel launches on the path's entry points}
    (produce, train_surrogate, certify_tolerance); the checks' launches are
    not counted."""
    from repro_torch.compression import codec_from_plan
    from repro_torch.core.ensemble import certify_tolerance
    from repro_torch.data import ShardedCompressedStore, channels_last
    from repro_torch import datagen
    from repro_torch.datagen import (CodecPlan, ProductionPlan, ScenarioPlan,
                                     open_produced, produce, produced_training_arrays,
                                     scenario_conditions)
    from repro_torch.kernels import zfp_codec
    from repro_torch.obs.metrics import get_registry
    from repro_torch.sim.ensemble import PCHIP_SPEC, RT_SPEC
    from repro_torch.train.loop import TrainConfig, train_surrogate
    produce_mod = sys.modules["repro_torch.datagen.produce"]

    t_phase = time.perf_counter()
    solver_times = solver_checks(dev)
    solver_kernels = profile_solver(dev)
    launches = {k: 0 for k in zfp_codec.LAUNCHES}
    counted = functools.partial(count_launches, launches)

    def capturing(into: dict):
        """produce's run_simulation, keeping each member's fields."""
        real = produce_mod.run_simulation

        def run(params, **kw):
            into[params] = real(params, **kw)
            return into[params]
        return mock.patch.object(produce_mod, "run_simulation", run)

    def chunks(plan):
        return sum(sc.num_sims * -(-sc.spec.nsnaps // plan.shard_size)
                   for sc in plan.scenarios)

    # (1) the full-width plan: RT_SPEC and PCHIP_SPEC, fixed accuracy
    plan = ProductionPlan(
        scenarios=(ScenarioPlan("rt", RT_SPEC, DG_RT_MEMBERS, seed=0),
                   ScenarioPlan("pchip", PCHIP_SPEC, DG_PCHIP_MEMBERS, seed=0)),
        codec=CodecPlan(tolerance=TOLERANCE), shard_size=SHARD_SIZE)
    root = os.path.join(tmp, "full")
    fields = {}
    with capturing(fields):
        (report, s), got = counted(lambda: synced_s(lambda: produce(plan, root, device=DEV)))
    samples = sum(r.samples_produced for r in report.scenarios)
    print(f"produce (RT_SPEC x {DG_RT_MEMBERS}, PCHIP_SPEC x {DG_PCHIP_MEMBERS}, tol "
          f"{TOLERANCE}, shards of {SHARD_SIZE}): {s:.3f} s, {samples} samples, "
          f"{samples / s:.1f} samples/s; launches {got}", flush=True)
    for r in report.scenarios:
        print(f"  {r.name}: {r.sims_run} members, {r.shards_written} shards, "
              f"{r.bytes_written} bytes, {r.seconds:.3f} s ({r.seconds / r.sims_run:.3f} s "
              f"a member, simulate to shards), writer transfer "
              f"{r.transfer_seconds:.3f} s, write {r.write_seconds:.3f} s")
    require(report.finalized and got["zfp_encode_blocks_fa"] == chunks(plan)
            and sum(got.values()) == chunks(plan),
            f"produce encoded each of its {chunks(plan)} chunks with one launch of "
            f"zfp_encode_blocks_fa and launched nothing else ({got})")
    ratios = {}
    for sc in plan.scenarios:
        sdir = os.path.join(root, sc.name)
        xs = torch.cat([fields[p].movedim(-1, 1) for p in sc.params()])
        mem = ShardedCompressedStore(xs.cpu().numpy(), np.full(len(xs), TOLERANCE, np.float32),
                                     shard_size=SHARD_SIZE, device=DEV)
        with open(os.path.join(sdir, "manifest.json")) as f:
            same = json.load(f) == mem.manifest()
        same &= all(Path(sdir, f"shard_{k:05d}.bin").read_bytes() == mem._shards[k].tobytes()
                    for k in range(mem.num_shards))
        require(same, f"produced {sc.name} store == in-memory ShardedCompressedStore of the "
                      f"same fields on the card, byte for byte ({mem.num_shards} shards)")
        st = open_produced(root).store(sc.name, device=DEV)
        worst = 0.0
        for lo in range(0, len(xs), 256):
            err = (st.get_batch(np.arange(lo, min(lo + 256, len(xs)))) - xs[lo:lo + 256])
            worst = max(worst, float(err.abs().max()))
        require(worst <= TOLERANCE, f"every decoded {sc.name} sample within its tolerance "
                                    f"(max error {worst:.3e} <= {TOLERANCE})")
        ratios[sc.name] = st.ratio
        print(f"  {sc.name} store: ratio {st.ratio:.4f} at tol {TOLERANCE}, logical "
              f"{st.logical_bytes} bytes, widths {np.bincount(st.widths).tolist()}")
    chunk = fields[plan.scenarios[0].params()[0]].movedim(-1, 1)[:SHARD_SIZE]
    codec = codec_from_plan(plan.codec)
    encode_ms = cuda_ms(lambda: codec.encode_batch(chunk), reps=20)
    print(f"encode of one chunk ({SHARD_SIZE} RT_SPEC snapshots, "
          f"{SHARD_SIZE * 6 * RT_SPEC.ny * RT_SPEC.nx // 16} blocks): {encode_ms:.4f} ms",
          flush=True)
    del fields, chunk

    # (2) kill and resume, sequential: RT_SPEC x DG_RESUME_MEMBERS
    plan4 = ProductionPlan(scenarios=(ScenarioPlan("rt", RT_SPEC, DG_RESUME_MEMBERS, seed=0),),
                           codec=CodecPlan(tolerance=TOLERANCE), shard_size=SHARD_SIZE)
    rate = {}
    for what, overlap in (("overlapped", True), ("sequential", False)):
        (rep, s), got = counted(lambda: synced_s(lambda: produce(
            plan4, os.path.join(tmp, what), overlap=overlap, device=DEV)))
        r = rep.scenarios[0]
        rate[what] = r.samples_produced / s
        print(f"produce {what}, RT_SPEC x {DG_RESUME_MEMBERS}: {s:.3f} s, "
              f"{rate[what]:.1f} samples/s, writer transfer {r.transfer_seconds:.3f} s, "
              f"write {r.write_seconds:.3f} s; launches {got}", flush=True)
    require(same_files(os.path.join(tmp, "overlapped", "rt"),
                       os.path.join(tmp, "sequential", "rt")),
            "sequential production (overlap=False) gives the overlapped run's bytes")
    killed_root = os.path.join(tmp, "killed")
    first, _ = counted(lambda: produce(plan4, killed_root, max_shards=DG_RESUME_SHARDS,
                                       device=DEV).scenarios[0])
    second, _ = counted(lambda: produce(plan4, killed_root, device=DEV).scenarios[0])
    num_shards = -(-plan4.scenarios[0].num_samples // SHARD_SIZE)
    print(f"kill and resume: first run {first.shards_written} shards ({first.sims_run} "
          f"members, preempted {first.preempted}), resume {second.shards_written} shards "
          f"({second.sims_run} members)")
    require(first.preempted and first.shards_written == DG_RESUME_SHARDS
            and second.finalized and second.shards_written == num_shards - DG_RESUME_SHARDS
            and same_files(os.path.join(killed_root, "rt"),
                           os.path.join(tmp, "overlapped", "rt")),
            "a run stopped after 3 shards and resumed gives the uninterrupted run's bytes")

    # (3) fixed rate through kernel 4, held to the plain encoder
    plan_fr = ProductionPlan(scenarios=(ScenarioPlan("rt", RT_SPEC, DG_FR_MEMBERS, seed=0),),
                             codec=CodecPlan(mode="fixed_rate", bits_per_value=FR_BITS),
                             shard_size=SHARD_SIZE)
    fr_fields = {}
    with capturing(fr_fields):
        rep, got = counted(lambda: produce(plan_fr, os.path.join(tmp, "fr"), device=DEV))
    require(rep.finalized and got["zfp_encode_blocks"] == chunks(plan_fr),
            f"the fixed-rate plan encoded each of its {chunks(plan_fr)} chunks with one "
            f"launch of zfp_encode_blocks ({got})")
    with mock.patch.object(produce_mod, "run_simulation",
                           lambda params, **kw: fr_fields[params].cpu()):
        produce(plan_fr, os.path.join(tmp, "fr_cpu"), device="cpu")
    require(same_files(os.path.join(tmp, "fr", "rt"), os.path.join(tmp, "fr_cpu", "rt")),
            f"fixed-rate production at {FR_BITS} bits on the card == the plain encoder "
            f"on the same fields, byte for byte")
    del fr_fields

    # (4) train 30 steps from the produced path (kernel 3 per batch)
    rt_dir = os.path.join(root, "rt")
    cond = scenario_conditions(rt_dir)
    opened = []
    real_resolve = datagen.resolve_store

    def recording_resolve(*a, **k):
        opened.append(real_resolve(*a, **k))
        return opened[-1]

    stamps = []
    wait = get_registry().counter("train.fetch_wait_seconds")
    wait0 = wait.value
    with mock.patch.object(datagen, "resolve_store", recording_resolve):
        (_, losses), got = counted(lambda: train_surrogate(
            cfg, TrainConfig(epochs=2, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                             max_steps=HOST_STEPS), cond, rt_dir,
            hooks=[lambda step, m, loss: stamps.append(time.perf_counter())],
            target_transform=channels_last, device=DEV))
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    io = opened[0].stats
    print(f"train from the produced path ({len(cond)} samples): {HOST_STEPS} steps, step "
          f"median {statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}), fetch wait {1e3 * (wait.value - wait0):.3f} ms, io "
          f"bytes_read {io.bytes_read} read_seconds {io.read_seconds:.6f} decode_seconds "
          f"{io.decode_seconds:.6f} batches {io.batches}, last loss {losses[-1][1]:.7f}; "
          f"launches {got}", flush=True)
    require(len(losses) == HOST_STEPS and all(np.isfinite(l) for _, l in losses),
            f"{HOST_STEPS} finite losses from the produced path")
    require(got["zfp_decode_blocks"] == io.batches >= HOST_STEPS,
            f"zfp_decode_blocks decoded every batch of the produced store "
            f"({got['zfp_decode_blocks']} launches, {io.batches} batches)")

    # (5) certify from the produced path (kernels 3, then 2 and 1)
    eval_cond, eval_fields = produced_training_arrays(rt_dir, device=DEV)
    (res, cert_s), got = counted(lambda: synced_s(lambda: certify_tolerance(
        cfg, TrainConfig(epochs=CERT_EPOCHS, batch_size=BATCH, lr=LR, log_every=1), None,
        rt_dir, eval_conditions=eval_cond[:EVAL_SAMPLES],
        eval_targets=eval_fields[:EVAL_SAMPLES], seeds=ENS_SEEDS, multiples=CERT_MULTIPLES,
        shard_size=SHARD_SIZE, device_resident=True, device=DEV)))
    mb = res.max_benign
    print("certification from the produced path summary: " + json.dumps(res.summary()))
    print(f"certification from the produced path: {cert_s:.3f} s; model L1 e = "
          f"{res.model_l1_error:.7f}; max benign multiple "
          f"{None if mb is None else mb.multiple}, ratio "
          f"{None if mb is None else round(mb.ratio, 4)}; per candidate " + ", ".join(
              f"x{c.multiple:g} {'benign' if c.benign else 'degraded'} ratio {c.ratio:.4f}"
              for c in res.candidates) + f"; the produced store's ratio at {TOLERANCE}: "
          f"{ratios['rt']:.4f}; launches {got}", flush=True)
    steps = CERT_EPOCHS * (len(cond) // BATCH)
    require([c.multiple for c in res.candidates] == list(CERT_MULTIPLES)
            and got["zfp_decode_blocks"] >= -(-len(cond) // 64)
            and got["zfp_encode_blocks_fa"] >= len(CERT_MULTIPLES)
            and got["zfp_decode_blocks_fa"] >= steps,
            "certification read the produced store (kernel 3), encoded every candidate "
            "store (kernel 2) and decoded every sweep step (kernel 1)")
    print(f"datagen path: launches {launches}; overlapped {rate['overlapped']:.1f} vs "
          f"sequential {rate['sequential']:.1f} samples/s; solver kernels per RK3 step "
          f"{solver_kernels}; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "solver": solver_times, "ratios": ratios}


def host_streaming_path(tmp: str, samples: np.ndarray, cond: np.ndarray, cfg,
                        resident) -> tuple:
    """Write the four on-disk stores, train from each, check their batches.

    Returns (launches of each kernel on this path, the fixed-rate store's
    payload words per sample, one sharded batch's (B * nb, wmax) payload
    and emax for timing the fixed-rate decode).
    """
    from repro_torch.data import (CompressedArrayStore, DeviceResidentCompressedStore,
                                  RawArrayStore, ShardAwareLoader,
                                  ShardedCompressedStore, channels_last)
    from repro_torch.kernels import zfp_codec
    from repro_torch.obs.metrics import get_registry
    from repro_torch.train.loop import TrainConfig, train_surrogate

    zfp_codec.reset_launches()
    tols = np.full(N_SAMPLES, TOLERANCE, np.float32)
    built = {}

    def build(name, make):
        t0 = time.perf_counter()
        before = dict(zfp_codec.LAUNCHES)
        st = make()
        torch.cuda.synchronize()
        built[name] = st
        launched = {k: v - before[k] for k, v in zfp_codec.LAUNCHES.items() if v != before[k]}
        print(f"store {name}: build {time.perf_counter() - t0:.3f} s, ratio "
              f"{st.sample_nbytes * st.num_samples / st.stored_bytes:.3f}, "
              f"stored {st.stored_bytes} bytes, launches {launched}", flush=True)
        if name in ("fa", "sharded"):
            require(launched.get("zfp_encode_blocks_fa", 0) > 0,
                    f"zfp_encode_blocks_fa built the {name} store")

    build("raw", lambda: RawArrayStore(samples, root=os.path.join(tmp, "raw"),
                                       device=DEV))
    build("fa", lambda: CompressedArrayStore(samples, tolerances=tols,
                                             root=os.path.join(tmp, "fa"), device=DEV))
    def sharded_reopened():
        # the timed runs read through the memory-mapped shards of open()
        root = os.path.join(tmp, "sharded")
        ShardedCompressedStore(samples, tols, root=root, shard_size=SHARD_SIZE,
                               device=DEV)
        return ShardedCompressedStore.open(root, device=DEV)

    build("sharded", sharded_reopened)
    build("fixed_rate", lambda: CompressedArrayStore(
        samples, bits_per_value=FR_BITS, root=os.path.join(tmp, "fixed_rate"),
        device=DEV))

    wait = get_registry().counter("train.fetch_wait_seconds")
    runs = [("raw", 0, None), ("raw", 2, None), ("fa", 0, None), ("sharded", 0, None),
            ("sharded", 2, None), ("fixed_rate", 0, None),
            ("raw", 2, WORKSPACE_MBS), ("sharded", 2, WORKSPACE_MBS)]
    histories = {}
    for name, prefetch, bw in runs:
        st = built[name]
        st.bandwidth_mbs = bw
        st.stats.reset()
        wait0 = wait.value
        decodes0 = zfp_codec.LAUNCHES["zfp_decode_blocks"]
        stamps = []
        t0 = time.perf_counter()
        _, losses = train_surrogate(
            cfg, TrainConfig(epochs=1, batch_size=BATCH, lr=LR, seed=0, log_every=1,
                             max_steps=HOST_STEPS, prefetch=prefetch),
            cond, st, hooks=[lambda step, m, loss: stamps.append(time.perf_counter())],
            target_transform=channels_last, device=DEV)
        torch.cuda.synchronize()
        step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        io = st.stats
        print(f"run {name} prefetch={prefetch} bandwidth="
              f"{'unthrottled' if bw is None else f'{bw} MB/s'}: {HOST_STEPS} steps "
              f"{time.perf_counter() - t0:.3f} s, step median "
              f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
              f"{max(step_ms):.3f}), fetch wait {1e3 * (wait.value - wait0):.3f} ms, "
              f"io bytes_read {io.bytes_read} read_seconds {io.read_seconds:.6f} "
              f"decode_seconds {io.decode_seconds:.6f} batches {io.batches}, "
              f"last loss {losses[-1][1]:.7f}", flush=True)
        require(len(losses) == HOST_STEPS and all(np.isfinite(l) for _, l in losses),
                f"{HOST_STEPS} finite losses from the {name} store (prefetch "
                f"{prefetch})")
        if name != "raw":
            decodes = zfp_codec.LAUNCHES["zfp_decode_blocks"] - decodes0
            require(decodes == io.batches, f"zfp_decode_blocks decoded every batch of the "
                                           f"{name} store ({decodes} launches, "
                                           f"{io.batches} batches)")
        st.bandwidth_mbs = None
        # batches built on the worker's side stream train like synchronous
        # ones (the losses differ only by cuDNN's nondeterministic backward)
        if name not in histories:
            histories[name] = losses
            continue
        worst = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(losses, histories[name]))
        require(worst <= LOSS_RTOL, f"{name} store, prefetch {prefetch}: losses == "
                                    f"the prefetch-0 run's (worst rel {worst:.2e})")
    host_launches = dict(zfp_codec.LAUNCHES)
    print(f"host-streaming path: launches {host_launches}")
    for name in ("zfp_decode_blocks", "zfp_encode_blocks", "zfp_encode_blocks_fa"):
        require(host_launches[name] > 0, f"{name} launched on the host-streaming path "
                                         f"({host_launches[name]} times)")

    # the outputs are right (these launches are not counted above)
    sharded = built["sharded"]
    batches = ShardAwareLoader.for_store(sharded, BATCH, seed=3).take(3) + \
        [np.arange(N_SAMPLES - BATCH, N_SAMPLES)]
    from_store = DeviceResidentCompressedStore.from_store(sharded, device=DEV)
    for idx in batches:
        require(same_bits(built["raw"].get_batch(idx), torch.from_numpy(samples[idx])),
                "raw store batch == the samples")
        want = resident.decode_indices(torch.as_tensor(idx, device=resident.device))
        require(same_bits(built["fa"].get_batch(idx), want),
                "per-sample FA store batch (fixed-rate decode kernel) == "
                "device-resident decode (FA decode kernel)")
        got = sharded.get_batch(idx)
        require(same_bits(got, want), "sharded store batch == device-resident decode")
        require(same_bits(from_store.decode_indices(
            torch.as_tensor(idx, device=from_store.device)), got),
            "from_store(sharded) decode == sharded store batch")
        fr = built["fixed_rate"].get_batch(idx)
        require(bool(torch.isfinite(fr).all()) and fr.shape == (len(idx),) +
                samples.shape[1:], "fixed-rate store batch is finite, of sample shape")
    require(from_store.shard_size == SHARD_SIZE, "from_store carries the shard size")
    fr_words = np.stack([
        np.load(os.path.join(tmp, "fixed_rate", f"sample_{i:06d}.npz"))["payload"].ravel()
        for i in range(N_SAMPLES)])
    payload, emax, _ = sharded.read_records(batches[0])
    shard_batch = (torch.from_numpy(payload.reshape(-1, payload.shape[-1])),
                   torch.from_numpy(emax.reshape(-1)))
    return host_launches, torch.from_numpy(fr_words), shard_batch


# -- the paper's study and the three surrogate examples ----------------------
# train_surrogate at full width: RT_SPEC's 96x32 grid, SurrogateConfig()'s
# base 256, the example's own 8 members and 4 epochs, a compressed store
# and 16-bit fixed-rate checkpoints
EX_SURROGATE = ["--sims", "8", "--epochs", "4", "--channels", "256", "--compressed",
                "--lossy-ckpt-bits", "16"]
EX_SURROGATE_STEPS = 4 * (8 * 51 // 32)
STUDY_ARRAYS = ("raw_preds", "lossy_preds", "student_preds", "test_nf", "test_cond",
                "test_pvec")


def load_example(name: str):
    """``examples/<name>.py`` as a module, loaded by file path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"{name}_on_the_card",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_study_files() -> dict:
    """The JAX study checked in under ``experiments/data/`` (a JAX build on
    a CPU), read with json and numpy: its meta and arrays."""
    root = ROOT / "experiments" / "data"
    with open(root / "study.json") as f:
        meta = json.load(f)
    with np.load(root / "study.npz") as z:
        return {"meta": meta, **{k: z[k] for k in z.files}}


def examples_path(dev, smi: str) -> dict:
    """The quickstart as written; ``train_surrogate`` at full width with
    lossy checkpoints, then again on its checkpoint directory (it must
    resume and train nothing); ``study.build_study`` at
    ``benchmarks/common.py``'s sizes into a temporary directory (its array
    shapes those of the JAX study's ``study.npz``, its lossy ratios rising
    with the multiple, its Algorithm 1 tolerance equal to the plain search
    on the CPU at the card's model error, bit for bit); and the compression
    study on it (exact resume under deterministic algorithms).  Each piece
    runs with the codec kernels' counts set to 0 just before it; kernels 1,
    2 and 4 must launch in the phase.  Prints the card's study beside the
    JAX study's meta and, through the same functions, its band and PSNR."""
    from repro_torch import study as study_mod
    from repro_torch.kernels import zfp_codec
    from repro_torch.train import checkpoint as ckpt

    launches = {k: 0 for k in zfp_codec.LAUNCHES}
    seconds, by_section = {}, {}

    def section(name, fn):
        t0 = time.perf_counter()
        out, got = count_launches(launches, fn)
        seconds[name] = time.perf_counter() - t0
        by_section[name] = got
        print(f"examples phase, {name}: {seconds[name]:.1f} s; launches {got}", flush=True)
        return out

    # -- the quickstart as written (48x16, base 16) ---------------------------
    qs = section("quickstart", lambda: load_example("quickstart_torch").main([]))
    require(qs["device"] == dev.type, f"the quickstart ran on {dev.type}")
    for c in qs["compression"]:
        require(c["bound_holds"] and c["max_err"] <= c["tolerance"],
                f"quickstart on the card: max error {c['max_err']:.4e} within tol "
                f"{c['tolerance']:g} (ratio {c['ratio']:.4f})")
    require([s for s, _ in qs["losses"]] == [5, 10, 15, 20]
            and all(np.isfinite(l) for _, l in qs["losses"]),
            f"quickstart: finite losses at steps 5-20 ({qs['losses']})")

    # -- train_surrogate at full width, then resumed from its directory -------
    ts = load_example("train_surrogate_torch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        ck = os.path.join(tmp, "ckpt")
        argv = EX_SURROGATE + ["--ckpt-dir", ck]
        first = section("train_surrogate", lambda: ts.main(argv))
        again = section("train_surrogate_resumed", lambda: ts.main(argv))
        with open(os.path.join(ckpt.latest_checkpoint(ck), "manifest.json")) as f:
            manifest = json.load(f)
    require(first["device"] == again["device"] == dev.type,
            f"train_surrogate ran on {dev.type}")
    require(first["steps"] == list(range(1, EX_SURROGATE_STEPS + 1))
            and len(first["losses"]) == EX_SURROGATE_STEPS // 10
            and all(np.isfinite(l) for _, l in first["losses"])
            and np.isfinite(first["psnr_db"]),
            f"train_surrogate at full width: {EX_SURROGATE_STEPS} steps, finite losses "
            f"{first['losses']}, PSNR {first['psnr_db']:.4f} dB, mass error "
            f"{first['mass_rel_err']:.4f}, store ratio {first['store_ratio']:.4f}")
    require(again["steps"] == [] and again["losses"] == []
            and manifest["step"] == EX_SURROGATE_STEPS and manifest["lossy_bits"] == 16,
            f"run again on its checkpoint directory: resumed from the 16-bit checkpoint "
            f"of step {manifest['step']}, trained no step (PSNR {again['psnr_db']:.4f} dB)")
    require(by_section["train_surrogate"]["zfp_encode_blocks"] > 0,
            "kernel 4 (fixed-rate encode) saved the lossy checkpoints")

    # -- the study at benchmarks/common.py's sizes, and the compression study --
    jax_study = jax_study_files()
    real_find, searched = study_mod.find_tolerance, []

    def find_tolerance(sample, e, **kw):
        searched.append((np.array(sample), e))
        return real_find(sample, e, **kw)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_study_") as sdir, \
            mock.patch.object(study_mod, "find_tolerance", find_tolerance):
        st = section("build_study", lambda: study_mod.build_study(
            force=True, data_dir=sdir, device=DEV))
        cs_mod = load_example("compression_study_torch")
        cs = section("compression_study", lambda: cs_mod.main(["--data-dir", sdir]))
    study_mod._STUDY = None
    meta = st["meta"]
    for k in STUDY_ARRAYS:
        require(st[k].shape == jax_study[k].shape and bool(np.isfinite(st[k]).all()),
                f"study {k}: finite, of the JAX study's shape {jax_study[k].shape}")
    ratios = meta["lossy_ratios"]
    require(all(a < b for a, b in zip(ratios, ratios[1:])),
            f"the lossy ratios rise with the multiple ({ratios})")
    (sample, e), = searched
    plain = real_find(sample, e, device="cpu")
    require(e == meta["model_l1_error"] and plain.tolerance == meta["alg1_tolerance"]
            and plain.iterations == meta["alg1_iterations"]
            and plain.ratio == meta["alg1_ratio"],
            f"Algorithm 1 on the card == the plain search on the CPU at the card's e "
            f"{e:.6f}: tolerance {meta['alg1_tolerance']!r} ({plain.tolerance!r}), ratio "
            f"{meta['alg1_ratio']:.4f}, {meta['alg1_iterations']} iterations")
    require(cs["device"] == dev.type, f"the compression study ran on {dev.type}")
    require(cs["exact_resume"], "compression study: kill at step 5 + resume == the "
                                "uninterrupted run, bit for bit (deterministic algorithms)")
    require(cs["resident_same"] and cs["produce"]["finalized"],
            "compression study: resident batch == host batch; production finalized")
    for name in ("zfp_decode_blocks_fa", "zfp_encode_blocks_fa", "zfp_encode_blocks"):
        require(launches[name] > 0, f"{name} launched in the examples phase "
                                    f"({launches[name]} times)")

    # -- the card's study beside the JAX study --------------------------------
    jm = jax_study["meta"]
    for who, m in (("card", meta), ("JAX study.json", jm)):
        print(f"study ({who}): e {m['model_l1_error']:.4f}; Algorithm 1 tolerance "
              f"{m['alg1_tolerance']:.4f}, ratio {m['alg1_ratio']:.2f}x, "
              f"{m['alg1_iterations']} iterations; lossy ratios "
              + ", ".join(f"x{a:g} {r:.2f}x" for a, r in zip(m["lossy_multiples"],
                                                              m["lossy_ratios"]))
              + f"; built in {m['build_seconds']} s", flush=True)
    print("the JAX study's models through the same band and PSNR functions, on the card:")
    jax_quality = cs_mod.study_verdicts(jax_study, dev)
    out = {"launches": launches, "by_section": by_section, "seconds": seconds,
           "compression_study_seconds": cs["seconds"], "meta": meta,
           "card": {k: cs[k] for k in ("band_width", "verdicts", "raw_psnr", "lossy_psnr")},
           "jax": {"meta": {k: jm[k] for k in ("model_l1_error", "alg1_tolerance",
                                               "alg1_ratio", "alg1_iterations",
                                               "lossy_ratios")}, **jax_quality},
           "quickstart": {k: qs[k] for k in ("compression", "algorithm1", "losses",
                                             "store_ratio")},
           "train_surrogate": {k: first[k] for k in ("losses", "psnr_db", "mass_rel_err",
                                                     "store_ratio")},
           "resumed_psnr_db": again["psnr_db"], "exact_resume": cs["exact_resume"],
           "certify": cs["candidates"], "card_name": smi}
    print(json.dumps({"examples": out}, default=float))
    return out


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
