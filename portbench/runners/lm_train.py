"""Runner of the LM training cells: the launcher's ``train_step``, back to
back.

Set-up looks the configuration's architecture up in the program's registry
first (a program without it fails there, before anything is allocated),
cuts it to the file's layers and held experts (:func:`arch_config`), draws
the weights with ``lm.init_lm`` from the seed and keeps a host copy of them
for the reference.  Step ``t``'s batch comes from
``numpy.random.default_rng((seed, 7, t))`` (:func:`draw_batch`): ``batch``
packed sequences of ``seq`` token ids drawn from a Zipf law of the
traffic's exponent over the whole vocabulary, the labels the next token.

The first ``first_steps`` steps are read: each step's loss, every leaf's
gradient at step 1 and its change after them, a leaf being one layer's
slice of a stacked parameter.  Step 1 calls ``train_step``'s two halves
(``loss_and_grads``, then ``apply_adam`` in place) apart, to read the
gradient and the device memory's peak during the update (on standard
error, in bytes a parameter).  The check prints the leaves of the largest
gradient and change gaps on standard error.  ``warmup_steps`` more are set-up; then the
steps run back to back for ``--seconds``.  The check follows the same
steps in the plain reference (``portbench/reference/granite.py``) from the
same bfloat16 weights, read as float32, over the same batches, after the
window has closed and the program's state has been freed.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict

import numpy as np
import torch

from portbench import check as check_mod
from portbench import lm_counts, training
from portbench.reference import granite as ref_model
from portbench.window import Window

STEP_SEED_TAG = 7    # (seed, STEP_SEED_TAG, step): the batches' generator


def arch_config(cfg: dict):
    """The program's architecture for the configuration file: the registry's
    entry (``KeyError`` where the program lacks it) at the file's sizes."""
    from repro_torch.configs import get_config
    base = get_config(cfg["arch"])
    if cfg["mamba_n_groups"] != 1 or cfg["mamba_proj_bias"] or cfg["attention_bias"]:
        raise ValueError("one Mamba-2 group and no projection biases, as published")
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != cfg["mamba_expand"] * cfg["hidden_size"]:
        raise ValueError("mamba_n_heads x mamba_d_head must be mamba_expand x hidden_size")
    kinds = tuple(cfg["layer_types"][:cfg["num_hidden_layers"]])
    return dataclasses.replace(
        base, num_layers=len(kinds), layer_kinds=kinds, d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["intermediate_size"], shared_expert_ff=cfg["shared_intermediate_size"],
        vocab_size=cfg["vocab_size"], num_experts=cfg["router_experts"],
        experts_held=cfg["num_local_experts"], expert_offset=cfg["expert_offset"],
        experts_per_token=cfg["num_experts_per_tok"], ssm_state=cfg["mamba_d_state"],
        ssm_heads=cfg["mamba_n_heads"], ssm_head_dim=cfg["mamba_d_head"],
        ssm_conv=cfg["mamba_d_conv"], ssm_conv_bias=cfg["mamba_conv_bias"],
        nope=cfg["position_embedding_type"] == "nope",
        attn_scale=cfg["attention_multiplier"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=float(cfg["logits_scaling"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], param_dtype=cfg["param_dtype"])


def draw_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
               exponent: float) -> Dict[str, torch.Tensor]:
    """Step ``step``'s tokens and next-token labels, (batch, seq) int32 each
    on the host: ids drawn with probability proportional to ``1 / (id +
    1) ** exponent``."""
    rng = np.random.default_rng((seed, STEP_SEED_TAG, step))
    cdf = np.cumsum(1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** exponent)
    ids = np.searchsorted(cdf, rng.random((batch, seq + 1)) * cdf[-1], side="right")
    ids = torch.from_numpy(np.minimum(ids, vocab - 1).astype(np.int32))
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def leaves(params, arch) -> Dict[str, torch.Tensor]:
    """The parameters by leaf: ``embed``, ``final_norm`` and each layer's
    slice of every stacked leaf, ``layers.<i>.<leaf>``."""
    from repro_torch.models import lm
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for i in range(arch.num_layers):
        out.update({f"layers.{i}.{k}": v for k, v in lm._mixed_layer_params(params, arch, i).items()})
    return out


def run(run) -> None:
    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    arch = arch_config(cfg)
    from repro_torch.launch import train as launch
    from repro_torch.models import lm
    from repro_torch.obs.metrics import get_registry
    from repro_torch.train.optimizer import AdamConfig

    b, s = tr["batch"], tr["seq"]
    opt_cfg = AdamConfig(lr=cfg["train"]["lr"], grad_clip=cfg["train"]["grad_clip"])
    params = lm.init_lm(seed, arch, device=dev)
    opt = launch.adam_init_tree(params)
    p0 = {k: v.to("cpu", copy=True) for k, v in leaves(params, arch).items()}
    n_params = sum(t.numel() for t in p0.values())
    run.mark("init")

    def batch(step):
        return {k: v.to(dev) for k, v in draw_batch(seed, step, b, s, cfg["vocab_size"],
                                                    tr["zipf_exponent"]).items()}

    reg = get_registry()

    def counters():
        return {name: float(reg.counter(f"lm.moe.{name}").value)
                for name in ("held_pairs", "max_expert_pairs")}

    first = tr["first_steps"]
    win = Window(dev, first + tr["warmup_steps"], run.seconds,
                 tr["trace_steps"] if run.trace else 0, counters)
    readings = {"loss": []}
    drawn = []
    step = 0
    while True:
        bt = batch(step)
        if step < first:
            drawn.append({k: v.cpu() for k, v in bt.items()})
        if step == 0:
            loss, grads = launch.loss_and_grads(params, arch, bt)
            readings["grad_norm"] = training.norms(leaves(grads, arch))
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            params, opt = launch.apply_adam(grads, opt, params, opt_cfg, inplace=True)
            del grads
            if dev.type == "cuda":
                peak = torch.cuda.max_memory_allocated(dev)
                print(f"launcher Adam: peak {peak / 1e9:.2f} GB over {n_params} parameters, "
                      f"{peak / n_params:.2f} bytes a parameter", file=sys.stderr)
        else:
            params, opt, loss = launch.train_step(params, opt, bt, arch, opt_cfg)
        step += 1
        if step <= first:
            readings["loss"].append(float(loss))
        if step == first:
            now = leaves(params, arch)
            readings["change_norm"] = {k: float(torch.linalg.vector_norm(
                now[k].float() - v.to(dev).float(), dtype=torch.float64)) for k, v in p0.items()}
            run.mark("first_steps")
        if not win.tick(step):
            break

    run.window = win
    run.rate_metric = "train_samples_per_s"
    run.samples_per_step = b
    run.flops_per_step = lm_counts.train_step_flops(cfg, b, s)

    def release():
        win.counters = None

    def follow(**kw):
        t = time.perf_counter()
        out = ref_model.train(cfg, p0, drawn, dev, **kw)
        print(f"reference {kw or 'plain'}: {time.perf_counter() - t:.1f} s", file=sys.stderr)
        return out

    def worst(ref, prog=readings):
        return {key: sorted(((g, leaf) for leaf, g in check_mod.leaf_gaps(prog, ref, key).items()),
                            reverse=True)[:4] for key in ("grad_norm", "change_norm")}

    def check():
        ref = follow()
        print(f"worst leaves: {worst(ref)}", file=sys.stderr)
        return training.compare([readings], [ref])

    def calibrate():
        ref = follow()
        control = follow(control="fp8")
        faults = {f: follow(fault=f) for f in ref_model.FAULTS}
        return {"program": training.compare([readings], [ref]),
                "control": training.compare([control], [ref]),
                "faults": {f: training.compare([r], [ref]) for f, r in faults.items()},
                "worst_leaves": {"program": worst(ref), "control": worst(ref, control),
                                 **{f: worst(ref, r) for f, r in faults.items()}}}

    run.release, run.check, run.calibrate = release, check, calibrate
