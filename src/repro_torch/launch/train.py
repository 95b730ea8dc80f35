"""LM training launcher on the card: the port of ``repro/launch/train.py``.

It runs real steps of a reduced decoder arch: synthetic tokens from
``np.random.default_rng(start)`` with labels ``roll(tokens, -1, 1)``, the
chunked next-token loss and its gradients (:func:`repro_torch.models.lm.lm_loss`),
gradients cast to f32 and Adam (``lr=3e-4``, ``grad_clip=1.0``).  With
``--ckpt-dir`` it saves ``{"params", "opt"}`` every 5 steps and resumes from
the latest checkpoint; the format is the JAX package's, so a checkpoint of
either package restores in the other.  The first step is synced and reported
once (``train.compile_seconds``), the rest go to ``train.step_seconds``.

``--device cpu`` runs the plain PyTorch path on the CPU; the default is the
card, and without one the launcher raises.  ``--dry-run`` traces the full
config's ``--shape`` cell on the production mesh (``--multi-pod``: the
2-pod one) through :mod:`repro_torch.launch.dryrun`, in a fresh process
and on the CPU by design.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b --shape train_4k --dry-run
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.compression import tree_flatten_with_path, tree_map
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention
from repro_torch.models import lm
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig, AdamState, adam_update, global_norm

CKPT_EVERY = 5


def adam_init_tree(params) -> AdamState:
    """Adam state of a nested parameter tree: m and v f32 zeros shaped like
    the parameters, step 0.  The JAX package's moments start in the
    parameters' dtype and its first update makes them f32; zeros are zeros
    in either dtype, so the updates' bits are the same, and f32 from the
    start lets :func:`apply_adam` write them in place."""
    dev = params["embed"].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)     # noqa: E731
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m=tree_map(zeros, params), v=tree_map(zeros, params))


def loss_and_grads(params, cfg: ArchConfig, batch):
    """``(loss, grads)`` of :func:`lm.lm_loss` at ``params``, grads a tree
    like ``params``; ``params`` is not changed.  A leaf the loss does not
    use (a pure SSM layer's ``ln2``) gets a zero gradient, as under
    ``jax.grad``.  The device ranges ``lm.forward`` and ``lm.backward``
    time the loss and its gradients."""
    pairs, treedef = tree_flatten_with_path(params)
    leaves = [p.detach().requires_grad_() for _, p in pairs]
    dev = leaves[0].device
    with obs_trace.device_range("lm.forward", dev):
        loss = replicated(lm.lm_loss(treedef.unflatten(leaves), cfg, batch))
    with obs_trace.device_range("lm.backward", dev):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else like_param(g, p)
             for p, g in zip(leaves, grads)]
    return loss.detach(), treedef.unflatten(grads)


def replicated(t):
    """A DTensor reduced and replicated on every mesh dim (a plain tensor as
    it is)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def like_param(g, p):
    """A gradient DTensor at its parameter's placements (partial sums
    reduced, reduce-scattered where the parameter is sharded)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def apply_adam(grads, opt: AdamState, params, opt_cfg: AdamConfig, inplace: bool = False):
    """:func:`repro_torch.train.optimizer.adam_update` on nested trees of
    f32 gradients, flattened in the JAX package's leaf order (so the clip's
    global norm sums in its order).

    ``inplace`` (the launcher's step) writes the step count, moments and
    parameters into their own tensors and returns them, where the moments
    are f32 plain tensors (:func:`adam_init_tree`'s); it takes gradients in
    any float dtype.  The clip's scale comes from the global norm of all of
    them (``global_norm`` casts each leaf to f32, exactly), then each leaf
    is cast to f32, scaled and updated by ``adam_update`` alone, so one
    leaf's f32 copies live at a time; the same kernels, so the same bits,
    as one ``adam_update`` of the whole f32 tree.  DTensors (the sharded
    steps) and moments of another dtype (a state restored before its first
    update) get new tensors."""
    g, treedef = tree_flatten_with_path(grads)
    keys = [k for k, _ in g]
    flat = lambda t: dict(tree_flatten_with_path(t)[0])          # noqa: E731
    nest = lambda d: treedef.unflatten([d[k] for k in keys])      # noqa: E731
    m, v, p = flat(opt.m), flat(opt.v), flat(params)
    if not (inplace and all(t.dtype == torch.float32 and not isinstance(t, DTensor)
                            for t in (*m.values(), *v.values()))):
        new_p, st = adam_update({k: t.float() for k, t in g}, AdamState(opt.step, m, v),
                                p, opt_cfg)
        return nest(new_p), AdamState(st.step, nest(st.m), nest(st.v))
    grads = dict(g)
    leaf_cfg = dataclasses.replace(opt_cfg, grad_clip=None)
    scale = None
    if opt_cfg.grad_clip is not None:
        gn = global_norm(grads)
        scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    for k in keys:
        gk = grads.pop(k).float()
        gk = gk * scale if scale is not None else gk
        adam_update({k: gk}, AdamState(opt.step.clone(), {k: m[k]}, {k: v[k]}), {k: p[k]},
                    leaf_cfg, inplace=True)
    opt.step.add_(1)
    return params, opt


def train_step(params, opt: AdamState, batch, cfg: ArchConfig, opt_cfg: AdamConfig):
    """The JAX launcher's step (train.py:77): the loss and its gradients,
    gradients cast to f32, one Adam update (:func:`apply_adam`, which casts
    one leaf at a time), timed by the device range ``lm.optimizer``.
    Returns (params, opt, loss).

    For every family, plain tensors and f32 moments (:func:`adam_init_tree`'s)
    are updated in place: the returned ``params`` and ``opt`` are the
    tensors passed in, so a caller that reads the parameters it passed
    after the step passes a copy.  DTensors, and moments of another
    dtype, get new tensors and leave the inputs as they were."""
    loss, grads = loss_and_grads(params, cfg, batch)
    with obs_trace.device_range("lm.optimizer", loss.device):
        params, opt = apply_adam(grads, opt, params, opt_cfg, inplace=True)
    return params, opt, loss


def make_batch(rng: np.random.Generator, cfg: ArchConfig, batch: int, seq: int,
               device) -> dict:
    """Tokens drawn as the JAX launcher draws them, labels rolled by one;
    as the JAX launcher adds them (train.py:101-106), zero f32
    ``frontend_embeds`` (batch, frontend_seq, frontend_dim) for a vision
    config and zero f32 ``encoder_embeds`` (batch, seq, frontend_dim) for
    an encoder-decoder."""
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                            .astype(np.int32)).to(device)
    out = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = torch.zeros((batch, cfg.frontend_seq, cfg.frontend_dim),
                                             dtype=torch.float32, device=device)
    if cfg.encoder_layers:
        out["encoder_embeds"] = torch.zeros((batch, seq, cfg.frontend_dim),
                                            dtype=torch.float32, device=device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Returns the per-step losses as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace-dir", default=None,
                    help="enable telemetry: write <run>.trace.json "
                         "(Perfetto-loadable) + <run>.events.jsonl here")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    if args.dry_run:
        # the dry run starts its own fake process group: a fresh process
        import subprocess
        import sys
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", args.arch, "--cell", args.shape,
               "--mesh", "multi" if args.multi_pod else "single"]
        raise SystemExit(subprocess.call(cmd))
    dev = resolve_device(args.device)
    if args.trace_dir:
        obs_trace.configure(args.trace_dir, run=f"train_{args.arch}")

    cfg = reduced_config(args.arch)
    params = lm.init_lm(0, cfg, device=dev)
    opt_cfg = AdamConfig(lr=3e-4, grad_clip=1.0)
    opt = adam_init_tree(params)
    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_checkpoint(args.ckpt_dir)
        if latest:
            state, meta = ckpt.restore_checkpoint(latest, {"params": params, "opt": opt},
                                                  device=dev)
            params, opt, start = state["params"], state["opt"], meta["step"]
            print(f"resumed from step {start}")

    reg = obs_metrics.get_registry()
    watcher = torchprof.get_watcher()
    # the training forward builds no kernel: a build of the serving
    # attention kernel after the first step is flagged
    watcher.watch("launch.train_step", flash_attention.build)
    tracer = obs_trace.get_tracer()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    rng = np.random.default_rng(start)
    compile_s = steady_s = 0.0
    losses = []
    for i in range(start, start + args.steps):
        batch = make_batch(rng, cfg, args.batch, args.seq, dev)
        t0s = time.perf_counter()
        params, opt, loss = train_step(params, opt, batch, cfg, opt_cfg)
        sync()
        loss = float(loss)
        dt = time.perf_counter() - t0s
        if i == start:
            compile_s = dt
            reg.gauge("train.compile_seconds").set(dt)
            obs_trace.instant("train.compile", cat="train", seconds=dt)
            watcher.rebase()
        else:
            steady_s += dt
            reg.histogram("train.step_seconds").observe(dt)
        if tracer is not None:
            tracer.complete("train.step", tracer.rel(t0s), dt, cat="train", step=i)
        losses.append(loss)
        print(f"step {i:4d} loss {loss:.4f}")
        if args.ckpt_dir and (i + 1) % CKPT_EVERY == 0:
            ckpt.save_checkpoint(args.ckpt_dir, i + 1, {"params": params, "opt": opt},
                                 device=dev)
    recompiles = watcher.check()
    steady_steps = max(args.steps - 1, 0)
    rate = steady_steps / steady_s if steady_s > 0 else float("nan")
    print(f"{args.steps} steps: first {compile_s:.2f}s + steady "
          f"{steady_s:.2f}s ({rate:.1f} steps/s steady-state; device {dev})")
    if recompiles:
        print(f"WARNING: {len(recompiles)} unexpected kernel build(s): "
              + ", ".join(e.name for e in recompiles))
    if args.trace_dir:
        paths = obs_trace.shutdown()
        print(f"trace: {paths['trace']}\nevents: {paths['events']}")
    return losses


if __name__ == "__main__":
    main()
