"""Pretrain a reduced LM arch on the card with the compression feature set
wired in, the port's counterpart of ``examples/lm_pretrain.py``:
error-feedback gradient compression (each gradient, plus the residual the
last step left, through the fixed-rate codec at ``--grad-bits``; the
truncation error carried to the next step) and a lossy checkpoint of the
parameters at the end (fixed-rate, 14 bits).

On the card the codec is the CUDA fixed-rate encode and the fixed-accuracy
decode at uniform plane counts; ``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/lm_pretrain_torch.py --arch internlm2-1.8b --steps 20
      PYTHONPATH=src python examples/lm_pretrain_torch.py --device cpu --steps 5
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.compression import tree_flatten_with_path, tree_map
from repro_torch.configs import ALL_ARCHS, reduced_config
from repro_torch.core.grad_compress import compress_decompress
from repro_torch.device import resolve_device
from repro_torch.launch.train import adam_init_tree, apply_adam, loss_and_grads, make_batch
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamConfig

LOSSY_BITS = 14


def make_step(cfg, opt_cfg: AdamConfig, bits: int):
    """``step(params, opt, residual, batch) -> (params, opt, residual,
    loss, ghat)``: the loss and its gradients, ``gf = g + r``, ``ghat =
    compress_decompress(gf, bits)``, ``r = gf - ghat``, Adam on ``ghat``.

    Leaf by leaf, so one leaf's ``gf`` is alive at a time, and ``r`` is
    written into the residual's own tensors (the same values as the JAX
    example's new tree): at full width each f32 tree is 7.6 GB."""

    def step(params, opt, residual, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        pairs, treedef = tree_flatten_with_path(grads)
        del grads
        r = dict(tree_flatten_with_path(residual)[0])
        ghat = []
        while pairs:
            key, g = pairs.pop(0)
            gf = g.float() + r[key]
            del g
            ghat.append(compress_decompress(gf, bits))
            torch.sub(gf, ghat[-1], out=r[key])
        ghat = treedef.unflatten(ghat)
        params, opt = apply_adam(ghat, opt, params, opt_cfg)
        return params, opt, residual, loss, ghat

    return step


def main(argv=None) -> list:
    """Returns the per-step losses as floats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--grad-bits", type=int, default=12)
    ap.add_argument("--ckpt-dir", default=os.path.join("out", "lm_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    params = lm.init_lm(0, cfg, device=dev)
    opt_cfg = AdamConfig(lr=3e-4, grad_clip=1.0)
    opt = adam_init_tree(params)
    residual = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    rng = np.random.default_rng(0)
    bits = args.grad_bits
    step = make_step(cfg, opt_cfg, bits)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = make_batch(rng, cfg, 2, 64, dev)
        params, opt, residual, loss, _ = step(params, opt, residual, batch)
        losses.append(float(loss))
        if i % 5 == 0:
            print(f"step {i:3d} loss {losses[-1]:.4f}")
    print(f"{args.steps} steps in {time.time() - t0:.0f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(grad bits={bits}, {32 / bits:.1f}x collective compression; device {dev})")

    path = ckpt.save_checkpoint(args.ckpt_dir, args.steps, {"params": params},
                                lossy_bits=LOSSY_BITS, device=dev)
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    print(f"lossy checkpoint: {meta['raw_bytes'] / 1e6:.1f} MB -> "
          f"{meta['stored_bytes'] / 1e6:.1f} MB")
    return losses


if __name__ == "__main__":
    main()
