"""An end-to-end run on the port, the counterpart of
``examples/train_surrogate.py``: generate an RT ensemble, train the
generative surrogate for a few hundred steps with fault-tolerant
checkpointing, evaluate physics metrics, and report the raw-vs-compressed
training comparison.

Run:  PYTHONPATH=src python examples/train_surrogate_torch.py [--sims 8] [--epochs 4]
      [--channels 64] [--compressed] [--lossy-ckpt-bits 16]
      [--ckpt-dir /tmp/surrogate_ckpt] [--device cpu]

Interrupting and re-running resumes from the newest checkpoint (the loop
stores model, optimizer and data-pipeline state atomically), so a stale
``--ckpt-dir`` resumes silently: give a fresh one for a fresh run.
``--lossy-ckpt-bits`` saves each checkpoint through the fixed-rate tree
codec (on the card the CUDA fixed-rate encode, and the decode on resume).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import CompressedArrayStore, find_tolerance
from repro_torch.data.store import RawArrayStore, channels_last
from repro_torch.device import resolve_device
from repro_torch.metrics import psnr, total_mass
from repro_torch.models.surrogate import (FieldNormalizer, SurrogateConfig,
                                          make_conditions)
from repro_torch.sim import RT_SPEC, generate_ensemble
from repro_torch.train.loop import TrainConfig, predict_fields, train_surrogate


def main(argv=None) -> dict:
    """Prints what the JAX example prints; returns the device, the steps
    this run trained, the logged losses, the density PSNR and the mass
    error."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sims", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--compressed", action="store_true")
    ap.add_argument("--lossy-ckpt-bits", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="/tmp/surrogate_ckpt")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="prefetch queue depth (0 = synchronous fetch)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    pvec, fields = generate_ensemble(RT_SPEC, args.sims, seed=0, device=dev)
    print(f"ensemble: {fields.shape} in {time.time() - t0:.0f}s")
    norm = FieldNormalizer.fit(fields)
    nsnaps = fields.shape[1]
    cond = make_conditions(pvec, nsnaps)
    nf = norm.normalize(torch.from_numpy(fields.reshape(-1, *fields.shape[2:]))).numpy()

    if args.compressed:
        res = find_tolerance(np.transpose(nf[nsnaps // 2], (2, 0, 1)), 0.05, device=dev)
        samples = [np.transpose(x, (2, 0, 1)) for x in nf]
        store = CompressedArrayStore(samples, tolerances=[res.tolerance] * len(nf),
                                     device=dev)
        print(f"compressed store: {store.ratio:.1f}x")
        transform = channels_last
    else:
        store = RawArrayStore(nf, device=dev)
        transform = None

    cfg = SurrogateConfig(height=RT_SPEC.ny, width=RT_SPEC.nx,
                          base_channels=args.channels)
    tc = TrainConfig(epochs=args.epochs, batch_size=32, lr=3e-4,
                     ckpt_dir=args.ckpt_dir, ckpt_every_steps=25,
                     lossy_ckpt_bits=args.lossy_ckpt_bits, log_every=10,
                     prefetch=args.prefetch)
    trained = []
    t0 = time.time()
    model, losses = train_surrogate(cfg, tc, cond, store,
                                    hooks=[lambda step, m, loss: trained.append(step)],
                                    target_transform=transform, device=dev)
    steps = args.epochs * (len(nf) // 32)
    io_s = store.stats.read_seconds + store.stats.decode_seconds
    span = (f"loss {losses[0][1]:.3f} -> {losses[-1][1]:.3f}" if losses
            else "no logged steps (run shorter than log_every or fully resumed)")
    print(f"trained ~{steps} steps in {time.time() - t0:.0f}s "
          f"(host io+decode {io_s:.1f}s, prefetch depth {args.prefetch}); {span}")

    # evaluate on the last simulation
    test = slice((args.sims - 1) * nsnaps, args.sims * nsnaps)
    pred = predict_fields(model, cond[test], device=dev)
    pred_raw = norm.denormalize(torch.from_numpy(pred)).to(dev)
    truth = torch.from_numpy(fields[-1]).to(dev)
    psnr_db = float(psnr(truth[..., 0], pred_raw[..., 0]).mean())
    print(f"PSNR density: {psnr_db:.1f} dB")
    m_t, m_p = total_mass(truth), total_mass(pred_raw)
    mass_err = float((m_p - m_t).abs().mean() / m_t.mean())
    print(f"mass rel err: {mass_err:.3f}")
    return {"device": dev.type, "steps": trained, "losses": losses,
            "psnr_db": psnr_db, "mass_rel_err": mass_err,
            "store_ratio": getattr(store, "ratio", 1.0)}


if __name__ == "__main__":
    main()
