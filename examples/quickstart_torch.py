"""Quickstart on the port: the paper's pipeline in one short run, the
counterpart of ``examples/quickstart.py``.

1. run a miniature Rayleigh-Taylor simulation (the spectral solver),
2. compress its fields with the error-bounded ZFP codec,
3. find the safe tolerance with Algorithm 1 (no retraining),
4. train a few steps of the DCGAN-backbone surrogate on the compressed data.

On the card the codec is the CUDA fixed-accuracy encode and decode;
``--device cpu`` runs their plain versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.compression import get_codec
from repro_torch.core import CompressedArrayStore, find_tolerance
from repro_torch.data import channels_last
from repro_torch.device import resolve_device
from repro_torch.models.surrogate import FieldNormalizer, SurrogateConfig, make_conditions
from repro_torch.sim import SimParams, run_simulation
from repro_torch.train.loop import TrainConfig, train_surrogate

TOLERANCES = (1e-1, 1e-2)


def main(argv=None) -> dict:
    """Prints what the JAX example prints; returns the device, the codec's
    max error and ratio per tolerance, the Algorithm 1 result, the logged
    losses and the store's ratio."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. simulate (Boussinesq spectral RT, 48x16, 11 snapshots)")
    fields = run_simulation(SimParams(atwood=0.5, amplitude=0.03), ny=48, nx=16,
                            nsteps=400, nsnaps=11, device=dev).cpu().numpy()
    print(f"   fields: {fields.shape}, density in [{fields[..., 0].min():.2f}, "
          f"{fields[..., 0].max():.2f}]")

    print("== 2. error-bounded compression")
    sample = torch.from_numpy(np.ascontiguousarray(
        np.transpose(fields[5], (2, 0, 1)))).to(dev)
    codec = get_codec("fixed_accuracy", backend="jnp")
    compression = []
    for tol in TOLERANCES:
        cf = codec.encode_batch(sample[None],
                                torch.tensor([tol], dtype=torch.float32, device=dev))
        err = float((codec.decode_batch(cf)[0] - sample).abs().max())
        ratio = sample.numel() * 4 / int(codec.nbytes(cf)[0])
        compression.append({"tolerance": tol, "max_err": err, "ratio": ratio,
                            "bound_holds": err <= tol})
        print(f"   tol={tol:g}: max_err={err:.2e} (bound holds: {err <= tol}) "
              f"ratio={ratio:.1f}x")

    print("== 3. Algorithm 1 (model-centric tolerance, no retraining)")
    res = find_tolerance(sample, model_l1_error=0.05, device=dev)
    print(f"   tolerance={res.tolerance:.3g} ratio={res.ratio:.1f}x "
          f"iterations={res.iterations} (paper: converges in 1-2)")

    print("== 4. train surrogate on online-decompressed data (20 steps)")
    norm = FieldNormalizer.fit(fields)
    nf = norm.normalize(torch.from_numpy(fields)).numpy()
    samples = [np.transpose(x, (2, 0, 1)) for x in nf]
    store = CompressedArrayStore(samples, tolerances=[res.tolerance] * len(nf),
                                 device=dev)
    cond = make_conditions(np.tile(SimParams().as_vector(), (1, 1)), 11)
    cfg = SurrogateConfig(height=48, width=16, base_channels=16)
    tc = TrainConfig(epochs=20, batch_size=8, lr=1e-3, log_every=5)
    _, losses = train_surrogate(cfg, tc, cond, store, target_transform=channels_last,
                                device=dev)
    print(f"   losses: {[(s, round(l, 3)) for s, l in losses[:6]]}")
    print(f"   store ratio {store.ratio:.1f}x, "
          f"decode throughput {store.stats.throughput_mbs():.0f} MB/s")
    print("done.")
    return {"device": dev.type, "compression": compression,
            "algorithm1": {"tolerance": res.tolerance, "ratio": res.ratio,
                           "iterations": res.iterations},
            "losses": losses, "store_ratio": store.ratio}


if __name__ == "__main__":
    main()
