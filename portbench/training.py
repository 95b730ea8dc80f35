"""What the training runners share: the program's readings of its first
steps, and the reference that follows them.

The first steps of a run go through the window's own call and feed, on
batches whose rows all differ.  The program's readings are each step's
loss, each leaf's first gradient as the optimizer gets it (where the entry
exposes it) and each leaf's change after the first steps, as far as the
next step keeps them.  The reference follows the same steps from the same
initial weights and batches, on its own decode of the store's files and
its own conditions, after the window has closed and the program's state
has been freed.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check
from portbench.reference import data as ref_data
from portbench.reference import surrogate as ref_model
from portbench.reference.zfp import ShardStore

EPOCHS = 10 ** 6        # the window, not the epoch count, ends a run


class WindowClosed(Exception):
    """Raised by the window's hook to end ``train_surrogate``."""


def norms(tensors: Dict[str, torch.Tensor], base: Optional[Dict[str, torch.Tensor]] = None
          ) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t if base is None else t - base[k],
                                              dtype=torch.float64))
            for k, t in tensors.items()}


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def follow(cfg: dict, scenario_dir: str, params0: List[Dict[str, torch.Tensor]],
           member_batches: List[List[np.ndarray]], dev, tf32: bool = False,
           fault: Optional[str] = None) -> List[dict]:
    """The reference's readings of each member's first steps, from that
    member's initial weights and batches, on the conditions and the
    decoded (B, H, W, C) batches the reference's own code reads from the
    store's files."""
    store = ShardStore(scenario_dir)
    cond = torch.from_numpy(ref_data.conditions(scenario_dir)).to(dev)
    out = []
    for p0, batches in zip(params0, member_batches):
        targets = [store.decode(b, dev).permute(0, 2, 3, 1) for b in batches]
        out.append(ref_model.train(cfg, p0, cond, targets, batches,
                                   cfg["train"]["lr"], tf32=tf32, fault=fault))
    return out


def compare(programs: List[dict], references: List[dict]) -> Dict[str, float]:
    return check.worst([check.gaps(p, r) for p, r in zip(programs, references)])


def window_gap(numbers: Dict[str, float]) -> Dict[str, float]:
    """The loss gap of a timed call's logged step, under its own name."""
    return {"window_loss_gap": numbers["loss_gap"]}


FAULTS = ("frozen", "half_batch", "wrong_sample")


def calibration(follow_kw, programs: List[dict]) -> dict:
    """The program's numbers, the control's (the reference with TF32
    operands in the program's place) and each fault's (planted in the
    reference put in the program's place), each against the reference;
    ``follow_kw(**kw)`` runs the reference."""
    ref = follow_kw()
    out = {"program": compare(programs, ref),
           "control": compare(follow_kw(tf32=True), ref),
           "faults": {f: compare(follow_kw(fault=f), ref) for f in FAULTS}}
    out["worst_leaves"] = {
        key: sorted(((g, m, leaf) for m, (p, r) in enumerate(zip(programs, ref))
                     for leaf, g in check.leaf_gaps(p, r, key).items()), reverse=True)[:3]
        for key in ("grad_norm", "change_norm") if programs[0].get(key)}
    return out
