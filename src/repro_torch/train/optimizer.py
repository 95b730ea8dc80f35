"""Adam / AdamW on dicts of tensors, and the warm-up + cosine learning-rate
scale, as ``repro/train/optimizer.py`` writes them.

Deliberately not ``torch.optim.Adam``: this keeps the reference's order of
operations (f32 bias corrections ``1 - b ** step``, then
``mhat / (sqrt(vhat) + eps)``) so trajectories compare across packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    step: torch.Tensor     # () int32
    m: Tensors
    v: Tensors


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = None


def adam_init(params: Tensors, cfg: AdamConfig) -> AdamState:
    del cfg
    dev = next(iter(params.values())).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def global_norm(tensors: Tensors, stacked: bool = False) -> torch.Tensor:
    """The L2 norm over all tensors, ``()``; with ``stacked``, one norm per
    member of tensors stacked on a leading member axis, ``(N,)`` (each over
    dims 1..), never one over the stack."""
    if stacked:
        return torch.sqrt(sum(x.float().square().flatten(1).sum(dim=1)
                              for x in tensors.values()))
    return torch.sqrt(sum(x.float().square().sum() for x in tensors.values()))


@torch.no_grad()
def adam_update(grads: Tensors, state: AdamState, params: Tensors,
                cfg: AdamConfig, lr_scale: float = 1.0, stacked: bool = False,
                inplace: bool = False):
    """Returns (new_params, new_state); inputs are left unchanged.

    ``stacked``: every tensor carries a leading member axis ``(N, ...)``
    (the seed ensemble).  The moment updates are elementwise, so one update
    of the stack is N member updates; only ``grad_clip`` differs, and
    clips each member by its own global norm.

    ``inplace``: the new parameters, moments and step count are written
    into ``params`` and ``state``'s own tensors, which are returned (the
    static buffers of a step replayed from a CUDA graph); the same kernels
    and the same bits.  No host-to-device copy and no synchronise either
    way, so the update can be captured."""
    def into(t):
        return t if inplace else None

    if cfg.grad_clip is not None:
        gn = global_norm(grads, stacked)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
        grads = {k: g * (scale.reshape((-1,) + (1,) * (g.dim() - 1))
                         if stacked else scale)
                 for k, g in grads.items()}
    step = torch.add(state.step, 1, out=into(state.step))
    b1, b2 = cfg.b1, cfg.b2
    m = {k: torch.add(b1 * state.m[k], (1 - b1) * g, out=into(state.m[k]))
         for k, g in grads.items()}
    v = {k: torch.add(b2 * state.v[k], (1 - b2) * g.square(), out=into(state.v[k]))
         for k, g in grads.items()}
    step_f = step.to(torch.float32)
    # the bases filled on the device: a scalar upload would wait for the stream
    bc1 = 1 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                   device=step.device), step_f)
    bc2 = 1 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                   device=step.device), step_f)
    lr = cfg.lr * lr_scale

    def upd(p, mm, vv):
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p
        return torch.sub(p, lr * delta, out=into(p)).to(p.dtype)

    new_params = {k: upd(p, m[k], v[k]) for k, p in params.items()}
    return new_params, AdamState(step=step, m=m, v=v)


def cosine_lr_scale(step, warmup: int, total: int, min_frac: float = 0.1
                    ) -> torch.Tensor:
    """Learning-rate multiplier at ``step`` (a number or a tensor of steps):
    linear warm-up to 1 over ``warmup`` steps, then a cosine decay that
    reaches ``min_frac`` at ``total`` and stays there; float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
