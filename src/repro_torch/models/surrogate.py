"""DCGAN-backbone generative surrogate (paper Fig. 1, nine conv layers).

Counterpart of ``repro/models/surrogate.py``: condition vector -> dense ->
(C, H/16, W/16) -> four upsampling stages (each convT + conv) -> output
conv.  The module runs NCHW inside; :meth:`Surrogate.forward` returns the
JAX package's (B, H, W, fields) layout.

A seed ensemble keeps its members' parameters stacked, ``{name: (N,
...)}`` (:func:`stack_params`), and runs them all through one
member-folded forward (``models/folded.py``).  :func:`functional_forward`
runs this module with one member's parameters in place of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn as tnn
from torch.func import functional_call

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import nn
from repro_torch.sim.solver import PARAM_DIM


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    height: int = 96
    width: int = 32
    fields: int = 6
    base_channels: int = 256
    cond_dim: int = PARAM_DIM + 1      # params + normalized time


def _stage_channels(cfg: SurrogateConfig):
    ch = cfg.base_channels
    for _ in range(4):
        cout = max(ch // 2, 32)
        yield ch, cout
        ch = cout


class Surrogate(tnn.Module):
    """The surrogate's parameters, one ``ParameterDict`` per JAX layer
    (``proj``, ``ln_in``, ``up{i}_t``, ``up{i}_c``, ``up{i}_ln``, ``out``),
    so ``state_dict`` keys read ``"up0_t.w"`` like the JAX pytree paths."""

    def __init__(self, cfg: SurrogateConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h0, w0, c = cfg.height // 16, cfg.width // 16, cfg.base_channels
        g = generator

        def pd(**kw):
            return tnn.ParameterDict({k: tnn.Parameter(v) for k, v in kw.items()})

        def ln(dim):
            return pd(g=torch.ones(dim), b=torch.zeros(dim))

        self.proj = pd(w=nn.he_normal((cfg.cond_dim, h0 * w0 * c), cfg.cond_dim, g),
                       b=torch.zeros(h0 * w0 * c))
        self.ln_in = ln(c)
        for i, (cin, cout) in enumerate(_stage_channels(cfg)):
            setattr(self, f"up{i}_t", pd(w=nn.he_normal((cin, cout, 4, 4), 16 * cin, g),
                                         b=torch.zeros(cout)))
            setattr(self, f"up{i}_c", pd(w=nn.he_normal((cout, cout, 3, 3), 9 * cout, g),
                                         b=torch.zeros(cout)))
            setattr(self, f"up{i}_ln", ln(cout))
        ch = cout
        self.out = pd(w=nn.he_normal((cfg.fields, ch, 3, 3), 9 * ch, g),
                      b=torch.zeros(cfg.fields))

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        """cond (B, cond_dim) -> (B, H, W, fields) normalized prediction."""
        cfg = self.cfg
        h0, w0 = cfg.height // 16, cfg.width // 16
        x = nn.dense(self.proj, cond)
        x = x.reshape(x.shape[0], h0, w0, cfg.base_channels).permute(0, 3, 1, 2)
        x = nn.layernorm_leaky_relu(self.ln_in, x)
        for i in range(4):
            x = nn.leaky_relu(nn.conv2d_transpose(getattr(self, f"up{i}_t"), x))
            x = nn.conv2d(getattr(self, f"up{i}_c"), x)
            x = nn.layernorm_leaky_relu(getattr(self, f"up{i}_ln"), x)
        return nn.conv2d(self.out, x).permute(0, 2, 3, 1)


def init_surrogate(cfg: SurrogateConfig, seed: int = 0,
                   device: DeviceLike = None) -> Surrogate:
    """He-normal init from a ``torch.Generator`` seeded with ``seed``, on
    ``device`` (the card unless ``device="cpu"``).  Its numbers differ from
    ``jax.random``; parity goes through :func:`params_from_jax`."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    return Surrogate(cfg, g).to(dev)


def apply_surrogate(model: Surrogate, cond: torch.Tensor) -> torch.Tensor:
    """cond: (B, cond_dim) -> (B, H, W, fields)."""
    return model(cond)


def l1_loss(model: Surrogate, cond, target) -> torch.Tensor:
    """Paper Eq. 1, mean-reduced; ``target`` is (B, H, W, fields)."""
    return (model(cond) - target).abs().mean()


def functional_forward(model: Surrogate, params: Mapping[str, torch.Tensor],
                       cond: torch.Tensor) -> torch.Tensor:
    """``model``'s forward with the parameters ``params`` (a state dict)
    in place of its own: cond (B, cond_dim) -> (B, H, W, fields)."""
    return functional_call(model, dict(params), (cond,))


def functional_l1_loss(model: Surrogate, params: Mapping[str, torch.Tensor],
                       cond, target) -> torch.Tensor:
    """:func:`l1_loss` with the parameters ``params``."""
    return (functional_forward(model, params, cond) - target).abs().mean()


def stack_params(members: Sequence[Mapping[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Member state dicts -> one stacked state dict ``{name: (N, ...)}``."""
    return {k: torch.stack([torch.as_tensor(m[k]) for m in members])
            for k in members[0]}


def member_params(stacked: Mapping[str, torch.Tensor], m: int
                  ) -> Dict[str, torch.Tensor]:
    """Member ``m``'s state dict out of a stacked one."""
    return {k: v[m] for k, v in stacked.items()}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX surrogate param tree -> this module's state dict.

    Dense weights keep their (in, out) layout; conv weights go from HWIO to
    (Cout, Cin, kh, kw); the transposed convs' weights are flipped
    spatially and stored (Cin, Cout, kh, kw) (see ``nn.conv2d_transpose``).
    Tensor leaves are converted on their own device and keep their dtype;
    array leaves (numpy, JAX) come back as float32 CPU tensors.
    """
    out = {}
    for layer, leaves in params.items():
        for name, v in leaves.items():
            t = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(np.array(v, np.float32))
            if name == "w" and t.dim() == 4:
                t = (t.flip(0, 1).permute(2, 3, 0, 1) if layer.endswith("_t")
                     else t.permute(3, 2, 0, 1))
            out[f"{layer}.{name}"] = t.contiguous()
    return out


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """This module's state dict -> the JAX surrogate's nested ``{layer:
    {name: tensor}}`` tree, the exact inverse of :func:`params_from_jax`
    (dense weights stay (in, out), conv weights go to HWIO, the transposed
    convs' weights are flipped back and stored HWIO), on the tensors' own
    device.  Checkpoints and their certification work on this layout: the
    tree codec blocks a leaf as (prod(shape[:-1]), shape[-1]), so the
    layout decides the blocks, the bits and the certified tolerances."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, t in params.items():
        layer, name = key.rsplit(".", 1)
        if name == "w" and t.dim() == 4:
            t = (t.permute(2, 3, 0, 1).flip(0, 1) if layer.endswith("_t")
                 else t.permute(2, 3, 1, 0))
        out.setdefault(layer, {})[name] = t.contiguous()
    return out


def adam_state_to_jax(state: AdamState) -> AdamState:
    """The port's ``AdamState`` (state-dict moments) -> the same state in
    the JAX layout: ``m`` and ``v`` as :func:`params_to_jax`, ``step`` an
    int32 scalar.  Flattens to the JAX package's ``.step``, ``.m/<layer>/
    <name>``, ``.v/...`` keys."""
    from repro_torch.train.optimizer import AdamState
    return AdamState(step=state.step.to(torch.int32),
                     m=params_to_jax(state.m), v=params_to_jax(state.v))


def adam_state_from_jax(state) -> AdamState:
    """Inverse of :func:`adam_state_to_jax`; also takes the JAX package's
    own ``AdamState`` (array leaves, converted to CPU tensors)."""
    from repro_torch.train.optimizer import AdamState
    step = state.step if isinstance(state.step, torch.Tensor) else \
        torch.from_numpy(np.array(state.step, np.int32))
    return AdamState(step=step.to(torch.int32), m=params_from_jax(state.m),
                     v=params_from_jax(state.v))


@dataclasses.dataclass
class FieldNormalizer:
    """Per-field affine normalization fitted on the training split."""
    mean: torch.Tensor   # (fields,)
    std: torch.Tensor    # (fields,)

    @classmethod
    def fit(cls, fields) -> "FieldNormalizer":
        m = np.asarray(fields).reshape(-1, fields.shape[-1])
        return cls(mean=torch.from_numpy(m.mean(0)),
                   std=torch.from_numpy(m.std(0) + 1e-6))

    def normalize(self, f):
        return (f - self.mean.to(f.device)) / self.std.to(f.device)

    def denormalize(self, f):
        return f * self.std.to(f.device) + self.mean.to(f.device)


def make_conditions(param_vecs, nsnaps: int) -> np.ndarray:
    """(N, PARAM_DIM) params -> (N*T, PARAM_DIM+1) per-timestep conditions."""
    n = param_vecs.shape[0]
    t = np.linspace(0.0, 1.0, nsnaps, dtype=np.float32)
    return np.concatenate([np.repeat(param_vecs, nsnaps, axis=0),
                           np.tile(t, n)[:, None]], axis=1)
