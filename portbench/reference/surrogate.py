"""Plain surrogate: the paper's DCGAN backbone, its L1 loss and Adam.

The model (paper Fig. 1): condition -> dense -> (H/16, W/16, C) -> layer
norm over channels, leaky ReLU (0.2) -> four stages of a 4x4 stride-2
transposed convolution (leaky ReLU), a 3x3 convolution, layer norm and
leaky ReLU, halving the channels down to 32 -> a 3x3 convolution to the
fields.  Parameters use PyTorch's layouts and the package's layer names
(``proj.w`` (in, out), ``up0_t.w`` (Cin, Cout, 4, 4), ``up0_c.w`` (Cout,
Cin, 3, 3), ``up0_ln.g`` ...), so one state dict of initial weights is
handed to the program and to this reference alike.

Training is plain autograd and Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrections ``1 - b ** t``) in float32.  ``tf32`` runs the convolutions
and the matmul with TF32 operands: on the card through PyTorch's flags, on
the CPU by rounding their operands to TF32's 10 mantissa bits.  ``fault``
plants one of the faults a training path can have, for the checks'
calibration: ``"frozen"`` (the update returns the state unchanged),
``"half_batch"`` (the loss over the first half of each batch) or
``"wrong_sample"`` (the first row of each batch decoded from the last
row's sample, another shard's).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


def stages(base_channels: int):
    c = base_channels
    for i in range(4):
        cout = max(c // 2, 32)
        yield i, c, cout
        c = cout


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """name -> (shape, fan_in or None for a bias / norm leaf, fill)."""
    h0, w0, c = cfg["ny"] // 16, cfg["nx"] // 16, cfg["base_channels"]
    out = {"proj.w": ((cfg["cond_dim"], h0 * w0 * c), cfg["cond_dim"], None),
           "proj.b": ((h0 * w0 * c,), None, 0.0),
           "ln_in.g": ((c,), None, 1.0), "ln_in.b": ((c,), None, 0.0)}
    for i, cin, cout in stages(c):
        out[f"up{i}_t.w"] = ((cin, cout, 4, 4), 16 * cin, None)
        out[f"up{i}_t.b"] = ((cout,), None, 0.0)
        out[f"up{i}_c.w"] = ((cout, cout, 3, 3), 9 * cout, None)
        out[f"up{i}_c.b"] = ((cout,), None, 0.0)
        out[f"up{i}_ln.g"] = ((cout,), None, 1.0)
        out[f"up{i}_ln.b"] = ((cout,), None, 0.0)
        c = cout
    out["out.w"] = ((cfg["fields"], c, 3, 3), 9 * c, None)
    out["out.b"] = ((cfg["fields"],), None, 0.0)
    return out


def init_params(cfg: dict, seed: int, device, members: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """He-normal weights from one ``torch.Generator`` on ``device`` seeded
    with ``seed`` (one draw for every weight of every member), zero biases,
    unit norm gains.  ``members``: a leading member axis."""
    shapes = param_shapes(cfg)
    lead = () if members is None else (members,)
    sizes = [math.prod(lead + s) for s, fan, _ in shapes.values() if fan]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device)
    parts = iter(torch.split(z, sizes))
    out = {}
    for name, (shape, fan, fill) in shapes.items():
        if fan:
            out[name] = next(parts).reshape(lead + shape) * math.sqrt(2.0 / fan)
        else:
            out[name] = torch.full(lead + shape, fill, device=device)
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even);
    gradients pass through unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return x + (((bits + bias) & ~0x1FFF).view(torch.float32) - x.detach())


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 operands on or off for the card's matmuls and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def forward(p: Dict[str, torch.Tensor], cond: torch.Tensor, cfg: dict,
            emulate_tf32: bool = False) -> torch.Tensor:
    """cond (B, cond_dim) -> (B, H, W, fields)."""
    r = tf32_round if emulate_tf32 else (lambda t: t)
    h0, w0, c = cfg["ny"] // 16, cfg["nx"] // 16, cfg["base_channels"]

    def norm(x, name):
        mu = x.mean(dim=1, keepdim=True)
        var = (x - mu).square().mean(dim=1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * p[name + ".g"][:, None, None]
                + p[name + ".b"][:, None, None])

    def act(x):
        return torch.where(x >= 0, x, 0.2 * x)

    x = r(cond) @ r(p["proj.w"]) + p["proj.b"]
    x = x.reshape(x.shape[0], h0, w0, c).permute(0, 3, 1, 2)
    x = act(norm(x, "ln_in"))
    for i, _, _ in stages(c):
        x = act(F.conv_transpose2d(r(x), r(p[f"up{i}_t.w"]), p[f"up{i}_t.b"],
                                   stride=2, padding=1))
        x = F.conv2d(r(x), r(p[f"up{i}_c.w"]), p[f"up{i}_c.b"], padding=1)
        x = act(norm(x, f"up{i}_ln"))
    x = F.conv2d(r(x), r(p["out.w"]), p["out.b"], padding=1)
    return x.permute(0, 2, 3, 1)


def train(cfg: dict, params0: Dict[str, torch.Tensor], cond: torch.Tensor,
          targets: Sequence[torch.Tensor], batches: Sequence[np.ndarray],
          lr: float, tf32: bool = False, fault: Optional[str] = None) -> dict:
    """Follow ``len(batches)`` steps from ``params0``.  ``targets[k]`` is
    batch k's decoded (B, H, W, fields) data, ``cond`` every sample's
    condition.  Returns the loss of each step, each leaf's gradient norm at
    step 1 and each leaf's change norm after the last step (float64)."""
    emulate = tf32 and cond.device.type != "cuda"
    p = {k: v.detach().clone().float() for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with precision(tf32 and not emulate):
        for t, (idx, tgt) in enumerate(zip(batches, targets), start=1):
            c = cond[torch.as_tensor(np.asarray(idx), device=cond.device)]
            if fault == "wrong_sample":
                tgt = torch.cat([tgt[-1:], tgt[1:]])
            if fault == "half_batch":
                c, tgt = c[:len(c) // 2], tgt[:len(tgt) // 2]
            leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
            loss = (forward(leaves, c, cfg, emulate) - tgt).abs().mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            if t == 1:
                grad_norms = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                              for k, g in zip(leaves, grads)}
            if fault == "frozen":
                continue
            with torch.no_grad():
                for k, g in zip(leaves, grads):
                    m[k] = B1 * m[k] + (1 - B1) * g
                    v2[k] = B2 * v2[k] + (1 - B2) * g.square()
                    mhat = m[k] / (1 - B1 ** t)
                    vhat = v2[k] / (1 - B2 ** t)
                    p[k] = p[k] - lr * (mhat / (torch.sqrt(vhat) + EPS))
    change = {k: float(torch.linalg.vector_norm(p[k] - params0[k].float(),
                                                dtype=torch.float64)) for k in p}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}
