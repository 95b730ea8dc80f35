"""A plain reference of granite-4.0-h (``granitemoehybrid``) for the tests:
its forward, its next-token loss and, through autograd, its gradients, in
float32 with TF32 off, written from the published configuration
(https://huggingface.co/ibm-granite/granite-4.0-h-small, config.json) and
the layer equations of its model type.  Plain ``torch`` only: it imports
nothing of the port, of the JAX package or of JAX.

``cfg`` is a dictionary under config.json's own keys (``hidden_size``,
``layer_types``, ``num_local_experts`` ...), with two more for one chip of
an expert-parallel layer: ``router_experts``, the router's width, and
``expert_offset``, the first expert held; ``num_local_experts`` counts the
experts held.  Parameters are a dictionary ``embed`` (V, D), ``final_norm``
(D,) and ``layers``, a list of one dictionary a layer under the port's leaf
names (:func:`per_layer` cuts them from the port's stacks).

The model, layer by layer:

* ``h0 = embedding_multiplier * embed[tokens]``;
* a Mamba-2 layer: ``h + m * mamba(rms(h))``, then ``h + m * (moe(rms(h))
  + shared(rms(h)))``, ``m`` the residual multiplier; an attention layer
  the same with causal GQA (no position encoding, scores scaled by
  ``attention_multiplier``) in place of ``mamba``;
* Mamba-2: the input projection split into z, x, B, C (one group) and dt;
  a depthwise causal convolution of width ``mamba_d_conv`` with a bias over
  x, B, C and SiLU; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``;
  the recurrence ``s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T``, ``y_t =
  s_t C_t + D x_t``, one step at a time; the gated RMS norm of ``y *
  silu(z)``; the output projection;
* the MoE: router logits, each token's top ``num_experts_per_tok`` experts
  and the softmax of their logits as gates, each routed (token, expert)
  pair through that expert's SwiGLU, weighted by its gate; no capacity, no
  drops; plus the shared SwiGLU expert;
* logits ``rms(h) @ embed.T / logits_scaling``; the loss is the mean
  cross-entropy of the next token plus 0.01 times the sum over layers of
  the Switch load-balance loss ``E * sum_e f_e p_e``.

Departures from the published model, each deliberate:

* the router's logits are rounded to bfloat16 before the top-k, as the
  published bfloat16 model's router product gives them, so that the
  reference and a bfloat16 program route alike (an f32 logit that a bf16
  product would round past a near tie picks another expert);
* only the experts held (``expert_offset ..``) are computed: the result is
  this chip's part of the layer's output, as the program's;
* sequences are packed without document masks, as the program trains;
* the load-balance coefficient, 0.01, is the port's (the published config
  leaves the aux out of its loss).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

AUX_COEF = 0.01
MAMBA_LEAVES = ("ssm_in", "ssm_conv_w", "ssm_conv_b", "ssm_A", "ssm_D", "ssm_dt_bias",
                "ssm_norm", "ssm_out")
ATTENTION_LEAVES = ("wq", "wk", "wv", "wo")


def per_layer(params: dict, layer_types) -> dict:
    """The port's stacked tree -> ``{"embed", "final_norm", "layers": [one
    dictionary a layer]}``, float32 copies: a mixer's leaves are stacked
    over the layers of its kind, the others over every layer."""
    own = {"mamba": MAMBA_LEAVES, "attention": ATTENTION_LEAVES}
    layers = []
    for i, kind in enumerate(layer_types):
        j = list(layer_types[:i]).count(kind)
        other = own["attention" if kind == "mamba" else "mamba"]
        layers.append({k: v[j if k in own[kind] else i].to(torch.float32, copy=True)
                       for k, v in params["layers"].items() if k not in other})
    return {"embed": params["embed"].to(torch.float32, copy=True),
            "final_norm": params["final_norm"].to(torch.float32, copy=True), "layers": layers}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mamba(lp: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Mamba-2 mixer, one group, the recurrence one token at a time."""
    b, s, _ = x.shape
    nh, p, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    di, k = nh * p, cfg["mamba_d_conv"]
    z, xbc, dt = torch.split(x @ lp["ssm_in"], [di, di + 2 * n, nh], dim=-1)
    w = lp["ssm_conv_w"].t()[:, None, :]                            # (C, 1, K)
    xbc = F.conv1d(xbc.transpose(1, 2), w, lp["ssm_conv_b"], padding=k - 1,
                   groups=w.shape[0])[..., :s].transpose(1, 2)
    xs, bm, cm = torch.split(F.silu(xbc), [di, n, n], dim=-1)
    xs = xs.reshape(b, s, nh, p)
    dt = F.softplus(dt + lp["ssm_dt_bias"])                          # (B, S, H)
    a = -torch.exp(lp["ssm_A"])
    state = x.new_zeros((b, nh, p, n))
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[:, :, None, None]
        state = state * decay + (dt[:, t, :, None] * xs[:, t])[..., None] * bm[:, t, None, None, :]
        ys.append((state @ cm[:, t, None, :, None])[..., 0] + lp["ssm_D"][:, None] * xs[:, t])
    y = torch.stack(ys, 1).reshape(b, s, di)
    return rms_norm(y * F.silu(z), lp["ssm_norm"], cfg["rms_norm_eps"]) @ lp["ssm_out"]


def attention(lp: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Causal GQA without a position encoding, scores times the attention
    multiplier."""
    b, s, d = x.shape
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // h
    q = (x @ lp["wq"].reshape(d, -1)).reshape(b, s, h, dh)
    k = (x @ lp["wk"].reshape(d, -1)).reshape(b, s, hkv, dh)
    v = (x @ lp["wv"].reshape(d, -1)).reshape(b, s, hkv, dh)
    k = k[:, :, torch.arange(h) // (h // hkv)]                      # head i: KV head i // g
    v = v[:, :, torch.arange(h) // (h // hkv)]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), -1)
    y = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * dh)
    return y @ lp["wo"].reshape(h * dh, d)


def route(lp: dict, x: torch.Tensor, cfg: dict):
    """(top expert ids (N, k), gates (N, k), the Switch aux) of x (N, D)."""
    e, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    logits = (x @ lp["router"]).to(torch.bfloat16).float()
    top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    frac = torch.bincount(ids.reshape(-1), minlength=e).float() / x.shape[0]
    aux = e * (frac * torch.softmax(logits, -1).mean(0)).sum()
    return ids, torch.softmax(top, -1), aux


def moe(lp: dict, x: torch.Tensor, cfg: dict):
    """(this chip's part of the MoE's output, every pair routed to a held
    expert computed; the aux; the pairs routed to each held expert)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    ids, gates, aux = route(lp, xf, cfg)
    out, pairs = torch.zeros_like(xf), []
    for j in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero(ids == cfg["expert_offset"] + j, as_tuple=True)
        y = swiglu(xf[tok], lp["e_gate"][j], lp["e_up"][j], lp["e_down"][j])
        out = out.index_add(0, tok, y * gates[tok, slot, None])
        pairs.append(len(tok))
    return out.reshape(b, s, d), aux, pairs


def layer(lp: dict, h: torch.Tensor, cfg: dict, kind: str):
    """One layer: (h, its aux, the pairs routed to each held expert)."""
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = rms_norm(h, lp["ln1"], eps)
    h = h + m * (mamba(lp, x, cfg) if kind == "mamba" else attention(lp, x, cfg))
    x = rms_norm(h, lp["ln2"], eps)
    y, aux, pairs = moe(lp, x, cfg)
    return h + m * (y + swiglu(x, lp["s_gate"], lp["s_up"], lp["s_down"])), aux, pairs


def forward(params: dict, tokens: torch.Tensor, cfg: dict, pairs: Optional[list] = None):
    """tokens (B, S) -> (logits (B, S, V), the layers' summed aux); each
    layer's pairs a held expert, appended to ``pairs`` where given."""
    h = params["embed"][tokens.long()] * cfg["embedding_multiplier"]
    aux = h.new_zeros(())
    for lp, kind in zip(params["layers"], cfg["layer_types"]):
        h, a, routed = layer(lp, h, cfg, kind)
        aux = aux + a
        if pairs is not None:
            pairs.append(routed)
    logits = rms_norm(h, params["final_norm"], cfg["rms_norm_eps"]) @ params["embed"].t()
    return logits / cfg["logits_scaling"], aux


def loss(params: dict, tokens: torch.Tensor, labels: torch.Tensor, cfg: dict) -> torch.Tensor:
    logits, aux = forward(params, tokens, cfg)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
    return ce + AUX_COEF * aux


def loss_and_grads(params: dict, tokens, labels, cfg: dict):
    """(loss, gradients in ``params``' layout), TF32 off."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        leaves = _leaves(params)
        for t in leaves.values():
            t.requires_grad_(True)
        value = loss(params, tokens, labels, cfg)
        grads = torch.autograd.grad(value, list(leaves.values()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    for t in leaves.values():
        t.requires_grad_(False)
    return value.detach(), dict(zip(leaves, grads))


def _leaves(params: dict) -> Dict[str, torch.Tensor]:
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    for i, lp in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return out


def adam_step(params: dict, grads: Dict[str, torch.Tensor], state: List[dict], step: int,
              lr: float, clip: float, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> None:
    """One Adam update in place (gradients clipped to a global norm of
    ``clip``; bias corrections ``1 - b ** step``); ``state`` a one-element
    list holding the moments, filled at the first step."""
    leaves = _leaves(params)
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = min(1.0, clip / max(float(norm), 1e-12))
    if not state:
        state.append({k: (torch.zeros_like(t), torch.zeros_like(t)) for k, t in leaves.items()})
    with torch.no_grad():
        for k, t in leaves.items():
            g = grads[k] * scale
            m, v = state[0][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            t.sub_(lr * (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + eps))
