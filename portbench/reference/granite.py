"""Plain granite-4.0-h (``granitemoehybrid``): its forward, next-token loss,
gradients (autograd) and Adam, in float32 with TF32 off, on one chip's
share of an expert-parallel deployment.

Written from the published configuration (config.json of
ibm-granite/granite-4.0-h-small, whose keys the configuration file
carries) and the layer equations of its model type:

* ``h0 = embedding_multiplier * embed[tokens]``;
* a Mamba-2 layer ``h + m * mamba(rms(h))``, then ``h + m * (moe(rms(h)) +
  shared(rms(h)))``; an attention layer the same with causal GQA (no
  position encoding, scores times ``attention_multiplier``) in place of
  ``mamba``; ``m`` the residual multiplier;
* Mamba-2: the input projection split into z, x, B, C (one group) and dt; a
  depthwise causal convolution with a bias over x, B, C and SiLU; ``dt =
  softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the state space model in
  the Mamba-2 paper's chunked form (chunks of ``mamba_chunk_size``); the
  gated RMS norm of ``y * silu(z)``; the output projection;
* the MoE: router logits rounded to bfloat16 (as the published bfloat16
  model's router product gives them), each token's top
  ``num_experts_per_tok`` of all ``router_experts`` and the softmax of
  their logits as gates; every pair routed to a held expert (``expert_offset``
  and the ``num_local_experts`` after it) through that expert's SwiGLU,
  weighted by its gate, none dropped: this chip's part of the layer's
  output; plus the shared SwiGLU expert;
* logits ``rms(h) @ embed.T / logits_scaling``; the loss is the mean
  next-token cross-entropy plus ``aux_coef`` times the layers' Switch
  load-balance losses ``E * sum_e f_e p_e``.

Sequences are packed without document masks.  To fit beside nothing else
on the card, a step runs its sequences one at a time: a first pass without
gradients counts each layer's routing over the whole batch (the aux's
``f_e``), then each sequence's share of the loss is differentiated and the
gradients summed, which is the whole batch's loss and gradient; every layer
is checkpointed, attention and the cross-entropy go in chunks of rows.

``control="fp8"`` rounds both operands of every product with a weight to
float8 (e4m3, scaled per tensor to its largest value), the precision below
the configuration's bfloat16; gradients pass through unrounded.
``fault`` plants one fault: ``"capacity"`` (the capacity dispatch of
capacity factor 1.25 in groups of 1,024 tokens, which drops the pairs past
an expert's capacity), ``"rope"`` (rotary positions in attention),
``"residual_1"`` (residual multiplier 1), ``"top8"`` (eight experts a
token), ``"frozen"`` (no update), ``"half_batch"`` (the loss over the
first half of the sequences) or ``"wrong_sample"`` (the first sequence
replaced by the last).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

B1, B2, EPS = 0.9, 0.999, 1e-8
ATTN_ROWS = 1024                    # query rows a chunk of attention
CE_ROWS = 1024                      # rows a chunk of the cross-entropy
CAPACITY_FACTOR, CAPACITY_GROUP = 1.25, 1024
FAULTS = ("capacity", "rope", "residual_1", "top8", "frozen", "half_batch",
          "wrong_sample")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 scaled to its largest value; the gradient
    passes through."""
    if not t.numel():
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


class Model:
    """The forward of one configuration, with a control or a fault."""

    def __init__(self, cfg: dict, control: Optional[str] = None,
                 fault: Optional[str] = None):
        self.cfg, self.fault = cfg, fault
        self.kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
        self.eps = cfg["rms_norm_eps"]
        self.m = 1.0 if fault == "residual_1" else cfg["residual_multiplier"]
        self.k = 8 if fault == "top8" else cfg["num_experts_per_tok"]
        self.r = _fp8 if control == "fp8" else (lambda t: t)

    def mm(self, x, w):
        return self.r(x) @ self.r(w)

    def rms(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * w

    def swiglu(self, x, g, u, d):
        return self.mm(F.silu(self.mm(x, g)) * self.mm(x, u), d)

    # -- mixers ---------------------------------------------------------------

    def mamba(self, p: dict, i: int, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s = x.shape[0]
        nh, hp, n = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
        di, k = nh * hp, c["mamba_d_conv"]
        z, xbc, dt = torch.split(self.mm(x, p[f"layers.{i}.ssm_in"]), [di, di + 2 * n, nh], -1)
        w = p[f"layers.{i}.ssm_conv_w"].t()[:, None, :]              # (C, 1, K)
        xbc = F.conv1d(xbc.t()[None], w, p[f"layers.{i}.ssm_conv_b"], padding=k - 1,
                       groups=w.shape[0])[0, :, :s].t()
        xs, bm, cm = torch.split(F.silu(xbc), [di, n, n], -1)
        dt = F.softplus(dt + p[f"layers.{i}.ssm_dt_bias"])               # (S, H)
        y = self.ssd(xs.reshape(s, nh, hp), dt, -torch.exp(p[f"layers.{i}.ssm_A"]), bm, cm)
        y = y + p[f"layers.{i}.ssm_D"][:, None] * xs.reshape(s, nh, hp)
        y = self.rms(y.reshape(s, di) * F.silu(z), p[f"layers.{i}.ssm_norm"])
        return self.mm(y, p[f"layers.{i}.ssm_out"])

    def ssd(self, x, dt, a, bm, cm):
        """The chunked state space model of one sequence: x (S, H, P), dt
        (S, H), a (H,), bm and cm (S, N); the state starts at 0."""
        s, h, hp = x.shape
        n = bm.shape[-1]
        c = min(self.cfg["mamba_chunk_size"], s)
        nc = s // c
        xw = (x * dt[..., None]).reshape(nc, c, h, hp)
        cum = torch.cumsum((dt * a).reshape(nc, c, h), 1)                # (NC, c, H)
        tril = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
        seg = cum.permute(0, 2, 1)[..., :, None] - cum.permute(0, 2, 1)[..., None, :]
        decay = torch.exp(seg.masked_fill(~tril, -math.inf))            # (NC, H, c, c)
        b, cc = bm.reshape(nc, c, n), cm.reshape(nc, c, n)
        scores = (cc @ b.transpose(1, 2))[:, None] * decay              # (NC, H, c, c)
        y = (scores @ xw.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)        # (NC, c, H, P)
        to_end = torch.exp(cum[:, -1:] - cum)                            # (NC, c, H)
        own = (xw * to_end[..., None]).reshape(nc, c, h * hp).transpose(1, 2) @ b
        state = x.new_zeros((h * hp, n))
        before = []
        for j in range(nc):
            before.append(state)
            state = (state.reshape(h, hp, n) * torch.exp(cum[j, -1])[:, None, None]
                     ).reshape(h * hp, n) + own[j]
        carried = cc @ torch.stack(before).transpose(1, 2)               # (NC, c, H*P)
        y = y + carried.reshape(nc, c, h, hp) * torch.exp(cum)[..., None]
        return y.reshape(s, h, hp)

    def attention(self, p: dict, i: int, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        s, d = x.shape
        h, hkv = c["num_attention_heads"], c["num_key_value_heads"]
        dh = d // h
        q = self.mm(x, p[f"layers.{i}.wq"].reshape(d, -1)).reshape(s, h, dh)
        k = self.mm(x, p[f"layers.{i}.wk"].reshape(d, -1)).reshape(s, hkv, dh)
        v = self.mm(x, p[f"layers.{i}.wv"].reshape(d, -1)).reshape(s, hkv, dh)
        if self.fault == "rope":
            q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
        heads = torch.arange(h, device=x.device) // (h // hkv)
        k, v = k[:, heads].transpose(0, 1), v[:, heads].transpose(0, 1)  # (H, S, dh)
        q = q.transpose(0, 1)
        scale = c["attention_multiplier"]

        def rows(q_blk, lo):
            sc = self.r(q_blk) @ self.r(k).transpose(1, 2) * scale      # (H, r, S)
            pos = torch.arange(lo, lo + q_blk.shape[1], device=x.device)
            keep = torch.arange(s, device=x.device)[None] <= pos[:, None]
            return torch.softmax(sc.masked_fill(~keep, -math.inf), -1) @ v

        y = torch.cat([checkpoint(rows, q[:, lo:lo + ATTN_ROWS], lo, use_reentrant=False)
                       for lo in range(0, s, ATTN_ROWS)], 1)             # (H, S, dh)
        return self.mm(y.transpose(0, 1).reshape(s, h * dh), p[f"layers.{i}.wo"].reshape(h * dh, d))

    # -- the MoE ----------------------------------------------------------------

    def route(self, p: dict, i: int, x: torch.Tensor):
        """(top ids (S, k), gates (S, k), softmax over all experts (S, E))."""
        logits = self.mm(x, p[f"layers.{i}.router"]).to(torch.bfloat16).float()
        top, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
        return ids[:, :self.k], torch.softmax(top[:, :self.k], -1), torch.softmax(logits, -1)

    def moe(self, p: dict, i: int, x: torch.Tensor, ids, gates) -> torch.Tensor:
        c = self.cfg
        keep = torch.ones_like(ids, dtype=torch.bool)
        if self.fault == "capacity":
            keep = self._within_capacity(ids)
        out = torch.zeros_like(x)
        for j in range(c["num_local_experts"]):
            tok, slot = torch.nonzero((ids == c["expert_offset"] + j) & keep, as_tuple=True)
            y = self.swiglu(x[tok], p[f"layers.{i}.e_gate"][j], p[f"layers.{i}.e_up"][j],
                            p[f"layers.{i}.e_down"][j])
            out = out.index_add(0, tok, y * gates[tok, slot, None])
        return out

    def _within_capacity(self, ids):
        """The pairs a capacity dispatch keeps: in groups of
        ``CAPACITY_GROUP`` tokens, each expert takes its pairs in (token,
        slot) order up to ``max(ceil(g k / E * 1.25), 4)``."""
        e, g = self.cfg["router_experts"], min(CAPACITY_GROUP, ids.shape[0])
        cap = max(math.ceil(g * self.k / e * CAPACITY_FACTOR), 4)
        onehot = F.one_hot(ids.reshape(-1, g * self.k), e)               # (G, g k, E)
        pos = (torch.cumsum(onehot, 1) - onehot).mul(onehot).sum(-1)
        return (pos < cap).reshape(ids.shape)

    # -- the model --------------------------------------------------------------

    def layer(self, p: dict, i: int, h: torch.Tensor, frac: Optional[torch.Tensor],
              n_tokens: int):
        """Layer i of one sequence: (h, aux share, expert counts)."""
        kind = self.kinds[i]
        x = self.rms(h, p[f"layers.{i}.ln1"])
        h = h + self.m * (self.mamba(p, i, x) if kind == "mamba" else self.attention(p, i, x))
        x = self.rms(h, p[f"layers.{i}.ln2"])
        ids, gates, probs = self.route(p, i, x)
        y = self.moe(p, i, x, ids, gates)
        y = y + self.swiglu(x, p[f"layers.{i}.s_gate"], p[f"layers.{i}.s_up"],
                            p[f"layers.{i}.s_down"])
        counts = torch.bincount(ids.reshape(-1), minlength=self.cfg["router_experts"])
        aux = (self.cfg["router_experts"] * (frac * probs.sum(0)).sum() / n_tokens
               if frac is not None else h.new_zeros(()))
        return h + self.m * y, aux, counts

    def embed(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        return p["embed"][tokens.long()] * self.cfg["embedding_multiplier"]

    def counts(self, p: dict, tokens: torch.Tensor) -> List[torch.Tensor]:
        """Each layer's expert counts over one sequence (no gradients)."""
        out = []
        with torch.no_grad():
            h = self.embed(p, tokens)
            for i in range(len(self.kinds)):
                h, _, c = self.layer(p, i, h, None, 1)
                out.append(c)
        return out

    def seq_loss(self, p: dict, tokens, labels, fracs, n_tokens: int) -> torch.Tensor:
        """One sequence's share of the batch's loss: its cross-entropy sum
        and its share of the aux, each over the batch's token count."""
        h = self.embed(p, tokens)
        aux = h.new_zeros(())
        for i in range(len(self.kinds)):
            h, a, _ = checkpoint(self.layer, p, i, h, fracs[i], n_tokens, use_reentrant=False)
            aux = aux + a
        h = self.rms(h, p["final_norm"])

        def ce(hx, lx):
            logits = self.mm(hx, p["embed"].t()) / self.cfg["logits_scaling"]
            return F.cross_entropy(logits, lx.long(), reduction="sum")

        total = sum(checkpoint(ce, h[lo:lo + CE_ROWS], labels[lo:lo + CE_ROWS],
                               use_reentrant=False) for lo in range(0, h.shape[0], CE_ROWS))
        return total / n_tokens + self.cfg["train"]["aux_coef"] * aux


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0 .. S-1 of x (S, H, D), rotating halves."""
    s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return torch.cat([x[..., :half] * cos - x[..., half:] * sin,
                      x[..., half:] * cos + x[..., :half] * sin], -1)


def train(cfg: dict, params0: Dict[str, torch.Tensor], batches: Sequence[dict], device,
          control: Optional[str] = None, fault: Optional[str] = None) -> dict:
    """Follow ``len(batches)`` steps from ``params0`` (name -> tensor, the
    names ``embed``, ``final_norm`` and ``layers.<i>.<leaf>``, read as
    float32 on ``device``); each batch ``{"tokens", "labels"}`` (B, S).
    Returns each step's loss, each leaf's gradient norm at step 1 and each
    leaf's change norm after the last step (float64)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _train(cfg, params0, batches, device, control, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _train(cfg, params0, batches, device, control, fault):
    model = Model(cfg, control, fault)
    lr, clip = cfg["train"]["lr"], cfg["train"]["grad_clip"]
    p = {k: v.detach().to(device, torch.float32, copy=True).requires_grad_(True)
         for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for t, batch in enumerate(batches, start=1):
        tokens, labels = batch["tokens"].to(device), batch["labels"].to(device)
        if fault == "wrong_sample":
            tokens, labels = torch.cat([tokens[-1:], tokens[1:]]), torch.cat([labels[-1:], labels[1:]])
        if fault == "half_batch":
            tokens, labels = tokens[:len(tokens) // 2], labels[:len(labels) // 2]
        n_tokens = tokens.numel()
        counts = [sum(c) for c in zip(*(model.counts(p, row) for row in tokens))]
        fracs = [c.float() / n_tokens for c in counts]
        loss = 0.0
        for row, lab in zip(tokens, labels):
            part = model.seq_loss(p, row, lab, fracs, n_tokens)
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        grads = {k: v.grad for k, v in p.items()}
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(g, dtype=torch.float64))
                          for k, g in grads.items()}
        with torch.no_grad():
            if fault != "frozen":
                norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
                scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
                for k, x in p.items():
                    g = grads[k] * scale
                    m[k].mul_(B1).add_((1 - B1) * g)
                    v2[k].mul_(B2).add_((1 - B2) * g.square())
                    x.sub_(lr * (m[k] / (1 - B1 ** t)) / (torch.sqrt(v2[k] / (1 - B2 ** t)) + EPS))
            for x in p.values():
                x.grad = None
    change = {k: float(torch.linalg.vector_norm(p[k].detach() - params0[k].to(device, torch.float32),
                                                dtype=torch.float64)) for k in p}
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change}
