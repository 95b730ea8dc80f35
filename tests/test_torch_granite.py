"""granite-4.0-h-small on the port's LM training path, held to the plain
reference ``torch_granite_reference`` at a reduced size on the CPU: the
mixed stack of Mamba-2 and attention layers (NoPE, muP), the dropless MoE
over the experts a chip holds, the launcher's step and its in-place Adam,
the device ranges and counters, and serving's refusal of the mixed stack.

Tolerances, f32 throughout:

* loss: ``LOSS_RTOL`` 1e-5, the same arithmetic in another order (the
  chunked SSD against the reference's step-by-step recurrence, the grouped
  expert products against one product an expert);
* gradients: ``GRAD_RTOL`` 5e-3 of each tensor's largest element.  The
  router's logits are rounded to bf16 in both, as the published bf16
  router gives them; a logit that the two computations leave within f32
  rounding of a bf16 midpoint rounds the other way in one of them and
  moves that token's gates by a bf16 ulp (2^-8), which reaches the
  experts' gradients at about 2e-3 of their largest element;
* one Adam step: the parameters within 2 lr, where a gradient element near
  0 takes the other sign, and all but 0.1% of the elements within 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_granite_reference as ref
from repro_torch.compression import tree_flatten_with_path, tree_map
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import train as launch
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.train.optimizer import AdamConfig, AdamState, adam_update

ARCH = "granite-4.0-h-small"
LOSS_RTOL, GRAD_RTOL = 1e-5, 5e-3
LR = 3e-4
SHARES = [(8, 0), (4, 0), (3, 2), (2, 6)]          # (experts held, the first held)


def _cfg(held: int = 8, offset: int = 0, **kw):
    return dataclasses.replace(reduced_config(ARCH), experts_held=held, expert_offset=offset,
                               **kw)


def _ref_cfg(c) -> dict:
    """The reference's configuration: config.json's keys for ``c``."""
    return dict(hidden_size=c.d_model, num_attention_heads=c.num_heads,
                num_key_value_heads=c.num_kv_heads, mamba_n_heads=c.ssm_heads,
                mamba_d_head=c.ssm_head_dim, mamba_d_state=c.ssm_state,
                mamba_d_conv=c.ssm_conv, rms_norm_eps=c.norm_eps,
                residual_multiplier=c.residual_multiplier,
                embedding_multiplier=c.embedding_multiplier, logits_scaling=c.logits_scaling,
                attention_multiplier=c.attn_scale, router_experts=c.num_experts,
                num_experts_per_tok=c.experts_per_token, num_local_experts=c.held_experts,
                expert_offset=c.expert_offset, layer_types=c.layer_kinds)


def _batch(cfg, seed: int = 0, b: int = 2, s: int = 64):
    return launch.make_batch(np.random.default_rng(seed), cfg, b, s, "cpu")


def _flat(tree) -> dict:
    return dict(tree_flatten_with_path(tree)[0])


def _by_layer(tree, cfg) -> dict:
    """A tree in the port's layout -> the reference's leaves by name."""
    return ref._leaves(ref.per_layer(tree, cfg.layer_kinds))


def test_the_registry_holds_the_published_sizes():
    c = get_config(ARCH)
    assert (c.family, c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.hdim) == \
        ("mixed", 40, 4096, 32, 8, 128)
    assert [i for i, k in enumerate(c.layer_kinds) if k == "attention"] == [5, 15, 25, 35]
    assert (c.ssm_heads, c.ssm_head_dim, c.ssm_state, c.ssm_conv, c.ssm_conv_bias) == \
        (128, 64, 128, 4, True)
    assert (c.num_experts, c.held_experts, c.experts_per_token, c.d_ff, c.shared_expert_ff) == \
        (72, 72, 10, 768, 1536)
    assert (c.nope, c.attn_scale, c.embedding_multiplier, c.residual_multiplier,
            c.logits_scaling, c.norm_eps, c.vocab_size, c.tie_embeddings) == \
        (True, 1 / 128, 12.0, 0.22, 16.0, 1e-5, 100352, True)
    # 32B parameters, 9B active a token (the model card's 32B-A9B)
    assert round(lm.param_count(c) / 1e9, 1) == 32.2
    assert round(lm.active_param_count(c) / 1e9, 1) == 8.8
    one_stage = dataclasses.replace(c, num_layers=10, layer_kinds=c.layer_kinds[:10],
                                    experts_held=9)
    assert round(lm.param_count(one_stage) / 1e9, 2) == 2.41


def test_parameters_stack_each_mixer_over_its_own_layers():
    cfg = _cfg(3, 2)
    p = lm.init_lm(0, cfg, device="cpu")
    shapes = {k: tuple(v.shape) for k, v in p["layers"].items()}
    assert shapes["ssm_in"][0] == 9 and shapes["wq"][0] == 1 and shapes["router"][0] == 10
    assert shapes["e_gate"] == (10, 3, cfg.d_model, cfg.d_ff)
    assert shapes["router"] == (10, cfg.d_model, 8) and shapes["ssm_conv_b"][0] == 9
    assert lm.param_count(cfg) == sum(t.numel() for t in _flat(p).values())
    meta = lm.init_lm(0, cfg, device="meta")
    assert {k: (v.shape, v.dtype) for k, v in _flat(meta).items()} == \
        {k: (v.shape, v.dtype) for k, v in _flat(p).items()}


@pytest.mark.parametrize("held,offset", SHARES)
def test_loss_and_gradients_against_the_reference(held, offset):
    cfg = _cfg(held, offset)
    p = lm.init_lm(1, cfg, device="cpu")
    batch = _batch(cfg, 1)
    loss, grads = launch.loss_and_grads(p, cfg, batch)
    rloss, rgrads = ref.loss_and_grads(ref.per_layer(p, cfg.layer_kinds), batch["tokens"],
                                       batch["labels"], _ref_cfg(cfg))
    assert float(loss) == pytest.approx(float(rloss), rel=LOSS_RTOL)
    mine = _by_layer(grads, cfg)
    assert set(mine) == set(rgrads)
    for k, g in rgrads.items():
        err = float((mine[k] - g).abs().max() / g.abs().max().clamp_min(1e-30))
        assert err <= GRAD_RTOL, (k, err)


def test_one_launcher_step_against_the_reference():
    cfg = _cfg(3, 2)
    p = lm.init_lm(2, cfg, device="cpu")
    rp = ref.per_layer(p, cfg.layer_kinds)
    batch = _batch(cfg, 2)
    new, opt, loss = launch.train_step(p, launch.adam_init_tree(p), batch, cfg,
                                       AdamConfig(lr=LR, grad_clip=1.0))
    rloss, rgrads = ref.loss_and_grads(rp, batch["tokens"], batch["labels"], _ref_cfg(cfg))
    ref.adam_step(rp, rgrads, [], 1, LR, 1.0)
    assert float(loss) == pytest.approx(float(rloss), rel=LOSS_RTOL) and int(opt.step) == 1
    mine, want = _by_layer(new, cfg), ref._leaves(rp)
    diffs = torch.cat([(mine[k] - v).abs().flatten() for k, v in want.items()])
    assert float(diffs.max()) <= 2 * LR
    assert int((diffs > 1e-6).sum()) <= 1e-3 * diffs.numel()


def test_a_frequent_tokens_embedding_gradient_is_summed_in_f32():
    """bf16 embeddings, one token repeated 5,000 times: the stack's lookup
    gives the gradient's f32 sum rounded once to bf16, where indexing's
    backward stops growing at about a quarter of it."""
    table = torch.randn(16, 8).bfloat16().requires_grad_()
    tokens = torch.zeros(5000, dtype=torch.long)
    g = (torch.rand(5000, 8) * 0.01 + 0.01).bfloat16()
    want = g.float().sum(0).bfloat16()
    mine, = torch.autograd.grad(lm._EmbedRows.apply(table, tokens), table, g)
    assert torch.equal(mine[0], want) and not mine[1:].any()
    plain, = torch.autograd.grad(table[tokens], table, g)
    assert float((plain[0].float() - want.float()).abs().max()) > 0.5 * float(want.float().min())


def test_the_launcher_trains_it():
    losses = launch.main(["--arch", ARCH, "--device", "cpu", "--steps", "3", "--seq", "64"])
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_dropless_computes_every_pair_where_the_capacity_dispatch_drops():
    """Every token routes to expert 0 (a router column the inputs all point
    along): the dropless block computes each pair, as the reference does;
    the capacity dispatch (``moe_block``, capacity factor 1.25) keeps 60 of
    the 128 tokens' pairs with expert 0 and differs."""
    cfg = _cfg()
    lp = {k: v.clone() for k, v in lm._mixed_layer_params(lm.init_lm(3, cfg, device="cpu"),
                                                          cfg, 0).items()}
    lp["router"][:, 0] = 1.0
    x = torch.rand(2, 64, cfg.d_model) + 1.0
    y, aux = lm.moe_dropless(lp, x, cfg)
    ry, raux, pairs = ref.moe(lp, x, _ref_cfg(cfg))
    assert pairs[0] == 128 and sum(pairs) == 128 * cfg.experts_per_token
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5 * float(ry.abs().max()))
    assert float(aux) == pytest.approx(float(raux), rel=1e-6)
    capped, _ = lm.moe_block(lp, x, dataclasses.replace(cfg, moe_group=128))
    assert float((capped - ry).abs().max()) > 0.1 * float(ry.abs().max())


def test_shares_of_the_experts_add_up_to_the_whole_layer():
    """A layer run on four chips of two experts each: one chip's layer
    output (the mixer, the residuals and the shared expert, which every
    chip computes alike, counted once) plus the other three chips' MoE
    parts is the uncut reference layer, for a Mamba-2 and the attention
    layer."""
    whole = _cfg()
    p = lm.init_lm(4, whole, device="cpu")
    x = torch.randn(2, 64, whole.d_model)
    for i in (0, 5):
        kind, lp = whole.layer_kinds[i], lm._mixed_layer_params(p, whole, i)
        want, _, _ = ref.layer(ref.per_layer(p, whole.layer_kinds)["layers"][i], x,
                               _ref_cfg(whole), kind)
        total = None
        for s in range(4):
            cfg = _cfg(2, 2 * s)
            share = dict(lp, **{k: lp[k][2 * s:2 * s + 2] for k in ("e_gate", "e_up", "e_down")})
            if total is None:
                total, _ = lm.mixed_layer(share, x, cfg, kind)
                h = x + cfg.residual_multiplier * (
                    lm.ssm_block(share, lm.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg)[0]
                    if kind == "mamba" else
                    lm._nope_attention(share, lm.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg))
                xn = lm.rmsnorm(lp["ln2"], h, cfg.norm_eps)
            else:
                total = total + cfg.residual_multiplier * lm.moe_dropless(share, xn, cfg)[0]
        torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_expert_products_without_grouped_mm_agree(monkeypatch):
    """The fallback of one product per held expert (a build of PyTorch
    without ``_grouped_mm``) gives the grouped products' loss and
    gradients."""
    cfg = _cfg(3, 2)
    p = lm.init_lm(5, cfg, device="cpu")
    batch = _batch(cfg, 5)
    loss, grads = launch.loss_and_grads(p, cfg, batch)
    monkeypatch.delattr(torch, "_grouped_mm")
    loss2, grads2 = launch.loss_and_grads(p, cfg, batch)
    assert float(loss2) == pytest.approx(float(loss), rel=1e-6)
    for k, g in _flat(grads).items():
        torch.testing.assert_close(_flat(grads2)[k], g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", [ARCH, "internlm2-1.8b"])
def test_the_in_place_adam_gives_the_bits_of_new_tensors(arch):
    """Three launcher steps on bf16 parameters (f32 moments from step 0,
    everything updated in place) against ``adam_update`` returning new
    tensors from bf16 zero moments, as the launcher updated before: the
    same parameters and moments, bit for bit, in the same tensors."""
    cfg = dataclasses.replace(reduced_config(arch), param_dtype="bfloat16")
    old = lm.init_lm(0, cfg, device="cpu")
    new = tree_map(torch.clone, old)
    old_opt = AdamState(torch.zeros((), dtype=torch.int32), tree_map(torch.zeros_like, old),
                        tree_map(torch.zeros_like, old))
    opt = launch.adam_init_tree(new)
    ids = {k: id(t) for k, t in _flat(new).items()}
    oc = AdamConfig(lr=LR, grad_clip=1.0)
    for i in range(3):
        batch = _batch(cfg, i)
        _, grads = launch.loss_and_grads(old, cfg, batch)
        pairs, treedef = tree_flatten_with_path(tree_map(torch.Tensor.float, grads))
        p2, st = adam_update(dict(pairs), AdamState(old_opt.step, _flat(old_opt.m),
                                                    _flat(old_opt.v)), _flat(old), oc)
        nest = lambda d: treedef.unflatten([d[k] for k, _ in pairs])     # noqa: E731
        old, old_opt = nest(p2), AdamState(st.step, nest(st.m), nest(st.v))
        new, opt, _ = launch.train_step(new, opt, batch, cfg, oc)
    assert {k: id(t) for k, t in _flat(new).items()} == ids
    for mine, want in ((new, old), (opt.m, old_opt.m), (opt.v, old_opt.v)):
        for k, t in _flat(want).items():
            assert torch.equal(_flat(mine)[k], t), k
    assert int(opt.step) == 3


def test_serving_refuses_the_mixed_stack():
    cfg = _cfg()
    p = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    calls = (lambda: lm.init_cache(cfg, 1, 16, device="cpu"),
             lambda: lm.lm_prefill(p, cfg, {"tokens": tokens}, 16),
             lambda: lm.serve_step(p, cfg, {}, tokens[:, 0], 0))
    for call in calls:
        with pytest.raises(ValueError, match="ROADMAP Queue 6"):
            call()


def test_ranges_and_counters_of_a_traced_step():
    """A step with a tracer configured records the phases' and the layers'
    device ranges; the registry's ``lm.moe.held_pairs`` grows by the pairs
    the reference routes to the held experts and ``lm.moe.max_expert_pairs``
    by each layer's busiest held expert (one forward a layer: no remat)."""
    cfg = _cfg(3, 2, remat="none")
    p = lm.init_lm(6, cfg, device="cpu")
    batch = _batch(cfg, 6)
    pairs = []
    with torch.no_grad():
        ref.forward(ref.per_layer(p, cfg.layer_kinds), batch["tokens"], _ref_cfg(cfg), pairs)
    reg = get_registry()
    before = {n: float(reg.counter(f"lm.moe.{n}").value) for n in ("held_pairs",
                                                                   "max_expert_pairs")}
    tracer = obs_trace.configure()
    try:
        launch.train_step(p, launch.adam_init_tree(p), batch, cfg,
                          AdamConfig(lr=LR, grad_clip=1.0))
        names = [e["name"] for e in tracer.events()]
    finally:
        obs_trace.shutdown(write=False)
    for name, count in (("lm.forward", 1), ("lm.backward", 1), ("lm.optimizer", 1),
                        ("lm.mamba", 9), ("lm.attention", 1), ("lm.moe", 10)):
        assert names.count(name) == count, name
    grew = {n: float(reg.counter(f"lm.moe.{n}").value) - v for n, v in before.items()}
    assert grew == {"held_pairs": sum(map(sum, pairs)), "max_expert_pairs": sum(map(max, pairs))}
