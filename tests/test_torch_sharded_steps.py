"""The port's sharded steps on real ranks: four CPU processes in a gloo
group (``tests/torch_shard_worker.py``, through a ``FileStore``).

* (data 2, model 2), reduced ``internlm2-1.8b`` and ``qwen3-moe-30b-a3b``
  with the JAX package's parameters carried across: the sharded
  ``loss_and_grads`` against JAX's single-device ``lm_loss`` and its
  gradients (1e-5 relative for the loss; each gradient to 1e-4 of its
  largest magnitude for the dense model, ``MOE_GRAD_RTOL`` for MoE, ROADMAP
  M3), the dense model's updated parameters against the unsharded port's
  ``train_step`` (Adam turns a near-zero gradient's rounding into up to
  2 lr), and the sharded prefill and decode logits against the unsharded
  port's (1e-5 of their largest magnitude).
* (pod 2, data 1, model 2), the pod-compressed step at 8 and 24 bits, as
  ``tests/test_dryrun.py:205-222`` holds the reference's: the 24-bit wire
  bytes exceed 1.5 times the 8-bit ones, the loss equals the raw step's
  within 1e-3 relative, the updated parameters are finite; and each rank's
  exchanged mean is bit for bit the mean, in the ring's order, of JAX's
  ``decode_tree(encode_tree(codec, g))`` of the two pods' shards.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.compression import decode_tree as jax_decode_tree
from repro.compression import encode_tree as jax_encode_tree
from repro.configs import reduced_config as jax_reduced_config
from repro.core.grad_compress import as_codec as jax_as_codec

from torch_lm_reference import load as load_reference
from torch_shard_worker import DECODE_STEPS, EXCHANGE_BITS, exchange_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_shard_worker.py")
WORLD = 4
GRAD_RTOL = 1e-4
MOE_GRAD_RTOL = 8e-3
LR = 1e-4


def _inputs(name, path):
    """The reference's parameters and a batch of 4 x 16 tokens, as npz."""
    jlm = load_reference().lm
    cfg = jax_reduced_config(name)
    params = jlm.init_lm(jax.random.PRNGKey(0), cfg)
    flat = {"p/" + "/".join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    flat.update(tokens=toks, labels=np.roll(toks, -1, 1))
    np.savez(path, **flat)
    return jlm, cfg, params, toks


def _spawn(case, tmp_path, in_path, out_path):
    store = str(tmp_path / f"store_{case.replace(':', '_')}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, WORKER, case, str(r), str(WORLD), store,
                               str(in_path), str(out_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.mark.parametrize("name, rtol", [("internlm2-1.8b", GRAD_RTOL),
                                        ("qwen3-moe-30b-a3b", MOE_GRAD_RTOL)])
def test_sharded_step_matches_jax_and_the_unsharded_port(name, rtol, tmp_path):
    jlm, cfg, params, toks = _inputs(name, tmp_path / "in.npz")
    _spawn(f"train:{name}", tmp_path, tmp_path / "in.npz", tmp_path / "out.npz")
    out = dict(np.load(tmp_path / "out.npz"))
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1))}
    loss, grads = jax.value_and_grad(jlm.lm_loss)(params, cfg, batch)
    np.testing.assert_allclose(out["loss"], float(loss), rtol=1e-5)
    for kp, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        key = "/".join(str(k.key) for k in kp)
        want = np.asarray(g, np.float32)
        np.testing.assert_allclose(out["g/" + key], want, rtol=0,
                                   atol=rtol * np.abs(want).max(), err_msg=key)
    if name == "internlm2-1.8b":
        for key in (k[2:] for k in out if k.startswith("u/")):
            np.testing.assert_allclose(out["u/" + key], out["w/" + key], rtol=0,
                                       atol=2 * LR, err_msg=key)
    for got, want in [("sp", "up")] + [(f"sd{i}", f"ud{i}") for i in range(DECODE_STEPS)]:
        np.testing.assert_allclose(out[got], out[want], rtol=0,
                                   atol=1e-5 * np.abs(out[want]).max(), err_msg=got)


def test_pod_compressed_step_and_its_exchange(tmp_path):
    _inputs("internlm2-1.8b", tmp_path / "in.npz")
    _spawn("pod", tmp_path, tmp_path / "in.npz", tmp_path / "out")
    outs = [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(WORLD)]
    for o in outs:
        assert o["perm_gc8"] > 0 and o["perm_gc24"] > 1.5 * o["perm_gc8"]
        for bits in (8, 24):
            assert bool(o[f"finite_gc{bits}"])
            np.testing.assert_allclose(o[f"loss_gc{bits}"], o["loss_raw"], rtol=1e-3)
    codec = jax_as_codec(EXCHANGE_BITS)

    def roundtrip(tree):
        """JAX's decode_tree(encode_tree(codec, g)), leaves by key (a dict
        flattens in sorted key order)."""
        enc, meta = jax_encode_tree(codec, {k: jnp.asarray(v) for k, v in tree.items()})
        return dict(zip(sorted(tree), map(np.asarray, jax_decode_tree(enc, meta, codec=codec))))

    rt = [roundtrip(exchange_tree(r)) for r in range(WORLD)]
    for r in range(WORLD):
        partner = r ^ 2                      # the same (data, model) place, other pod
        for k in exchange_tree(r):
            want = (rt[r][k] + rt[partner][k]) / np.float32(2)
            got = outs[r][f"x/{k}"]
            assert got.dtype == want.dtype and np.array_equal(got, want), (r, k)
