"""The port's tree codec, residual-corrected codec and gradient compression.

Every case of ``tests/test_tree_codec.py`` on the port (its two-"device"
``jax.vmap`` cases on a 2-rank gloo group of spawned processes, its
one-device cases on a 1-rank group in this process), then the port held
to the JAX package on the same trees: ``encode_tree``'s payload, emax and
plane counts bit for bit, ``TreeCodecMeta.to_json``, ``tree_nbytes`` and
``tree_collective_bytes`` equal, ``compressed_psum_tree`` on two ranks bit
for bit against JAX's per-device output (the mean of two float32 values
halved is exact), and the residual codec's base stream bit for bit with
its corrections to a stated fraction of the tolerance.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.compression as jc
from repro.core import grad_compress as jgc

from repro_torch.compression import (TreeCodecMeta, api, codec_from_spec,
                                     codec_spec, decode_tree, encode_tree,
                                     get_codec, leaf_2d_shape, tree_flatten,
                                     tree_leaf_keys, tree_nbytes)
from repro_torch.core.grad_compress import (as_codec, compress_decompress,
                                            compressed_psum_tree,
                                            tree_collective_bytes)
from repro_torch.train.optimizer import AdamState

import torch_dist_worker as worker

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120
# the residual codec's decoded fields against JAX's, as a fraction of tol:
# the two ridge solves sum in different orders, so the corrections differ
# by float noise (measured worst 1.9e-4 of tol, on the "smooth" input)
RESIDUAL_REL_TOL = 1e-2


def _np_tree():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(32, 48)).astype(np.float32),
            "b": rng.normal(size=(128,)).astype(np.float32),
            "scale": np.asarray(1.5, np.float32),
            "step": np.asarray(7, np.int32)}


@pytest.fixture
def tree():
    return {k: torch.from_numpy(v) for k, v in _np_tree().items()}


@pytest.fixture
def group(tmp_path):
    """A 1-rank gloo group in this process (the JAX tests' one-device
    ``vmap`` axis)."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "pg"), 1),
                            rank=0, world_size=1)
    yield None
    dist.destroy_process_group()


def _ranks(case: str, tmp_path, world: int = 2) -> list:
    """Run ``case`` on a ``world``-rank gloo group of spawned processes;
    returns each rank's outputs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    store = tmp_path / f"{case}.store"
    outs = [tmp_path / f"{case}{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"),
                               case, str(r), str(world), str(store), str(outs[r])],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(o)) for o in outs]


# ---------------------------------------------------------------------------
# encode_tree / decode_tree (test_tree_codec.py's cases on the port)
# ---------------------------------------------------------------------------

def test_leaf_2d_shape_conventions():
    assert leaf_2d_shape((6, 8, 16)) == (48, 16)
    assert leaf_2d_shape((128,)) == (64, 2)
    assert leaf_2d_shape((100,)) == (1, 100)
    assert leaf_2d_shape(()) == (1, 1)


def test_tree_leaf_keys_match_flatten_order(tree):
    assert tree_leaf_keys(tree) == ["b", "scale", "step", "w"]
    nested = {"a": {"x": torch.zeros(3), "y": [torch.zeros(2), torch.zeros(2)]}}
    assert tree_leaf_keys(nested) == ["a/x", "a/y/0", "a/y/1"]


def test_tree_keys_and_order_equal_jax():
    """Sorted dict keys, sequence indices, NamedTuple fields as ".name",
    None holding no leaf: the port's keys equal jax.tree_util's."""
    from repro.train.optimizer import AdamState as JaxAdamState
    z = np.zeros(2, np.float32)
    nested = {"b": [z, (z, None, {"k": z})], "a": {"y": z, "x": z},
              "c10": z, "c9": z}
    jnested = jax.tree.map(jnp.asarray, nested)
    assert tree_leaf_keys(nested) == jc.tree_leaf_keys(jnested)
    params = {"ln_in": {"g": z, "b": z}, "out": {"w": z}}
    st = AdamState(step=torch.zeros((), dtype=torch.int32), m=params, v=params)
    jst = JaxAdamState(step=jnp.zeros((), jnp.int32), m=params, v=params)
    keys = tree_leaf_keys(st)
    assert keys == jc.tree_leaf_keys(jst)
    assert keys[:3] == [".step", ".m/ln_in/b", ".m/ln_in/g"]
    leaves, treedef = tree_flatten(nested)
    rebuilt = treedef.unflatten(leaves)
    assert tree_leaf_keys(rebuilt) == tree_leaf_keys(nested)
    assert isinstance(rebuilt["b"][1], tuple) and rebuilt["b"][1][1] is None
    rebuilt_st = tree_flatten(st)[1].unflatten(tree_flatten(st)[0])
    assert isinstance(rebuilt_st, AdamState)
    with pytest.raises(ValueError, match="fewer leaves"):
        treedef.unflatten(leaves[:-1])


def test_roundtrip_fixed_rate_preserves_structure_and_dtypes(tree):
    codec = get_codec("fixed_rate", bits_per_value=16)
    leaves, treedef = tree_flatten(tree)
    enc, meta = encode_tree(codec, tree)
    out = decode_tree(enc, meta, codec=codec, treedef=treedef)
    assert tree_flatten(out)[1] == treedef
    for k in tree:
        assert out[k].dtype == tree[k].dtype
        assert out[k].shape == tree[k].shape
        assert float((out[k].float() - tree[k].float()).abs().max()) < 0.01
    assert int(out["step"]) == 7


def test_noncompressible_leaves_pass_through_bit_exact(tree):
    codec = get_codec("fixed_rate", bits_per_value=8)
    enc, meta = encode_tree(codec, tree, min_size=1000)
    by_key = dict(zip(tree_leaf_keys(tree), enc))
    flags = {l.key: l.compressed for l in meta.leaves}
    assert flags == {"w": True, "b": False, "scale": False, "step": False}
    out = decode_tree(enc, meta, codec=codec)
    assert torch.equal(out[0], tree["b"])
    assert torch.equal(by_key["b"], tree["b"])


def test_fixed_accuracy_per_leaf_tolerances(tree):
    codec = get_codec("fixed_accuracy")
    enc, meta = encode_tree(codec, tree, tolerances={"w": 1e-3, "b": 1e-2})
    out = dict(zip(tree_leaf_keys(tree), decode_tree(enc, meta)))
    assert float((out["w"] - tree["w"]).abs().max()) <= 1e-3
    assert float((out["b"] - tree["b"]).abs().max()) <= 1e-2
    flags = {l.key: l.compressed for l in meta.leaves}
    assert not flags["scale"] and bool(out["scale"] == tree["scale"])


def test_scalar_tolerance_applies_everywhere(tree):
    codec = get_codec("fixed_accuracy")
    enc, meta = encode_tree(codec, tree, tolerances=5e-3)
    out = dict(zip(tree_leaf_keys(tree), decode_tree(enc, meta)))
    for k in ("w", "b", "scale"):
        assert float((out[k] - tree[k]).abs().max()) <= 5e-3


def test_meta_json_roundtrip_and_hashable(tree):
    codec = get_codec("fixed_rate", bits_per_value=12)
    _, meta = encode_tree(codec, tree)
    meta2 = TreeCodecMeta.from_json(json.loads(json.dumps(meta.to_json())))
    assert meta2 == meta and hash(meta2) == hash(meta)
    assert codec_spec(meta2.make_codec()) == codec_spec(codec)
    # a recorded backend of the JAX package's is accepted and selects
    # nothing; one it does not have is refused
    obj = meta.to_json()
    obj["codec"]["backend"] = "jnp"
    assert codec_spec(TreeCodecMeta.from_json(obj).make_codec()) == codec_spec(codec)
    obj["codec"]["backend"] = "cuda"
    with pytest.raises(ValueError, match="backend"):
        TreeCodecMeta.from_json(obj).make_codec()


def test_codec_spec_roundtrip_all_registered():
    for c in (get_codec("fixed_rate", bits_per_value=9),
              get_codec("fixed_accuracy", tolerance=1e-4),
              get_codec("fixed_accuracy+residual", tolerance=1e-3)):
        spec = codec_spec(c)
        assert spec["backend"] == "pallas"
        assert codec_spec(codec_from_spec(spec)) == spec
        assert codec_from_spec(dict(spec, backend="jnp")) == c
        with pytest.raises(ValueError, match="backend"):
            codec_from_spec(dict(spec, backend="triton"))


def test_encode_decode_repeat_bit_exact(tree):
    """The JAX case traces the round trip into jit and holds it to eager;
    the port has one path, so a second round trip, and the rebuilt tree,
    must equal the first bit for bit."""
    codec = get_codec("fixed_rate", bits_per_value=14)
    treedef = tree_flatten(tree)[1]
    runs = []
    for _ in range(2):
        enc, meta = encode_tree(codec, tree)
        runs.append(decode_tree(enc, meta, codec=codec, treedef=treedef))
    for a, b in zip(tree_flatten(runs[0])[0], tree_flatten(runs[1])[0]):
        assert torch.equal(a, b)


def test_tree_nbytes_accounting(tree):
    codec = get_codec("fixed_rate", bits_per_value=8)
    enc, meta = encode_tree(codec, tree)
    raw, stored = tree_nbytes(codec, enc, meta)
    assert raw == sum(l.numel() * l.element_size() for l in tree.values())
    assert stored < raw


# ---------------------------------------------------------------------------
# the tree codec against the JAX package
# ---------------------------------------------------------------------------

TREE_CODECS = [
    ("fr6", lambda: get_codec("fixed_rate", bits_per_value=6),
     lambda: jc.get_codec("fixed_rate", bits_per_value=6, backend="jnp"), None),
    ("fr12", lambda: get_codec("fixed_rate", bits_per_value=12),
     lambda: jc.get_codec("fixed_rate", bits_per_value=12, backend="jnp"), None),
    ("fr16", lambda: get_codec("fixed_rate", bits_per_value=16),
     lambda: jc.get_codec("fixed_rate", bits_per_value=16, backend="jnp"), None),
    ("fa_scalar", lambda: get_codec("fixed_accuracy"),
     lambda: jc.get_codec("fixed_accuracy", backend="jnp"), 3e-3),
    ("fa_per_leaf", lambda: get_codec("fixed_accuracy"),
     lambda: jc.get_codec("fixed_accuracy", backend="jnp"),
     {"w": 1e-3, "b": 2.5e-2, "conv/w": 4e-4}),
]


def _big_np_tree():
    t = _np_tree()
    t["conv"] = {"w": np.random.default_rng(9).normal(
        size=(3, 3, 8, 12)).astype(np.float32) * 0.1}
    return t


@pytest.mark.parametrize("name,make,jmake,tols", TREE_CODECS,
                         ids=[c[0] for c in TREE_CODECS])
def test_encode_tree_bits_equal_jax(name, make, jmake, tols):
    np_tree = _big_np_tree()
    tree = jax.tree.map(torch.from_numpy, np_tree)
    jtree = jax.tree.map(jnp.asarray, np_tree)
    enc, meta = encode_tree(make(), tree, min_size=64, tolerances=tols)
    jenc, jmeta = jc.encode_tree(jmake(), jtree, min_size=64, tolerances=tols)
    assert [l.key for l in meta.leaves] == [l.key for l in jmeta.leaves]
    assert [(l.shape, l.dtype, l.compressed) for l in meta.leaves] == \
        [(l.shape, l.dtype, l.compressed) for l in jmeta.leaves]
    assert any(l.compressed for l in meta.leaves)
    for e, je, spec in zip(enc, jenc, meta.leaves):
        if not spec.compressed:
            assert np.array_equal(e.numpy(), np.asarray(je)), spec.key
            continue
        for f in ("payload", "emax", "nplanes"):
            assert np.array_equal(getattr(e, f).numpy(),
                                  np.asarray(getattr(je, f))), (spec.key, f)
    assert tree_nbytes(make(), enc, meta) == jc.tree_nbytes(jmake(), jenc, jmeta)
    got = decode_tree(enc, meta, codec=make())
    want = jc.decode_tree(jenc, jmeta, codec=jmake())
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("codec_name,params", [
    ("fixed_rate", {"bits_per_value": 13}),
    ("fixed_accuracy", {"tolerance": 1e-3}),
    ("fixed_accuracy", {"tolerance": None}),
    ("fixed_accuracy+residual", {"tolerance": 2e-3}),
])
def test_meta_json_equals_jax(codec_name, params):
    np_tree = _big_np_tree()
    tols = {"w": 1e-3} if params.get("tolerance", 0) is None else None
    _, meta = encode_tree(get_codec(codec_name, **params),
                          jax.tree.map(torch.from_numpy, np_tree), min_size=100,
                          tolerances=tols)
    _, jmeta = jc.encode_tree(jc.get_codec(codec_name, backend="pallas", **params),
                              jax.tree.map(jnp.asarray, np_tree), min_size=100,
                              tolerances=tols)
    assert meta.to_json() == jmeta.to_json()
    assert TreeCodecMeta.from_json(jmeta.to_json()) == meta


@pytest.mark.parametrize("codec", [None, 6, 16])
def test_tree_collective_bytes_equal_jax(codec):
    np_tree = _big_np_tree()
    got = tree_collective_bytes(jax.tree.map(torch.from_numpy, np_tree), codec)
    want = jgc.tree_collective_bytes(jax.tree.map(jnp.asarray, np_tree), codec)
    assert got == tuple(int(x) for x in want)


# ---------------------------------------------------------------------------
# residual-corrected codec
# ---------------------------------------------------------------------------

def test_residual_codec_bounded_and_not_worse():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 32, 48))
                         .astype(np.float32))
    tol = 1e-2
    plain = get_codec("fixed_accuracy", tolerance=tol)
    corr = get_codec("fixed_accuracy+residual", tolerance=tol)
    dec_p = plain.decode_batch(plain.encode_batch(x))
    dec_c = corr.decode_batch(corr.encode_batch(x))
    assert float((dec_c - x).abs().max()) <= 2 * tol + 1e-6
    l1_p = (dec_p - x).abs().mean(dim=(1, 2))
    l1_c = (dec_c - x).abs().mean(dim=(1, 2))
    assert bool((l1_c <= l1_p + 1e-7).all())


def _smooth(n=2):
    h = np.linspace(0, 4 * np.pi, 64)
    return (np.sin(h)[None, :, None] * np.cos(h)[None, None, :]
            + 0.01 * np.random.default_rng(0).normal(size=(n, 64, 64))
            ).astype(np.float32)


def test_residual_codec_improves_smooth_fields():
    x = torch.from_numpy(_smooth())
    tol = 5e-2
    plain = get_codec("fixed_accuracy", tolerance=tol)
    corr = get_codec("fixed_accuracy+residual", tolerance=tol)
    l1_p = float((plain.decode_batch(plain.encode_batch(x)) - x).abs().mean())
    l1_c = float((corr.decode_batch(corr.encode_batch(x)) - x).abs().mean())
    assert l1_c < l1_p


def test_residual_codec_field_arrays_roundtrip():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 24, 32))
                         .astype(np.float32))
    corr = get_codec("fixed_accuracy+residual", tolerance=1e-3)
    rcf = corr.encode_batch(x)
    arrays = corr.field_to_arrays(rcf)
    assert {"payload", "emax", "nplanes", "weights", "tols"} <= set(arrays)
    rcf2 = corr.field_from_arrays(arrays, (24, 32), device="cpu")
    assert torch.equal(corr.decode_batch(rcf2), corr.decode_batch(rcf))


def test_residual_codec_nbytes_includes_weights():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 24, 32))
                         .astype(np.float32))
    plain = get_codec("fixed_accuracy", tolerance=1e-3)
    corr = get_codec("fixed_accuracy+residual", tolerance=1e-3)
    n_p = plain.nbytes(plain.encode_batch(x))
    n_c = corr.nbytes(corr.encode_batch(x))
    assert torch.equal(n_c, n_p + 4 * 7)


def test_residual_through_tree_and_checkpoint_arrays(tree):
    corr = get_codec("fixed_accuracy+residual", tolerance=1e-3)
    enc, meta = encode_tree(corr, tree)
    out = dict(zip(tree_leaf_keys(tree), decode_tree(enc, meta)))
    assert float((out["w"] - tree["w"]).abs().max()) <= 2e-3 + 1e-6


RESIDUAL_INPUTS = [
    ("normal", lambda: np.random.default_rng(3).normal(size=(4, 32, 48)), 1e-2),
    ("smooth", _smooth, 5e-2),
    ("smooth_fine", lambda: _smooth(3), 1e-3),
    ("ragged", lambda: np.random.default_rng(11).normal(size=(3, 2, 13, 22)), 3e-2),
]


@pytest.mark.parametrize("name,make,tol", RESIDUAL_INPUTS,
                         ids=[r[0] for r in RESIDUAL_INPUTS])
def test_residual_codec_matches_jax(name, make, tol):
    """Base stream bit for bit; gate decisions equal except where the two
    L1s lie within float rounding of each other; corrections (not the
    weights: the six features are nearly collinear on smooth fields) within
    RESIDUAL_REL_TOL * tol of JAX's."""
    xs = np.asarray(make(), np.float32)
    corr = get_codec("fixed_accuracy+residual", tolerance=tol)
    jcorr = jc.get_codec("fixed_accuracy+residual", tolerance=tol, backend="jnp")
    x = torch.from_numpy(xs)
    rcf = corr.encode_batch(x)
    jrcf = jcorr.encode_batch(jnp.asarray(xs))
    for f in ("payload", "emax", "nplanes"):
        assert np.array_equal(getattr(rcf.base, f).numpy(),
                              np.asarray(getattr(jrcf.base, f))), f
    assert np.array_equal(rcf.tols.numpy(), np.asarray(jrcf.tols))
    dec = corr.decode_batch(rcf)
    jdec = np.asarray(jcorr.decode_batch(jrcf))
    gate = rcf.weights.abs().sum(dim=1).numpy() > 0
    jgate = np.abs(np.asarray(jrcf.weights)).sum(axis=1) > 0
    base = corr._inner.decode_batch(rcf.base)
    dims = tuple(range(1, x.dim()))
    full = api._apply_corrector(base, api._fit_corrector(base, x - base), rcf.tols)
    l1_plain = (base - x).abs().mean(dim=dims).numpy()
    l1_corr = (full - x).abs().mean(dim=dims).numpy()
    near = np.abs(l1_corr - l1_plain) <= 4 * np.finfo(np.float32).eps * l1_plain
    assert np.array_equal(gate[~near], jgate[~near])
    same = gate == jgate
    worst = float(np.abs(dec.numpy()[same] - jdec[same]).max()) / tol
    assert worst <= RESIDUAL_REL_TOL, worst
    assert float((dec - x).abs().max()) <= 2 * tol + 1e-6
    if name.startswith("smooth"):
        assert gate.all()


# ---------------------------------------------------------------------------
# grad_compress
# ---------------------------------------------------------------------------

def test_compress_decompress_accepts_int_bits_and_codec():
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 96))
                         .astype(np.float32))
    errs = [float((compress_decompress(g, b) - g).abs().max()) for b in (8, 16, 24)]
    assert errs[0] > errs[1] > errs[2]
    ca = get_codec("fixed_accuracy", tolerance=1e-3)
    assert float((compress_decompress(g, ca) - g).abs().max()) <= 1e-3


def test_as_codec():
    c = as_codec(12)
    assert c.name == "fixed_rate" and c.bits_per_value == 12
    assert as_codec(c) is c


def test_compressed_psum_tree_two_tree_return_and_error_feedback(tmp_path):
    outs = _ranks("feedback", tmp_path)
    name = f"fr{worker.FEEDBACK_BITS}"
    g = worker.feedback_tree(0)["w"]
    for r, out in enumerate(outs):
        assert {k.split("/", 2)[2] for k in out} == {"w", "step_like"}
        assert out[f"{name}/mean/w"].shape == out[f"{name}/res/w"].shape == g.shape
    # both ranks agree on the mean (they averaged the same decoded tensors)
    assert np.array_equal(outs[0][f"{name}/mean/w"], outs[1][f"{name}/mean/w"])
    # error-feedback identity on rank 0: residual = input - decoded
    dec0 = compress_decompress(torch.from_numpy(g), worker.FEEDBACK_BITS).numpy()
    np.testing.assert_allclose(outs[0][f"{name}/res/w"], g - dec0, atol=1e-6)
    # int leaves pass through the mean raw with a zero residual
    assert outs[0][f"{name}/mean/step_like"] == 1
    assert outs[0][f"{name}/mean/step_like"].dtype == np.float32
    assert outs[0][f"{name}/res/step_like"] == 0
    assert outs[0][f"{name}/res/step_like"].dtype == np.int32


def test_compressed_psum_tree_two_ranks_equal_jax(tmp_path):
    outs = _ranks("parity", tmp_path)
    stacked = jax.tree.map(lambda a, b: jnp.stack([jnp.asarray(a), jnp.asarray(b)]),
                           worker.parity_tree(0), worker.parity_tree(1))
    jcodecs = {"fr8": 8, "fr16": 16,
               "fa1e-3": jc.get_codec("fixed_accuracy", tolerance=1e-3, backend="jnp")}
    for name in worker.PARITY_CODECS:
        mean, res = jax.vmap(lambda t: jgc.compressed_psum_tree(t, "dev", jcodecs[name]),
                             axis_name="dev")(stacked)
        for part, jt in (("mean", mean), ("res", res)):
            for key, leaf in zip(jc.tree_leaf_keys(jt), jax.tree_util.tree_leaves(jt)):
                for r in range(2):
                    got = outs[r][f"{name}/{part}/{key}"]
                    want = np.asarray(leaf[r])
                    assert got.dtype == want.dtype, (name, part, key)
                    assert np.array_equal(got, want), (name, part, key, r)


def test_compressed_psum_tree_residual_carry_reduces_bias(group):
    rng = np.random.default_rng(4)
    steps = [torch.from_numpy(rng.normal(size=(16, 32)).astype(np.float32))
             for _ in range(6)]
    bits = 6

    def run(carry_residual):
        res = {"g": torch.zeros_like(steps[0])}
        applied = torch.zeros_like(steps[0])
        for g in steps:
            mean, res = compressed_psum_tree({"g": g}, group, bits,
                                             residuals=res if carry_residual else None)
            applied = applied + mean["g"]
        want = sum(s.numpy() for s in steps)
        return float(np.abs(applied.numpy() - want).max())

    assert run(True) < run(False)


def test_compressed_psum_tree_fixed_accuracy_bound(group):
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(32, 32))
                         .astype(np.float32))
    ca = get_codec("fixed_accuracy", tolerance=1e-3)
    mean, res = compressed_psum_tree({"g": g}, group, ca)
    assert float((mean["g"] - g).abs().max()) <= 1e-3
    assert float(res["g"].abs().max()) <= 1e-3
    assert torch.equal(res["g"], g - mean["g"])      # one rank: mean = decoded


def test_tree_collective_bytes_ratio():
    rng = np.random.default_rng(8)
    grads = {"a": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))}
    raw, comp = tree_collective_bytes(grads, 8)
    assert raw == (64 * 64 + 256) * 4
    assert comp < raw / 2
    raw2, comp2 = tree_collective_bytes(grads, None)
    assert raw2 == comp2 == raw
