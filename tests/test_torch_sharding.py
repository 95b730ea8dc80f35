"""The port's sharding rules against the JAX package's.

``repro_torch.distributed.sharding`` keeps the reference's rule tables and
spec vocabulary, so its spec trees are compared with JAX's
``PartitionSpec`` trees entry for entry: ``param_specs`` -> ``resolve_specs``
for every arch of the registry at full width on both production meshes
(JAX's shapes from ``jax.eval_shape(init_lm)``, its ``resolve_specs`` given a
stand-in mesh as ``tests/test_dryrun.py`` does), ``opt_specs``,
``batch_specs`` and ``cache_specs`` (every family, batches 1 to 128).  Then
the spec -> DTensor placement conversion, tuple axes included, on a fake
process group.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as jsh

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import PRODUCTION_SHAPES, init_fake_process_group
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamState

from torch_lm_reference import load as load_reference

MESHES = {"16x16": False, "2x16x16": True}
FAMILY_REPS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "mamba2-130m", "hymba-1.5b",
               "internvl2-2b", "seamless-m4t-large-v2")


class StandInMesh:
    """What JAX's ``resolve_specs`` reads of a mesh (test_dryrun.py:68-76)."""

    def __init__(self, multi_pod):
        shape, axes = PRODUCTION_SHAPES[multi_pod]
        self.axis_names = axes
        self.devices = np.empty(shape)


def _sizes(multi_pod):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return dict(zip(axes, shape))


def _jax_flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): tuple(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _port_flat(tree, prefix=""):
    if isinstance(tree, sh.P):
        return {prefix.rstrip("/"): tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    else:                                       # AdamState
        items = zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def jax_shapes():
    jlm = load_reference().lm
    return {name: jax.eval_shape(lambda n=name: jlm.init_lm(jax.random.PRNGKey(0),
                                                           jax_get_config(n)))
            for name in JAX_ARCHS}


def test_the_registries_agree():
    assert tuple(ALL_ARCHS) == tuple(JAX_ARCHS)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", ALL_ARCHS)
def test_param_specs_resolve_as_the_reference(name, mesh, jax_shapes):
    """Every leaf of every full-width arch, on both production meshes: the
    same spec before and after divisibility resolution, entry for entry."""
    multi = MESHES[mesh]
    shapes = jax_shapes[name]
    want_raw = jsh.param_specs(shapes)
    want = jsh.resolve_specs(want_raw, shapes, StandInMesh(multi))
    params = lm.init_lm(0, get_config(name), device="meta")
    got_raw = sh.param_specs(params)
    got = sh.resolve_specs(got_raw, params, _sizes(multi))
    assert _port_flat(got_raw) == _jax_flat(want_raw)
    assert _port_flat(got) == _jax_flat(want)
    assert {k: tuple(v.shape) for k, v in _leaf_shapes(params).items()} == \
        {"/".join(str(p.key) for p in path): tuple(leaf.shape)
         for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


def _leaf_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", FAMILY_REPS)
def test_opt_specs_as_the_reference(name, jax_shapes):
    shapes = jax_shapes[name]
    want = jsh.opt_specs(jsh.param_specs(shapes))
    got = sh.opt_specs(sh.param_specs(lm.init_lm(0, get_config(name), device="meta")))
    assert isinstance(got, AdamState) and got._fields == want._fields
    assert _port_flat(got) == _jax_flat(want)


@pytest.mark.parametrize("name", FAMILY_REPS)
def test_batch_specs_as_the_reference(name):
    for kind in ("train", "prefill", "decode"):
        for multi in (False, True):
            want = jsh.batch_specs(jax_get_config(name), kind, multi)
            got = sh.batch_specs(get_config(name), kind, multi)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (kind, multi)


@pytest.mark.parametrize("name", FAMILY_REPS)
def test_cache_specs_as_the_reference(name):
    """Every family, batches 1, 8, 16, 32 and 128 (below, at and above the
    batch axes' size), both meshes, and resolved against the caches'
    shapes."""
    jlm = load_reference().lm
    jcfg, cfg = jax_get_config(name), get_config(name)
    for batch in (1, 8, 16, 32, 128):
        for multi in (False, True):
            want = jsh.cache_specs(jcfg, batch, multi)
            got = sh.cache_specs(cfg, batch, multi)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}, (batch, multi)
            enc = 512 if cfg.encoder_layers else 0
            jshapes = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, 1024, enc_seq=enc))
            shapes = lm.init_cache(cfg, batch, 1024, device="meta", enc_seq=enc)
            jres = jsh.resolve_specs({k: want[k] for k in jshapes}, jshapes,
                                     StandInMesh(multi))
            res = sh.resolve_specs({k: got[k] for k in shapes}, shapes, _sizes(multi))
            assert {k: tuple(v) for k, v in res.items()} == \
                {k: tuple(v) for k, v in jres.items()}, (batch, multi)


def test_resolve_drops_nondividing_axes():
    """test_dryrun.py:68-76 on the port: 8 KV heads over model=16 replicate."""
    spec = {"w": sh.P(None, "data", "model", None)}
    shapes = {"w": torch.empty(24, 2048, 8, 128, device="meta")}
    want = jsh.resolve_specs({"w": JP(None, "data", "model", None)},
                             {"w": jax.ShapeDtypeStruct((24, 2048, 8, 128), np.float32)},
                             StandInMesh(False))
    got = sh.resolve_specs(spec, shapes, _sizes(False))
    assert got["w"] == sh.P(None, "data", None, None)
    assert tuple(got["w"]) == tuple(want["w"])
    # a tuple axis is dropped whole when the product does not divide
    got = sh.resolve_specs({"t": sh.P(("pod", "data"), None)},
                           {"t": torch.empty(16, 4, device="meta")}, _sizes(True))
    assert got["t"] == sh.P(None, None)


def test_one_name_tuples_read_as_the_name():
    assert sh.P(("data",), None) == sh.P("data", None)
    assert tuple(sh.P(("data",), None)) == tuple(JP(("data",), None))
    assert tuple(sh.P(("pod", "data"))) == tuple(JP(("pod", "data")))


@pytest.fixture
def fake_meshes():
    init_fake_process_group(8)
    from torch.distributed.device_mesh import init_device_mesh
    try:
        yield (init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")),
               init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model")))
    finally:
        dist.destroy_process_group()


def test_specs_become_placements_in_mesh_order(fake_meshes):
    single, multi = fake_meshes
    assert sh.placements(single, sh.P(None, "data", "model", None)) == (Shard(1), Shard(2))
    assert sh.placements(single, sh.P("model", None)) == (Replicate(), Shard(0))
    assert sh.placements(single, sh.P()) == (Replicate(), Replicate())
    # a tuple axis shards one tensor dim over both mesh dims, in mesh order
    assert sh.placements(multi, sh.P(("pod", "data"), None)) == (Shard(0), Shard(0),
                                                                  Replicate())
    assert sh.placements(multi, sh.P(None, ("pod", "data", "model"))) == (Shard(1),) * 3
    with pytest.raises(ValueError, match="pod"):
        sh.placements(single, sh.P("pod"))


def test_distribute_tree_keeps_each_ranks_shard(fake_meshes):
    """The resolved specs on a mesh: local shards of the expected sizes,
    the global shapes unchanged; ``make_shardings`` gives the same
    placements."""
    single, _ = fake_meshes
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), num_layers=2)
    params = lm.init_lm(0, cfg, device="meta")
    specs = sh.param_specs(params)
    dt = sh.distribute_tree(params, single, specs)
    assert tuple(dt["layers"]["wq"].placements) == (Shard(1), Shard(2))
    assert dt["layers"]["wq"].shape == params["layers"]["wq"].shape
    assert tuple(dt["layers"]["wq"].to_local().shape) == (2, 1024, 4, 128)
    # 8 KV heads over model=4 divide: sharded; embed's vocab 92544 over 4 too
    assert tuple(dt["layers"]["wk"].to_local().shape) == (2, 1024, 2, 128)
    assert tuple(dt["embed"].to_local().shape) == (92544 // 4, 2048)
    shardings = sh.make_shardings(single, specs, params)
    assert shardings["layers"]["wq"] == tuple(dt["layers"]["wq"].placements)
