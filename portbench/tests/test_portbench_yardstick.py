"""The yardstick on the CPU: the busy union and idle gaps, the operation
and byte counts, the FLOP counter, the batch order, the reference against
the program's plain paths, and the rules the manifest and the modules keep."""
import ast
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, harness, traceread
from portbench.batches import SeedBatches

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# -- trace reduction -----------------------------------------------------------

def test_busy_union_of_hand_made_intervals():
    assert traceread.union_ns([]) == 0
    assert traceread.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert traceread.union_ns([(20, 30), (0, 40), (1, 2)]) == 40
    assert traceread.union_ns([(0, 10), (10, 20)]) == 20
    assert traceread.merged([(5, 6), (0, 3), (2, 4)]) == [(0, 4), (5, 6)]


def test_idle_gaps_named_by_the_innermost_open_host_event():
    device = [(0, 10, "k1"), (20, 30, "k2"), (100, 110, "k3")]
    host = [(1, 0, 200, "step"), (1, 15, 25, "aten::conv"), (1, 40, 90, "aten::empty"),
            (1, 0, 5, "cudaLaunchKernel"), (2, 0, 200, "other thread")]
    t = traceread.Trace(device, host)
    assert t.busy_ns() == 30
    gaps = dict(t.idle_gaps())
    assert gaps == {"aten::empty": 70e-9, "aten::conv": 10e-9}
    assert len(t.kernels()) == 3 and t.kernel_ns("k2") == 10


def test_device_ops_sum_by_short_name():
    t = traceread.Trace([(0, 10, "void k<1>(int*)"), (20, 25, "void k<1>(int*)"),
                         (30, 31, "Memcpy HtoD (Pageable -> Device)")])
    assert t.device_ops()[0] == ["k<1>", 15e-9]
    assert len(t.kernels()) == 2


# -- counts ------------------------------------------------------------------------

def test_surrogate_forward_flops_layer_by_layer():
    # 96x32, base 256: dense 7 -> 2*6*256, then (convT, conv) per stage, then out
    layers = {
        "proj": 2 * 7 * 3072,
        "up0_t": 2 * 256 * 128 * 16 * 6 * 2, "up0_c": 2 * 128 * 128 * 9 * 12 * 4,
        "up1_t": 2 * 128 * 64 * 16 * 12 * 4, "up1_c": 2 * 64 * 64 * 9 * 24 * 8,
        "up2_t": 2 * 64 * 32 * 16 * 24 * 8, "up2_c": 2 * 32 * 32 * 9 * 48 * 16,
        "up3_t": 2 * 32 * 32 * 16 * 48 * 16, "up3_c": 2 * 32 * 32 * 9 * 96 * 32,
        "out": 2 * 32 * 6 * 9 * 96 * 32,
    }
    got = dict(counts.surrogate_layers(96, 32, 6, 256, 7))
    assert got == pytest.approx(layers)
    assert sum(v for k, v in got.items() if k != "proj") == 172_621_824
    cfg = json.loads((BENCH / "configs" / "rt-dcgan.json").read_text())
    fwd = sum(layers.values())
    assert counts.train_step_flops(cfg, 64) == pytest.approx(64 * (3 * fwd - layers["proj"]))


def test_codec_counts_follow_the_launch_inputs():
    words = np.array([[3, 5], [0, 15]])
    nbytes, ops = counts.fa_gather_decode(words, samples=2)
    assert nbytes == 4 * 23 + 8 * 4 + 64 * 4 + 8 * 2
    assert ops == 128 * 23 + counts.DECODE_OPS_FRONT * 4
    nbytes, ops = counts.fa_encode(blocks=10)
    assert nbytes == 10 * 140
    assert ops == 10 * (counts.ENCODE_OPS_FRONT + counts.ENCODE_OPS_CHECK)
    nbytes, ops = counts.fr_decode(blocks=10, words=7)
    assert nbytes == 10 * (4 * 7 + 4) + 640
    assert ops == 10 * (96 * 7 + counts.FR_DECODE_OPS_FRONT)


# -- batch order -------------------------------------------------------------------

def test_batches_differ_within_an_epoch_and_repeat_by_seed():
    big = 2 ** 31 + 5
    a = SeedBatches(100, 8, 32, big)
    first = [b for _, b in zip(range(a.steps_per_epoch), a)]
    rows = np.concatenate(first)
    assert len(rows) == len(set(rows.tolist())) == 96
    b = SeedBatches(100, 8, 32, big)
    assert all(np.array_equal(x, y) for x, y in zip(first, b))
    ens = SeedBatches(100, 8, 32, big, members=3)
    draw = next(iter(ens))
    assert draw.shape == (3, 8) and np.array_equal(draw[0], first[0])
    assert not np.array_equal(draw[0], draw[1])


def test_batch_order_stops_when_the_window_closes():
    a = SeedBatches(64, 8, 32, 1)
    a.on_draw = lambda n: n < 5
    assert len(list(a.iter_epochs(None))) == 5


# -- the reference against the program's plain paths ---------------------------------

def test_reference_decode_equals_the_program_decode(tmp_path):
    from portbench import data
    from portbench.reference.zfp import ShardStore
    from repro_torch.datagen import resolve_store
    from portbench.tests.tiny import tiny_cell
    cfg = tiny_cell("pchip-resident").config
    sdir = data.produce_store(cfg, 7, str(tmp_path), "cpu")
    idx = np.array([0, 5, 35, 9, 17])
    prog = resolve_store(sdir, device="cpu").get_batch(idx)
    ref = ShardStore(sdir).decode(idx, "cpu")
    assert torch.equal(prog.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("over", [0, 1], ids=["at_tolerance", "one_ulp_over"])
def test_datagen_error_is_held_to_the_float32_tolerance(tmp_path, monkeypatch, over):
    """A decoded error of exactly the tolerance as float32 holds it (the
    encoder verifies ``err <= float32(tol)``); one float32 step more fails."""
    from portbench import check
    from portbench.reference import zfp
    from portbench.runners import datagen
    cfg = {"nsnaps": 3, "codec": {"tolerance": 1e-3}}
    (tmp_path / "production.json").write_text(json.dumps({"sims": [{}]}))
    snaps = torch.linspace(0.25, 0.75, 3 * 8 * 8 * 2).reshape(3, 8, 8, 2)
    snaps[1, 2, 3, 1] = 0.0
    recs = zfp.encode_records(snaps.movedim(-1, 1), 1e-3)
    tol32 = torch.tensor(1e-3, dtype=torch.float32)
    err = tol32 if not over else torch.nextafter(tol32, torch.tensor(1.0))

    class Store:
        num_samples = 3

        def __init__(self, root):
            pass

        def record(self, i):
            return recs[i][:1], recs[i][1:]

        def decode(self, idx, device):
            out = snaps.movedim(-1, 1)[list(idx)].clone()
            out[1, 1, 2, 3] += err                  # the snapshot is 0 there: exact
            return out

    monkeypatch.setattr(zfp, "ShardStore", Store)
    got = datagen._numbers(cfg, str(tmp_path), [0], lambda sim: snaps)
    limits = json.loads((BENCH / "limits" / "pchip-datagen.json").read_text())
    assert got["record_mismatch"] == 0
    assert (got["linf_over_tol"] == 1.0) if not over else (got["linf_over_tol"] > 1.0)
    assert check.passed(check.judge(got, limits)) == (not over)


def test_reference_conditions_equal_the_program_conditions(tmp_path):
    from portbench import data
    from portbench.reference.data import conditions
    from repro_torch.datagen import scenario_conditions
    from portbench.tests.tiny import tiny_cell
    cfg = tiny_cell("pchip-hoststream").config
    sdir = data.produce_store(cfg, 3, str(tmp_path), "cpu")
    np.testing.assert_array_equal(conditions(sdir), scenario_conditions(sdir))


def test_reference_forward_matches_the_program_model():
    from portbench.reference import surrogate as ref
    from repro_torch.models.surrogate import Surrogate, SurrogateConfig
    cfg = dict(ny=32, nx=16, fields=6, base_channels=32, cond_dim=7)
    params = ref.init_params(cfg, 11, "cpu")
    model = Surrogate(SurrogateConfig(height=32, width=16, base_channels=32),
                      torch.Generator().manual_seed(0))
    model.load_state_dict(params)
    cond = torch.randn(4, 7, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ref.forward(params, cond, cfg), model(cond),
                               rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    from portbench.reference.surrogate import tf32_round
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10)])
    assert tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]


# -- the manifest's rules and the harness's look-ups ---------------------------------

def test_names_units_and_files_of_the_manifest():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for entry in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert set(x.get("workloads", cells)) <= cells
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["moves"] in e2e and "\n" not in x["layer"] and len(x["layer"]) <= 200
        assert (BENCH / "metrics" / f"{x['name']}.py").exists()
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for name in cells:
        cell = harness.load_cell(name)
        names = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.data": 1, "reprox": 1, "repro.core": 1,
            "jaxlib.xla": 1, "flax": 1, "torch": 1}
    assert harness.forbidden_modules(mods) == ["flax", "jaxlib.xla", "repro.core"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
    # __import__("x") with a constant name
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
                and node.args and isinstance(node.args[0], ast.JoinedStr)):
            yield from (v.value for v in node.args[0].values if isinstance(v, ast.Constant))


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops
        assert all(n.startswith("portbench.reference") for n in _imports(path)
                   if n.split(".")[0] == "portbench")


def test_check_budget_fits_the_full_manifest():
    secs = manifest()["run_seconds"]
    runs, cells = 2 + 14 * 24, 24
    assert 1 <= secs <= 51
    assert runs * (secs + 60) + cells * 2 * 90 + 1200 <= 43200
    assert math.isfinite(secs)
