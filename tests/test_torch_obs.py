"""The port's telemetry against the JAX package's ``repro/obs``.

  * the recompile watcher (``obs/torchprof.py``) on a stand-in build function with
    ``_cache_size``: injected growth is flagged once, with the counter and
    the instant; ``rebase`` absorbs warm-up; a callable without a build
    cache raises; the kernel modules' build functions report an int on the CPU
    and build nothing;
  * ``annotation`` is the null span when telemetry is off, and
    ``profiler_trace`` writes a trace on the CPU;
  * the train loop's compile/dispatch split, the prefetch worker's
    ``train.fetch`` spans, every store's ``data.get_batch`` span and the
    ensemble's compile gauge and dispatch spans, as ``tests/test_obs.py``
    runs them (at width 16, not 8: ROADMAP Queue 3, F6);
  * a traced ``train_surrogate`` run of the port emits the span and instant
    names of the JAX package's run on the same inputs, less its
    ``train.window`` rate, plus the step phases' device ranges, and
    ``tools/trace_report.py`` reads the port's trace;
  * ``cosine_lr_scale`` against JAX's.
"""
import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.device_store import (DeviceResidentCompressedStore as
                                     JaxDeviceStore)
from repro.data.store import RawArrayStore as JaxRawStore
from repro.data.store import channels_last as jax_channels_last
from repro.models.surrogate import SurrogateConfig as JaxConfig
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import train_surrogate as jax_train_surrogate
from repro.train.optimizer import cosine_lr_scale as jax_cosine_lr_scale

from repro_torch.core.ensemble import train_ensemble
from repro_torch.data import (CompressedArrayStore, DeviceResidentCompressedStore,
                              RawArrayStore, ShardedCompressedStore, channels_last)
from repro_torch.kernels import flash_attention, zfp_codec
from repro_torch.models.surrogate import SurrogateConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import torchprof
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.train.loop import TrainConfig, train_surrogate
from repro_torch.train.optimizer import cosine_lr_scale

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

CFG = dict(height=16, width=16, base_channels=8)


@pytest.fixture
def clean_telemetry():
    """Fresh global tracers/registries of both packages around a test."""
    for trace, metrics in ((obs_trace, obs_metrics), (jax_trace, jax_metrics)):
        trace.shutdown(write=False)
        metrics.get_registry().reset()
    yield
    for trace, metrics in ((obs_trace, obs_metrics), (jax_trace, jax_metrics)):
        trace.shutdown(write=False)
        metrics.get_registry().reset()


def _study(n=32):
    fields = np.random.default_rng(0).normal(size=(n, 16, 16, 6)).astype(np.float32)
    cond = np.random.default_rng(1).normal(
        size=(n, SurrogateConfig(**CFG).cond_dim)).astype(np.float32)
    return cond, fields


# ---------------------------------------------------------------------------
# recompile watcher
# ---------------------------------------------------------------------------

class _BuildFunction:
    """Stands in for a kernel module's ``build``: each call builds one more
    library."""

    def __init__(self):
        self.built = 0

    def __call__(self):
        self.built += 1

    def _cache_size(self):
        return self.built


def test_watcher_flags_injected_growth_once(clean_telemetry):
    tracer = obs_trace.configure(run="w")
    build = _BuildFunction()
    build()                                   # warm-up build
    reg = MetricsRegistry()
    w = torchprof.RecompileWatcher(registry=reg)
    w.watch("f", build)
    assert w.sizes() == {"f": 1}
    assert w.check() == []                    # steady state: quiet
    build()                                   # injected rebuild
    (ev,) = w.check()
    assert (ev.name, ev.before, ev.after, ev.growth) == ("f", 1, 2, 1)
    assert reg.counter("jax.recompiles").value == 1
    assert w.check() == []                    # baseline absorbed the growth
    (inst,) = [e for e in tracer.events() if e["name"] == "recompile"]
    assert inst["ph"] == "i" and inst["args"] == {"fn": "f", "before": 1, "after": 2}


def test_watcher_rebase_absorbs_warmup():
    build = _BuildFunction()
    w = torchprof.RecompileWatcher(registry=MetricsRegistry())
    w.watch("g", build)
    build()                                   # expected first build
    w.rebase()
    assert w.check() == []


def test_watch_rejects_what_has_no_build_cache():
    with pytest.raises(TypeError, match="_cache_size"):
        torchprof.RecompileWatcher().watch("plain", lambda: None)
    assert torchprof.cache_size(lambda: None) is None


def test_kernel_build_functions_report_an_int_and_build_nothing():
    for build in (zfp_codec.build, flash_attention.build):
        assert torchprof.cache_size(build) == 0
    assert not zfp_codec._libs and not flash_attention._libs
    assert torchprof.get_watcher() is torchprof.get_watcher()


# ---------------------------------------------------------------------------
# regions and profiler capture
# ---------------------------------------------------------------------------

def test_annotation_is_the_null_span_when_off(clean_telemetry):
    assert torchprof.annotation("x") is obs_trace.NULL_SPAN
    assert torchprof.named_scope("x") is obs_trace.NULL_SPAN
    obs_trace.configure(run="a")
    region = torchprof.annotation("x")
    assert region is not obs_trace.NULL_SPAN
    with region:
        torch.ones(4).sum()


def test_profiler_trace_writes_a_trace_on_the_cpu(tmp_path, clean_telemetry):
    with torchprof.profiler_trace(None) as on:
        assert on is False
    obs_trace.configure(run="p")
    with torchprof.profiler_trace(str(tmp_path)) as on:
        assert on is True
        with torchprof.annotation("region.under.profile"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = tmp_path.glob("torch_profile.*.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "region.under.profile" in names


# ---------------------------------------------------------------------------
# the train loop's split, the stores' spans, the ensemble's gauge
# ---------------------------------------------------------------------------

def test_train_loop_compile_steady_split(tmp_path, clean_telemetry):
    obs_trace.configure(str(tmp_path), run="train")
    cond, fields = _study()
    tc = TrainConfig(epochs=2, batch_size=8, log_every=2)
    train_surrogate(SurrogateConfig(**CFG), tc, cond, RawArrayStore(fields, device="cpu"),
                    device="cpu")

    snap = obs_metrics.get_registry().snapshot()
    assert snap["train.compile_seconds"] > 0
    assert snap["train.steps"] == 8
    assert snap["train.dispatch_seconds"]["count"] == 7
    # the removed aggregates take nothing (other tests of the process may
    # have registered the names, e.g. the LM launcher's train.step_seconds)
    assert snap.get("train.steady_seconds", 0) == 0
    assert snap.get("train.step_seconds", {"count": 0})["count"] == 0
    assert snap.get("jax.recompiles", 0) == 0

    evs = obs_trace.get_tracer().events()
    steps = [e for e in evs if e["name"] == "train.step"]
    assert [e["args"]["step"] for e in steps] == list(range(1, 9))
    # the first step is the gauge, and the dispatch histogram holds the
    # other seven, each timed inside its step's span.  On the CPU the first
    # step builds nothing, so it need not be the slowest: the split is
    # checked by containment, not by order
    first, rest = steps[0]["dur"], [e["dur"] for e in steps[1:]]
    assert snap["train.compile_seconds"] <= first < snap["train.compile_seconds"] + 0.01
    hist = obs_metrics.get_registry().histogram("train.dispatch_seconds")
    assert hist.total <= sum(rest) < hist.total + 7 * 0.01
    assert sum(1 for e in evs if e["name"] == "train.compile") == 1
    assert not [e for e in evs if e["name"] == "train.window"]
    fetches = [e for e in evs if e["name"] == "train.fetch"]
    assert len(fetches) >= 8                   # prefetch worker traced
    assert {e["tid"] for e in fetches} != {steps[0]["tid"]}
    assert threading.get_ident() == steps[0]["tid"]
    gets = [e for e in evs if e["name"] == "data.get_batch"]
    assert len(gets) == len(fetches) and all(
        e["args"] == {"store": "raw", "batch": 8} for e in gets)
    assert not [e for e in evs if e["name"] == "recompile"]


def test_checkpoint_span(tmp_path, clean_telemetry):
    obs_trace.configure(run="ckpt")
    cond, fields = _study()
    tc = TrainConfig(epochs=1, batch_size=8, log_every=2, ckpt_dir=str(tmp_path),
                     ckpt_every_steps=2, prefetch=0)
    train_surrogate(SurrogateConfig(**CFG), tc, cond, RawArrayStore(fields, device="cpu"),
                    device="cpu")
    saves = [e for e in obs_trace.get_tracer().events() if e["name"] == "train.checkpoint"]
    assert [e["args"]["step"] for e in saves] == [2, 4]


def test_every_store_spans_its_get_batch(tmp_path, clean_telemetry):
    tracer = obs_trace.configure(run="stores")
    _, fields = _study(16)
    samples = np.ascontiguousarray(fields.transpose(0, 3, 1, 2))
    tols = np.full(16, 1e-2, np.float32)
    stores = {
        "raw": RawArrayStore(fields, device="cpu"),
        "zfp": CompressedArrayStore(samples, tols, device="cpu"),
        "sharded": ShardedCompressedStore(samples, tols, shard_size=8, device="cpu"),
        "device_resident": DeviceResidentCompressedStore.from_samples(
            samples, tols, device="cpu"),
    }
    for st in stores.values():
        st.get_batch(np.array([3, 1, 7]))
    gets = [e for e in tracer.events() if e["name"] == "data.get_batch"]
    assert [(e["cat"], e["args"]) for e in gets] == [
        ("data", {"store": k, "batch": 3}) for k in stores]


def test_ensemble_compile_gauge(clean_telemetry):
    tracer = obs_trace.configure(run="ens")
    cond, fields = _study(16)
    samples = np.ascontiguousarray(fields.transpose(0, 3, 1, 2))
    store = DeviceResidentCompressedStore.from_samples(samples, [1e-2] * 16, device="cpu")
    res = train_ensemble(SurrogateConfig(**CFG),
                         TrainConfig(epochs=1, batch_size=4, log_every=1), cond, store,
                         (0, 1), target_transform=channels_last, device="cpu")
    snap = obs_metrics.get_registry().snapshot()
    assert res.steps == 4 and snap["ensemble.steps"] == 4
    assert snap["ensemble.compile_seconds"] > 0
    assert snap["ensemble.dispatch_seconds"]["count"] == 3
    assert snap.get("ensemble.step_seconds", {"count": 0})["count"] == 0
    (ev,) = [e for e in tracer.events() if e["name"] == "ensemble.compile"]
    assert ev["args"]["members"] == 2 and ev["args"]["seconds"] > 0
    dispatches = [e for e in tracer.events() if e["name"] == "ensemble.dispatch"]
    assert [e["args"]["step"] for e in dispatches] == [1, 2, 3, 4]
    hist = obs_metrics.get_registry().histogram("ensemble.dispatch_seconds")
    assert hist.total <= sum(e["dur"] for e in dispatches[1:])


# ---------------------------------------------------------------------------
# the same names as the JAX package; trace_report reads the port's trace
# ---------------------------------------------------------------------------

def _names(events) -> set:
    return {(e["ph"], e["name"]) for e in events if e["ph"] in ("X", "i")}


@pytest.mark.parametrize("kind", ["raw", "device_resident"])
def test_trace_names_equal_the_jax_runs(tmp_path, clean_telemetry, kind):
    cond, fields = _study()
    samples = np.ascontiguousarray(fields.transpose(0, 3, 1, 2))
    tols = np.full(len(fields), 1e-2, np.float32)
    common = dict(epochs=2, batch_size=8, log_every=2, ckpt_every_steps=4)
    if kind == "raw":
        jstore, pstore, transform = (JaxRawStore(fields), RawArrayStore(fields, device="cpu"),
                                     None)
    else:
        jstore = JaxDeviceStore.from_samples(samples, tols)
        pstore = DeviceResidentCompressedStore.from_samples(samples, tols, device="cpu")
        transform = channels_last

    jax_trace.configure(run="jax")
    jax_train_surrogate(JaxConfig(**CFG), JaxTrainConfig(ckpt_dir=str(tmp_path / "jax"),
                                                         **common),
                        cond, jstore,
                        target_transform=transform and jax_channels_last)
    want = _names(jax_trace.get_tracer().events())

    obs_trace.configure(str(tmp_path / "trace"), run="port")
    train_surrogate(SurrogateConfig(**CFG), TrainConfig(ckpt_dir=str(tmp_path / "port"),
                                                        **common),
                    cond, pstore, target_transform=transform, device="cpu")
    events = obs_trace.get_tracer().events()
    got = _names(events)
    # the port has no train.window rate (a rate of dispatch times), and
    # adds each step phase's device range
    assert got == want - {("i", "train.window")}
    assert {("X", "train.step"), ("X", "train.fetch"), ("i", "train.compile"),
            ("X", "train.checkpoint")} <= got
    assert (("X", "data.get_batch") in got) == (kind == "raw")
    phases = {"train.forward", "train.backward", "train.optimizer"}
    if kind == "device_resident":
        phases.add("train.gather_decode")
    assert {e["name"] for e in events if e["ph"] == "R"} == phases

    import trace_report
    paths = obs_trace.shutdown()
    for path in (paths["events"], paths["trace"]):
        rep = trace_report.summarize(trace_report.load_events(path))
        assert rep["stages"]["train.step"]["count"] == 8
        assert rep["instants"]["train.compile"]["count"] == 1
        assert {n for ph, n in got if ph == "X"} == set(rep["stages"])


# ---------------------------------------------------------------------------
# the learning-rate schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup", [0, 7])
def test_cosine_lr_scale_matches_jax(warmup):
    total = 40
    steps = np.arange(total + 6)
    want = np.asarray(jax_cosine_lr_scale(jnp.asarray(steps), warmup, total))
    got = cosine_lr_scale(torch.from_numpy(steps), warmup, total).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for s in (0, warmup, total, total + 5):
        assert float(cosine_lr_scale(s, warmup, total)) == pytest.approx(
            float(jax_cosine_lr_scale(s, warmup, total)), rel=1e-6, abs=1e-7)
