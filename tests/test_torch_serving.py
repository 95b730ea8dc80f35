"""The port's scheduler, load generator, serving engine and launcher against
the JAX package's ``repro/serving``.

The reference is imported through ``torch_lm_reference`` (ROADMAP Queue 3,
R1).  Both engines serve the same seeded mixed-length workload on the same
reduced ``internlm2-1.8b`` weights (f32; the port's on the CPU), and must
return the same greedy tokens, request for request and in the same order,
with the same token and step counts.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config

from repro_torch.configs import reduced_config
from repro_torch.launch import serve as launcher
from repro_torch.models import lm
from repro_torch.serving import Request, ServeEngine, SlotScheduler
from repro_torch.serving.loadgen import (latency_percentiles, lm_workload,
                                         poisson_arrivals)

from torch_lm_reference import load as load_reference

torch.set_num_threads(2)

COUNTS = ("tokens", "prefill_tokens", "decode_steps", "delivered_slot_steps")


def test_scheduler_is_the_reference_scheduler():
    """The same random sequence of submits, admits and completions gives the
    same seatings, states and counts."""
    JaxScheduler = load_reference().scheduler.SlotScheduler
    rng = np.random.default_rng(0)
    ours, theirs = SlotScheduler(3), JaxScheduler(3)
    for i in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            a = float(rng.uniform(0, 10))
            ours.submit(i, a)
            theirs.submit(i, a)
        elif op == 1:
            now = float(rng.uniform(0, 12))
            assert ours.admit(now) == theirs.admit(now)
        elif ours.active_items():
            slot = ours.active_items()[int(rng.integers(len(ours.active_items())))][0]
            assert ours.complete(slot) == theirs.complete(slot)
        assert (ours.pending, ours.busy, ours.done, ours.free_slots(), ours.next_arrival(),
                ours.admitted, ours.completed) == \
            (theirs.pending, theirs.busy, theirs.done, theirs.free_slots(),
             theirs.next_arrival(), theirs.admitted, theirs.completed)
    with pytest.raises(ValueError):
        SlotScheduler(0)


@pytest.mark.parametrize("rate", [None, 7.5])
def test_workload_is_the_reference_workload(rate):
    jlg = load_reference().loadgen
    for seed in (0, 3):
        kw = dict(prompt_lens=(256, 512, 1024), new_tokens=(16, 32, 64), rate_qps=rate,
                  seed=seed)
        ours, theirs = lm_workload(92544, 16, **kw), jlg.lm_workload(92544, 16, **kw)
        assert len(ours) == len(theirs) == 16
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert a.prompt.dtype == np.int32
            assert (a.max_new_tokens, a.arrival) == (b.max_new_tokens, b.arrival)
    np.testing.assert_array_equal(poisson_arrivals(5, 2.0, np.random.default_rng(1)),
                                  jlg.poisson_arrivals(5, 2.0, np.random.default_rng(1)))
    done = [Request(np.zeros(1, np.int32), latency=x) for x in (0.5, 0.1, 2.0, 0.7)]
    assert latency_percentiles(done) == jlg.latency_percentiles(done)
    assert latency_percentiles([]) == jlg.latency_percentiles([])


@pytest.fixture(scope="module")
def engines():
    """The reference engine and the port's on the same reduced weights."""
    ref = load_reference()
    jcfg = jax_reduced_config("internlm2-1.8b")
    jparams = ref.lm.init_lm(jax.random.PRNGKey(0), jcfg)
    params = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return (lambda **kw: ref.engine.ServeEngine(jparams, jcfg, **kw),
            lambda **kw: ServeEngine(params, reduced_config("internlm2-1.8b"),
                                     device="cpu", **kw))


@pytest.mark.parametrize("mode", ["run", "run_lockstep"])
def test_engine_serves_the_reference_tokens(engines, mode):
    ref = load_reference()
    make_ref, make_port = engines
    kw = dict(batch_slots=4, max_seq=48)
    e_ref, e_port = make_ref(**kw), make_port(**kw)
    wl = dict(prompt_lens=(4, 7, 12), new_tokens=(0, 1, 2, 4, 16))
    done_ref = getattr(e_ref, mode)(ref.loadgen.lm_workload(512, 14, seed=0, **wl))
    done_port = getattr(e_port, mode)(lm_workload(512, 14, seed=0, **wl))
    assert len(done_port) == len(done_ref) == 14
    for a, b in zip(done_port, done_ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        np.testing.assert_array_equal(a.output, b.output)
        assert a.output.dtype == np.int32 and a.latency >= 0
    assert {k: e_port.stats[k] for k in COUNTS} == {k: e_ref.stats[k] for k in COUNTS}
    assert e_port.slot_utilization == e_ref.slot_utilization
    assert e_port.tokens_per_second > 0 and e_port.prefill_tokens_per_second > 0


def test_engine_outputs_do_not_depend_on_the_batch(engines):
    """A request's tokens are the same served alone or among others."""
    _, make_port = engines
    reqs = lm_workload(512, 6, seed=5, new_tokens=(3, 9))
    batched = {id(r): r.output for r in make_port(batch_slots=3, max_seq=32).run(reqs)}
    for r in reqs:
        alone = make_port(batch_slots=1, max_seq=32).run([dataclasses.replace(r)])[0]
        np.testing.assert_array_equal(alone.output, batched[id(r)])


def test_engine_rejects_what_the_reference_rejects(engines):
    _, make_port = engines
    e = make_port(batch_slots=2, max_seq=8)
    with pytest.raises(ValueError, match="max_seq"):
        e.run([Request(np.zeros(6, np.int32), max_new_tokens=4)])
    with pytest.raises(ValueError, match="empty"):
        e.run_lockstep([Request(np.zeros(0, np.int32), max_new_tokens=2)])
    with pytest.raises(NotImplementedError):
        e.run([], greedy=False)
    # an encoder-decoder goes through the decode dry run, as in the JAX engine
    with pytest.raises(ValueError, match="encoder-decoder serving goes through the "
                                         "decode dry-run, not ServeEngine"):
        ServeEngine({}, reduced_config("seamless-m4t-large-v2"), device="cpu")


def test_launcher_serves_on_the_cpu_when_asked(capsys, tmp_path):
    done = launcher.main(["--device", "cpu", "--requests", "5", "--trace-dir",
                          str(tmp_path)])
    assert len(done) == 5 and all(r.output is not None for r in done)
    out = capsys.readouterr().out
    assert "lm: 5 completed" in out and "device cpu" in out
    assert (tmp_path / "serve_lm.trace.json").exists()
    done = launcher.main(["--device", "cpu", "--requests", "4", "--lockstep"])
    assert len(done) == 4
    done = launcher.main(["--mode", "surrogate", "--device", "cpu", "--requests", "3"])
    assert len(done) == 3 and all(q.mean is not None for q in done)
    assert "surrogate: 3 completed" in capsys.readouterr().out


def test_launcher_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--requests", "2"])
