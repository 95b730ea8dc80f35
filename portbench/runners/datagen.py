"""Runner of the datagen cells: ``produce`` whole, on the card.

Set-up produces ``warmup_members`` members (the kernels built, the
solver's and the encode's shapes warmed).  The window is one call of
``produce`` of ``members_per_second`` members a second of ``--seconds``
(a fixed amount of work, about ``--seconds`` long on the H100): simulate,
encode at the plan's tolerance and write the shards through the
overlapped ``ShardWriter``, timed from the call to its return with the
device synchronised.  A traced run traces a call of ``trace_members``
members instead, recording the device's activity alone, and after it a
call of one member with the host's operators, for the idle gaps.

The check follows ``check_members`` members drawn from the seed: the
reference simulates each from the parameters the store's
``production.json`` records, encodes its snapshots, and holds every shard
record to its own word for word (``record_mismatch``, words that differ or
are missing) and the records as decoded to its snapshots
(``linf_over_tol``, the largest error over the plan's tolerance, which the
configuration bounds by 1).  Both sides of that ratio are float32, the
configuration's precision: the error is the decoded value less the
snapshot, rounded once to float32, and the tolerance is the float32 that
the encoder holds it to (1e-3 as float32 is 1.0000000475e-3), so a block
whose error the encoder verified to equal its tolerance reads 1.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from portbench import data
from portbench.reference import solver, zfp
from portbench.window import Window


def _numbers(cfg, sdir, members, fields_of, altered=None) -> dict:
    """The two numbers of ``members`` of the store at ``sdir`` against the
    snapshots ``fields_of(sim)`` and their records."""
    store = zfp.ShardStore(sdir)
    with open(os.path.join(sdir, "production.json")) as f:
        sims = json.load(f)["sims"]
    nsnaps, tol = cfg["nsnaps"], cfg["codec"]["tolerance"]
    tol32 = float(np.float32(tol))
    mismatch, worst = 0, 0.0
    for m in members:
        ref = fields_of(sims[m]).movedim(-1, 1)                 # (T, C, H, W)
        records = zfp.encode_records(ref, tol)
        rows = range(m * nsnaps, (m + 1) * nsnaps)
        for i, rec in zip(rows, records):
            if i >= store.num_samples:
                mismatch += rec.size
                continue
            p, e = store.record(i)
            got = np.concatenate([p.ravel(), e])
            if altered is not None:
                got = altered(i, got)
            if got.shape != rec.shape:
                mismatch += max(got.size, rec.size)
            else:
                mismatch += int((got != rec).sum())
        have = [i for i in rows if i < store.num_samples]
        if have:
            dec = store.decode(have, ref.device)
            worst = max(worst, float((dec - ref[:len(have)]).abs().max()) / tol32)
    return {"record_mismatch": float(mismatch), "linf_over_tol": worst}


def run(run) -> None:
    from repro_torch.datagen import produce

    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    data.produce_store(cfg, seed, os.path.join(run.tmp, "warmup"), dev,
                       members=tr["warmup_members"])
    run.mark("warmup_produce")

    members = (tr["trace_members"] if run.trace else
               max(tr["check_members"], round(tr["members_per_second"] * run.seconds)))
    plan = data.plan_for(cfg, members, seed)
    root = os.path.join(run.tmp, "window")
    win = Window(dev, 0, run.seconds, 1 if run.trace else 0)
    win.open()
    report = produce(plan, root, device=dev)
    win.close(members)
    if not report.finalized:
        raise RuntimeError("the window's production did not finalize")
    if run.trace:
        win.host_stretch(lambda: produce(data.plan_for(cfg, 1, seed + 1),
                                         os.path.join(run.tmp, "host_trace"), device=dev))
    sdir = os.path.join(root, plan.scenarios[0].name)
    written = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"window wrote {written} bytes", file=sys.stderr)

    run.window, run.store = win, None
    run.rate_metric, run.samples_per_step = "datagen_samples_per_s", cfg["nsnaps"]
    rng = np.random.default_rng((seed, members))
    checked = sorted(rng.choice(members, size=min(tr["check_members"], members),
                                replace=False).tolist())
    shape = (cfg["ny"], cfg["nx"], cfg["nsteps"], cfg["nsnaps"], dev)

    def check():
        return _numbers(cfg, sdir, checked, lambda sim: solver.simulate(sim, *shape))

    def calibrate():
        def flip(i, rec):
            rec = rec.copy()
            rec[0] ^= 1
            return rec
        return {"program": check(),
                "control": _numbers(cfg, sdir, checked,
                                    lambda sim: solver.simulate(sim, *shape, bf16_state=True)),
                "faults": {"frozen": _numbers(cfg, sdir, checked,
                                              lambda sim: solver.simulate(sim, *shape,
                                                                          frozen=True)),
                           "altered_record": _numbers(cfg, sdir, checked[:1],
                                                      lambda sim: solver.simulate(sim, *shape),
                                                      altered=flip)}}

    run.check, run.calibrate = check, calibrate
