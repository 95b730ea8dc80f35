"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... [--out FILE]

For each seed it runs the cell's set-up and first steps (the window closes
after one step; an ensemble's timed call runs on to the step it logs), frees the program's state, and holds three kinds of run
to the reference, as the cell's runner defines them: the program itself
(the lower readings), the control (the reference put in the program's
place one precision below the configuration's: the upper readings), and
each fault the cell's path can have, planted in the reference put in the
program's place.  One JSON line per seed, then the largest program
reading and the smallest control and fault readings of each number.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "portbench"):
    sys.path.pop(0)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(cell, seed: int, device: str) -> dict:
    import torch

    from portbench import harness, training
    tmp = tempfile.mkdtemp(prefix="portbench-calibrate-")
    try:
        run = harness.Run(cell=cell.name, config=cell.config, traffic=cell.traffic,
                          seed=seed, seconds=0.0, trace=False, device=torch.device(device),
                          tmp=tmp)
        __import__(f"portbench.runners.{cell.traffic['runner']}", fromlist=["run"]).run(run)
        run.release()
        training.free_device()
        return {"seed": seed, **run.calibrate()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def summary(rows: list) -> dict:
    out = {}
    for k in rows[0]["program"]:
        out[k] = {"program_max": max(r["program"][k] for r in rows),
                  "control_min": min(r["control"][k] for r in rows)}
        for f in rows[0]["faults"]:
            out[k][f + "_min"] = min(r["faults"][f].get(k, float("nan")) for r in rows)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from portbench import harness
    cell = harness.load_cell(args.workload)
    cell.traffic = dict(cell.traffic, warmup_steps=0, trace_steps=0)
    harness.set_precision(cell.config)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        rows.append(readings(cell, seed, args.device))
        print(json.dumps(rows[-1]), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    result = {"workload": args.workload, "summary": summary(rows)}
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(result) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
