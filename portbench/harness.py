"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

``load_cell`` finds everything of a cell by name: its entry in
``BENCHMARK.json`` (configuration, traffic, chips, the metrics it reports),
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``runner``
names the module under ``runners/`` that runs it) and
``limits/<cell>.json``.  ``run_cell`` sets the configuration's precision,
runs the runner, reads the end-to-end metrics (``--trace 0``) or the
per-layer metrics (``--trace 1``, each from ``metrics/<name>.py``), reads
the memory peak, frees the program's state and then runs the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import check
from portbench.traceread import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=layer)


@dataclasses.dataclass
class Run:
    """What a runner hands the metrics and the check."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmp: str
    window: Any = None                  # portbench.window.Window
    loader: Any = None                  # portbench.batches.SeedBatches
    window_batch0: int = 0              # index in loader.drawn of the window's first step
    store: Any = None                   # the store the window read
    rate_metric: str = ""               # the end-to-end rate: units of work a second
    samples_per_step: int = 0           # samples a unit of work
    flops_per_step: float = 0.0
    trace_data: Optional[Trace] = None
    release: Callable[[], None] = lambda: None
    check: Callable[[], Dict[str, float]] = lambda: {}
    calibrate: Callable[[], dict] = lambda: {}
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    t_mark: float = dataclasses.field(default_factory=time.perf_counter)

    def mark(self, phase: str) -> None:
        """Seconds of set-up since the last mark, under ``phase``."""
        now = time.perf_counter()
        self.phases[phase] = now - self.t_mark
        self.t_mark = now

    def traced_batches(self):
        """The batches of the traced steps, in order."""
        lo = self.window_batch0
        return self.loader.drawn[lo:lo + self.window.trace_end_step]


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_precision(config: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Run ``cell`` once; returns the result's fields."""
    dev = torch.device(device)
    set_precision(cell.config)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(cell=cell.name, config=cell.config, traffic=cell.traffic, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=dev, tmp=tmp,
                  t_mark=t_start)
        run.mark("start")
        importlib.import_module(f"portbench.runners.{cell.traffic['runner']}").run(run)
        return _finish(cell, run, t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _finish(cell: Cell, run: Run, t_start: float) -> dict:
    w = run.window
    e2e = {"setup_s": w.t_open - t_start,
           run.rate_metric: w.steps * run.samples_per_step / w.length}
    metrics: Dict[str, dict] = {}
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu"),
              "count": 1,
              "memory_peak_bytes": int(max(w.peak_before, w.peak))}
    result: Dict[str, Any] = {"correct": False, "attempted": int(w.steps), "failed": 0}
    run.phases["warmup"] = w.t_open - run.t_mark
    if run.trace:
        run.trace_data = Trace.from_profiler(w.profiler)
        for m in cell.per_layer:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device["busy_s"] = run.trace_data.busy_ns() / 1e9
        device["window_s"] = w.t_trace_end - w.t_open
        host = Trace.from_profiler(w.host_profiler) if w.host_profiler is not None else None
        result["breakdown"] = {"device_ops": run.trace_data.device_ops(),
                               "idle_gaps": host.idle_gaps() if host is not None else []}
        w.profiler = w.host_profiler = None
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    run.release()
    run.trace_data = None
    from portbench.training import free_device
    free_device()
    checks = check.judge(run.check(), cell.limits)
    result.update(correct=check.passed(checks), metrics=metrics, device=device)
    result["checks"] = checks
    print("set-up seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in run.phases.items()),
          file=sys.stderr)
    return result


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({name for name in modules if name.split(".")[0] in FORBIDDEN})


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The summary and the compared numbers on standard error (the numbers
    last), then the result as the last line of standard output."""
    for name, m in result["metrics"].items():
        print(f"{name} {m['value']!r} {m['unit']}", file=err)
    print(f"correct {result['correct']}", file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
