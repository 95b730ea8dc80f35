"""Summarize a ``repro_torch`` run's trace: the table of ``tools/trace_report.py``
with self times taken from the recorded parent ids, and the device ranges.

The port's tracer (``repro_torch.obs.trace``) gives every record an id, its
depth and its parent's id, in both exports, and adds device ranges: the
device seconds of a phase of a step (``type: range`` in ``.events.jsonl``,
an async ``b``/``e`` pair in ``.trace.json``).  ``tools/trace_report.py``
reads these exports too, but skips the ranges and finds each span's
children by depth and containment; this report takes a span's self time
as its duration less those of the spans that name it as parent, and adds

    device range <name>: x<count>  <total>s  mean <ms> ms

below the table.

Usage:
  python tools/trace_report_torch.py out/trace               # whole directory
  python tools/trace_report_torch.py out/trace/run.events.jsonl
  python tools/trace_report_torch.py out/trace/run.trace.json --json
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import trace_report  # noqa: E402


def load_events(path: str) -> List[dict]:
    """``trace_report.load_events``' records, with ``id`` and ``parent``,
    and the Chrome trace's device ranges (``type`` ``range``)."""
    if path.endswith(".jsonl"):
        return trace_report.load_events(path)
    with open(path) as f:
        doc = json.load(f)
    ph_type = {"X": "span", "i": "instant", "C": "counter", "b": "range"}
    out, opened = [], {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "e":
            rec = opened.pop(e.get("id"), None)
            if rec is not None:
                rec["dur_s"] = e["ts"] / 1e6 - rec["ts_s"]
            continue
        if e.get("ph") not in ph_type:
            continue
        rec = {"type": ph_type[e["ph"]], "name": e["name"], "cat": e.get("cat", ""),
               "ts_s": e["ts"] / 1e6, "dur_s": e.get("dur", 0.0) / 1e6,
               "thread": e.get("tid", 0), "id": e.get("record_id"),
               "parent": e.get("parent"), "depth": e.get("depth"),
               "attrs": e.get("args", {})}
        if e["ph"] == "b":
            opened[e.get("id")] = rec
        out.append(rec)
    return out


def summarize(events: List[dict]) -> dict:
    """``trace_report.summarize``, each stage's ``self_s`` from parent ids,
    and ``ranges``: count, total seconds and mean ms of each device range."""
    rep = trace_report.summarize(events)
    spans = [e for e in events if e["type"] == "span"]
    if all(s.get("id") is not None for s in spans):     # older runs: by depth
        own = {s["id"]: s["dur_s"] for s in spans}
        for s in spans:
            if s.get("parent") in own:
                own[s["parent"]] -= s["dur_s"]
        for st in rep["stages"].values():
            st["self_s"] = 0.0
        for s in spans:
            rep["stages"][s["name"]]["self_s"] += max(own[s["id"]], 0.0)
    ranges: dict = {}
    for e in events:
        if e["type"] == "range":
            rec = ranges.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            rec["count"] += 1
            rec["total_s"] += e["dur_s"]
    for rec in ranges.values():
        rec["mean_ms"] = rec["total_s"] / rec["count"] * 1e3
    rep["ranges"] = ranges
    return rep


def print_report(path: str, rep: dict) -> None:
    trace_report.print_report(path, rep)
    for name, rec in sorted(rep["ranges"].items()):
        print(f"   device range {name}: x{rec['count']}  {rec['total_s']:.3f}s  "
              f"mean {rec['mean_ms']:.2f} ms")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace directory, .events.jsonl, or .trace.json")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of a table")
    args = ap.parse_args(argv)

    inputs = trace_report.find_inputs(args.path)
    if not inputs:
        print(f"no trace files under {args.path}", file=sys.stderr)
        return 1
    reports = {p: summarize(load_events(p)) for p in inputs}
    if args.json:
        json.dump(reports, sys.stdout, indent=1)
        print()
    else:
        for p, rep in reports.items():
            print_report(p, rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
