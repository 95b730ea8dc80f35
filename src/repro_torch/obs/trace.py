"""Lightweight thread-safe span tracer: Perfetto/Chrome traces + JSONL events.

The observability layer's timeline half.  A ``Tracer`` records *spans*
(named, nested, attributed intervals), *instants* (point events) and
*counter* samples (e.g. serving slot occupancy), each stamped with the
recording thread -- so the prefetch worker, the shard-writer worker and the
main loop land on separate tracks and pipeline overlap is visible in one
timeline.  Export is dual:

  * ``<run>.trace.json``   -- Chrome trace-event format (``traceEvents``
    with ``ph`` in {X, i, C}), loadable directly in Perfetto / chrome://tracing;
  * ``<run>.events.jsonl`` -- one structured JSON event per line (seconds,
    depth, attrs), the stream ``tools/trace_report.py`` summarizes.

Design constraints (the hot paths this instruments are per-train-step and
per-decode-step):

  * **off by default, near-zero when off** -- the module-level ``span()`` /
    ``instant()`` / ``counter()`` helpers check one global and return a
    shared no-op context manager when no tracer is configured; no clock is
    read, no object is allocated;
  * **zero dependencies** -- stdlib only, importable from any layer
    (``tools/check_layering.py`` ranks ``obs`` at the bottom of the ladder);
  * **thread-safe** -- per-thread span stacks via ``threading.local``, one
    lock around the shared event list;
  * **bounded** -- at most ``max_events`` events are retained; overflow is
    counted and reported in the export metadata instead of growing without
    limit on long runs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def set(self, **attrs) -> "_Span":
        """Attach attributes discovered mid-span (e.g. iteration counts)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self._tracer._stack().pop()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._record("X", self.name, self.cat,
                             self._t0 - self._tracer._t0, dur,
                             self.attrs, self._depth)
        return False


class Tracer:
    """Collects events for one run; ``write()`` exports both formats."""

    def __init__(self, trace_dir: Optional[str] = None, run: str = "run",
                 max_events: int = 200_000):
        self.trace_dir = trace_dir
        self.run = run
        self.max_events = int(max_events)
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._events: list = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pid = os.getpid()

    # -- recording -----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def depth(self) -> int:
        """Current span nesting depth on the calling thread."""
        return len(self._stack())

    def _record(self, ph: str, name: str, cat: str, ts: float, dur: float,
                attrs: Optional[dict], depth: int = 0) -> None:
        rec = {"ph": ph, "name": name, "cat": cat, "ts": ts, "dur": dur,
               "tid": threading.get_ident(), "depth": depth,
               "args": attrs or {}}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(rec)

    def span(self, name: str, cat: str = "span", **attrs) -> _Span:
        """Context manager timing a nested, attributed interval."""
        return _Span(self, name, cat, attrs)

    def complete(self, name: str, start: float, dur: float, cat: str = "span",
                 **attrs) -> None:
        """Record a span whose bounds were measured externally (``start`` in
        seconds on this tracer's clock, e.g. a request's arrival-to-finish
        window reconstructed after completion)."""
        self._record("X", name, cat, start, max(dur, 0.0), attrs)

    def instant(self, name: str, cat: str = "event", **attrs) -> None:
        """Point event (e.g. a detected recompile, a checkpoint save)."""
        self._record("i", name, cat, time.perf_counter() - self._t0, 0.0,
                     attrs)

    def counter(self, name: str, **values) -> None:
        """Counter sample: numeric series Perfetto plots as a track."""
        self._record("C", name, "counter", time.perf_counter() - self._t0,
                     0.0, {k: float(v) for k, v in values.items()})

    def now(self) -> float:
        """Seconds since this tracer started (the span timeline's clock)."""
        return time.perf_counter() - self._t0

    def rel(self, perf_t: float) -> float:
        """Translate a raw ``time.perf_counter()`` stamp onto this tracer's
        timeline (for :meth:`complete` spans timed by caller code)."""
        return perf_t - self._t0

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The run as a Chrome trace-event object (``ph`` X / i / C)."""
        out = []
        for e in self.events():
            ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                  "ts": e["ts"] * 1e6, "pid": self._pid, "tid": e["tid"],
                  "args": e["args"]}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] * 1e6
            if e["ph"] == "i":
                ev["s"] = "t"                      # thread-scoped instant
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"run": self.run, "dropped": self.dropped}}

    def write(self, trace_dir: Optional[str] = None) -> dict:
        """Export ``<run>.trace.json`` + ``<run>.events.jsonl``; returns
        ``{"trace": path, "events": path}``."""
        root = trace_dir or self.trace_dir
        if root is None:
            raise ValueError("no trace_dir configured and none passed")
        os.makedirs(root, exist_ok=True)
        trace_path = os.path.join(root, f"{self.run}.trace.json")
        events_path = os.path.join(root, f"{self.run}.events.jsonl")
        with open(trace_path, "w") as f:
            json.dump(self.chrome_trace(), f)
        with open(events_path, "w") as f:
            for e in self.events():
                f.write(json.dumps({
                    "type": {"X": "span", "i": "instant",
                             "C": "counter"}[e["ph"]],
                    "name": e["name"], "cat": e["cat"],
                    "ts_s": round(e["ts"], 9), "dur_s": round(e["dur"], 9),
                    "thread": e["tid"], "depth": e["depth"],
                    "attrs": e["args"]}) + "\n")
        return {"trace": trace_path, "events": events_path}


# ---------------------------------------------------------------------------
# module-level API: one optional global tracer, null-object when disabled
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def configure(trace_dir: Optional[str] = None, run: str = "run",
              max_events: int = 200_000) -> Tracer:
    """Install (and return) the global tracer; telemetry is ON afterwards."""
    global _TRACER
    _TRACER = Tracer(trace_dir=trace_dir, run=run, max_events=max_events)
    return _TRACER


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def shutdown(write: bool = True) -> Optional[dict]:
    """Tear the global tracer down; exports first when it has a trace_dir."""
    global _TRACER
    t, _TRACER = _TRACER, None
    if t is not None and write and t.trace_dir is not None:
        return t.write()
    return None


def span(name: str, cat: str = "span", **attrs):
    """Global-tracer span; the shared no-op when telemetry is off."""
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, **attrs)


def instant(name: str, cat: str = "event", **attrs) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **attrs)


def counter(name: str, **values) -> None:
    t = _TRACER
    if t is not None:
        t.counter(name, **values)
