"""Lightweight thread-safe span tracer: Perfetto/Chrome traces + JSONL events.

The observability layer's timeline half.  A ``Tracer`` records *spans*
(named, nested, attributed intervals), *instants* (point events),
*counter* samples (e.g. serving slot occupancy) and *device ranges* (the
device time of a stretch of queued work, between two CUDA events), each
stamped with the recording thread -- so the prefetch worker, the
shard-writer worker and the main loop land on separate tracks and
pipeline overlap is visible in one timeline.  Every record carries an id,
its depth and the id of its parent: the span open on the recording thread
when it began.  A device range also carries the ``step`` of the nearest
enclosing span that has one, the identifier that the records of one unit
of work share.  Export is dual:

  * ``<run>.trace.json``   -- Chrome trace-event format (``traceEvents``
    with ``ph`` in {X, i, C}, device ranges as async ``b``/``e`` pairs),
    loadable directly in Perfetto / chrome://tracing.  ``ts`` is on the
    Unix-epoch clock that ``torch.profiler`` (kineto) stamps its events
    with, less the same ``baseTimeNanoseconds`` that its Chrome export
    subtracts, so the events of a ``torch_profile.*.trace.json`` of the
    same run overlay these;
  * ``<run>.events.jsonl`` -- one structured JSON event per line (seconds,
    id, parent, depth, attrs), the stream ``tools/trace_report.py``
    summarizes.

Records are stamped with ``time.perf_counter()`` relative to the tracer's
start (``rel()`` maps a raw stamp onto it); the tracer also keeps one pair
of ``perf_counter_ns`` and ``time_ns`` readings taken at its start, which
puts the Chrome export on the epoch clock.

The program records when either of two switches is on:

  * a tracer is configured (:func:`configure`);
  * a ``torch.profiler`` capture is running (between its ``start()`` and
    ``stop()``).  With no tracer configured, records then go to one
    in-memory tracer of the process (no ``trace_dir``, the same
    ``max_events`` bound), which stays readable after the capture stops:
    :func:`capture_tracer`.

Design constraints (the hot paths this instruments are per-train-step and
per-decode-step):

  * **off by default, near-zero when off** -- :func:`active` reads the
    configured tracer and the profiler's flag; the module-level ``span()``
    / ``device_range()`` / ``instant()`` / ``counter()`` helpers return a
    shared no-op context manager when it finds neither, and a hot loop
    calls it once and opens its spans on what it returns: no clock is read,
    no object is allocated, no CUDA event is made;
  * **no synchronise** -- a device range is a pair of CUDA events on the
    current stream, resolved by ``query()`` when a later range begins, or
    when the tracer is read;
  * **few dependencies** -- the stdlib, and torch for the profiler's flag
    and the CUDA events; importable from any layer
    (``tools/check_layering.py`` ranks ``obs`` at the bottom of the ladder);
  * **thread-safe** -- per-thread span stacks via ``threading.local``, one
    lock around the shared event list;
  * **bounded** -- at most ``max_events`` events are retained; overflow is
    counted and reported in the export metadata instead of growing without
    limit on long runs.  A configured tracer keeps the first records; the
    capture's keeps the newest, since a process may run many captures and
    only the latest is read.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

# kineto's Chrome export subtracts the Unix time rounded down to a multiple
# of this many seconds (``baseTimeNanoseconds``), to keep ``ts`` exact in a
# double; the tracer's export subtracts the same
KINETO_BASE_SECONDS = 7889238

PHASES = {"X": "span", "i": "instant", "C": "counter", "R": "range"}


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
    __slots__ = ("_tracer", "name", "cat", "attrs", "id", "_t0", "_depth",
                 "_parent")

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
        self._parent = stack[-1].id if stack else None
        self.id = next(self._tracer._ids)
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
                             self.attrs, self._depth, self._parent, self.id)
        return False


class _Range:
    """The device time of the work queued inside it: CUDA events on the
    current stream of ``device`` around it (a host interval elsewhere).
    Not a span: nothing nests in it, and its parent is the span open
    around it."""
    __slots__ = ("_tracer", "name", "_device", "_t0", "_start", "_ctx")

    def __init__(self, tracer: "Tracer", name: str, device):
        self._tracer = tracer
        self.name = name
        self._device = torch.device(device)

    def __enter__(self):
        tracer = self._tracer
        tracer._poll()
        stack = tracer._stack()
        step = next((s.attrs["step"] for s in reversed(stack) if "step" in s.attrs),
                    None)
        self._ctx = (len(stack), stack[-1].id if stack else None,
                     {} if step is None else {"step": step})
        self._start = None
        if self._device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self._device))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        tracer = self._tracer
        depth, parent, args = self._ctx
        ts = self._t0 - tracer._t0
        if self._start is None:
            tracer._record("R", self.name, "device", ts, time.perf_counter() - self._t0,
                           args, depth, parent)
            return False
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self._device))
        with tracer._lock:
            tracer._pending.append((self.name, ts, threading.get_ident(), depth,
                                    parent, args, self._start, end))
        return False


class Tracer:
    """Collects events for one run; ``write()`` exports both formats."""

    def __init__(self, trace_dir: Optional[str] = None, run: str = "run",
                 max_events: int = 200_000, keep_newest: bool = False):
        self.trace_dir = trace_dir
        self.run = run
        self.max_events = int(max_events)
        self.keep_newest = keep_newest
        self.dropped = 0
        # one reading of each clock, the perf counter's taken around the epoch's
        p0 = time.perf_counter_ns()
        self.epoch_ns = time.time_ns()
        self.perf_ns = (p0 + time.perf_counter_ns()) // 2
        self._t0 = self.perf_ns * 1e-9
        self._events: collections.deque = collections.deque(
            maxlen=self.max_events if keep_newest else None)
        self._pending: collections.deque = collections.deque()
        self._ids = itertools.count(1)
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
                attrs: Optional[dict], depth: Optional[int] = None,
                parent: Optional[int] = None, rid: Optional[int] = None,
                tid: Optional[int] = None) -> None:
        if depth is None:               # the enclosing span of this thread
            stack = self._stack()
            depth, parent = len(stack), (stack[-1].id if stack else None)
        rec = {"ph": ph, "name": name, "cat": cat, "ts": ts, "dur": dur,
               "tid": threading.get_ident() if tid is None else tid,
               "id": next(self._ids) if rid is None else rid,
               "parent": parent, "depth": depth, "args": attrs or {}}
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                if not self.keep_newest:
                    return
            self._events.append(rec)        # keep_newest: the oldest gives way

    def _poll(self) -> None:
        """Record the device ranges whose work has finished (no wait)."""
        while True:
            with self._lock:
                if not self._pending or not self._pending[0][-1].query():
                    return
                item = self._pending.popleft()
            self._resolve(item)

    def _resolve(self, item) -> None:
        name, ts, tid, depth, parent, args, start, end = item
        end.synchronize()
        self._record("R", name, "device", ts, start.elapsed_time(end) * 1e-3, args,
                     depth, parent, tid=tid)

    def span(self, name: str, cat: str = "span", **attrs) -> _Span:
        """Context manager timing a nested, attributed interval."""
        return _Span(self, name, cat, attrs)

    def device_range(self, name: str, device) -> _Range:
        """Context manager recording the device seconds of the work queued
        inside it on ``device`` (host seconds off the card)."""
        return _Range(self, name, device)

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
        """Every record, the device ranges still in flight resolved first
        (waiting for their work to finish)."""
        with self._lock:
            pending, self._pending = list(self._pending), collections.deque()
        for item in pending:
            self._resolve(item)
        with self._lock:
            return list(self._events)

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The run as a Chrome trace-event object (``ph`` X / i / C, a
        device range as a ``b``/``e`` pair under its ``id``), ``ts`` in
        microseconds on the Unix-epoch clock less ``baseTimeNanoseconds``;
        each event carries ``record_id``, ``parent`` and ``depth`` (not
        ``id``, which a counter would take for a series of its own)."""
        base = self.epoch_ns // 10**9 // KINETO_BASE_SECONDS * KINETO_BASE_SECONDS * 10**9
        shift_us = (self.epoch_ns - base) / 1e3
        out = []
        for e in self.events():
            ev = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
                  "ts": shift_us + e["ts"] * 1e6, "pid": self._pid, "tid": e["tid"],
                  "record_id": e["id"], "parent": e["parent"], "depth": e["depth"],
                  "args": e["args"]}
            if e["ph"] == "X":
                ev["dur"] = e["dur"] * 1e6
            if e["ph"] == "i":
                ev["s"] = "t"                      # thread-scoped instant
            if e["ph"] == "R":                     # overlapping: an async pair
                out.append(dict(ev, ph="b", id=e["id"]))
                ev = dict(ev, ph="e", id=e["id"], ts=ev["ts"] + e["dur"] * 1e6)
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": base,
                "otherData": {"run": self.run, "dropped": self.dropped,
                              "epoch_ns": self.epoch_ns, "perf_ns": self.perf_ns}}

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
                    "type": PHASES[e["ph"]],
                    "name": e["name"], "cat": e["cat"],
                    "ts_s": round(e["ts"], 9), "dur_s": round(e["dur"], 9),
                    "thread": e["tid"], "id": e["id"], "parent": e["parent"],
                    "depth": e["depth"], "attrs": e["args"]}) + "\n")
        return {"trace": trace_path, "events": events_path}


# ---------------------------------------------------------------------------
# module-level API: one optional global tracer, the capture's tracer, and
# the null object when neither records
# ---------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None
_CAPTURED: Optional[Tracer] = None
_CAPTURED_LOCK = threading.Lock()


def configure(trace_dir: Optional[str] = None, run: str = "run",
              max_events: int = 200_000) -> Tracer:
    """Install (and return) the global tracer; telemetry is ON afterwards."""
    global _TRACER
    _TRACER = Tracer(trace_dir=trace_dir, run=run, max_events=max_events)
    return _TRACER


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    """Whether a tracer is configured (a running capture alone does not
    count: ``annotation()`` regions follow this)."""
    return _TRACER is not None


def capture_tracer() -> Optional[Tracer]:
    """The in-memory tracer that records while a ``torch.profiler`` capture
    runs and no tracer is configured; None until it first records.  It
    holds the newest ``max_events`` records of every capture of the process
    since :func:`shutdown` (older ones give way, counted in ``dropped``)."""
    return _CAPTURED


def _recorder() -> Tracer:
    """The capture's tracer, made at its first record."""
    global _CAPTURED
    with _CAPTURED_LOCK:
        if _CAPTURED is None:
            _CAPTURED = Tracer(run="capture", keep_newest=True)
        return _CAPTURED


def active() -> Optional[Tracer]:
    """The tracer that records now: the configured one, else the capture's
    while a ``torch.profiler`` capture runs; None when nothing records (a
    global read and an attribute read).  A hot loop calls this once and
    opens its spans on the result, so that with recording off it builds no
    span's attributes either."""
    t = _TRACER
    if t is None and _profiler._is_profiler_enabled:
        t = _CAPTURED or _recorder()
    return t


def shutdown(write: bool = True) -> Optional[dict]:
    """Tear the global tracer down, and drop the capture's; exports the
    global one first when it has a trace_dir."""
    global _TRACER, _CAPTURED
    t, _TRACER, _CAPTURED = _TRACER, None, None
    if t is not None and write and t.trace_dir is not None:
        return t.write()
    return None


def span(name: str, cat: str = "span", **attrs):
    """Global-tracer span; the shared no-op when nothing records."""
    t = active()
    return NULL_SPAN if t is None else t.span(name, cat, **attrs)


def device_range(name: str, device):
    """Device range of the work queued inside it on ``device``; the shared
    no-op when nothing records."""
    t = active()
    return NULL_SPAN if t is None else t.device_range(name, device)


def instant(name: str, cat: str = "event", **attrs) -> None:
    t = active()
    if t is not None:
        t.instant(name, cat, **attrs)


def counter(name: str, **values) -> None:
    t = active()
    if t is not None:
        t.counter(name, **values)
