"""Metrics registry: counters, gauges, windowed histograms -- and IoStats.

A copy of ``repro/obs/metrics.py`` (pure Python: ``threading`` and
``deque``), so the port's stores and train loop account the same way.

The observability layer's aggregate half.  A ``MetricsRegistry`` holds named
instruments, all thread-safe, all zero-dependency:

  * ``Counter``   -- monotonically accumulating value (``add``);
  * ``Gauge``     -- last-written value (``set``), e.g. compile seconds;
  * ``Histogram`` -- windowed sample reservoir with p50/p99 quantiles, e.g.
    per-step wall-clock or serving slot occupancy.

``snapshot()`` renders everything to a plain JSON-safe dict (the form the
``BENCH_*.json`` artifacts embed), ``merge()`` folds another registry (or
``IoStats``) in, ``reset()`` zeroes in place.

``IoStats`` -- the per-store IO accounting that was historically a dataclass
copy-pasted alongside four separate instrumentation sites (``data/store.py``
x2, ``data/shards.py``, ``data/device_store.py``) -- now lives HERE, once,
as a view over a registry: the fields keep their attribute API
(``stats.bytes_read += n`` still works, as do the tests and benchmarks that
assign ``store.stats = IoStats()``), but gain ``merge``/``reset``/
``snapshot`` and a single ``account()`` entry point that replaces the
copy-pasted accounting blocks.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class Counter:
    """Accumulating numeric metric (float-valued; ints stay exact)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def add(self, n=1) -> None:
        self.value += n

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value metric."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Windowed sample distribution: keeps the last ``window`` observations
    for quantiles while count/total stay exact over the full run."""
    __slots__ = ("window", "samples", "count", "total", "vmin", "vmax")

    def __init__(self, window: int = 4096):
        self.window = int(window)
        self.samples: deque = deque(maxlen=self.window)
        self.reset()

    def reset(self) -> None:
        self.samples.clear()
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v) -> None:
        v = float(v)
        self.samples.append(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Quantile over the retained window (q in [0, 100])."""
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        rank = (len(ordered) - 1) * q / 100.0
        lo = int(rank)
        hi = min(lo + 1, len(ordered) - 1)
        frac = rank - lo
        return ordered[lo] * (1 - frac) + ordered[hi] * frac

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin, "max": self.vmax,
                "p50": self.percentile(50), "p99": self.percentile(99)}

    def extend(self, other: "Histogram") -> None:
        for v in other.samples:
            self.samples.append(v)
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)


class MetricsRegistry:
    """Named instruments, created on first touch; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(*args))
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = 4096) -> Histogram:
        return self._get(name, Histogram, window)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-safe dict: counters/gauges as numbers, histograms as summary
        dicts -- the exact form embedded in benchmark artifacts."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
        for name, m in items:
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` in: counters add, gauges take the other's value,
        histograms pool samples.  Returns self."""
        with other._lock:
            items = list(other._metrics.items())
        for name, m in items:
            if isinstance(m, Counter):
                self.counter(name).add(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name).set(m.value)
            else:
                self.histogram(name, m.window).extend(m)
        return self

    def reset(self) -> None:
        with self._lock:
            for m in self._metrics.values():
                m.reset()


# one process-global registry: the default sink for layer instrumentation
# (train loop, serving engines) so benchmarks/run.py can snapshot + reset it
# around each module without threading a registry through every call.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ---------------------------------------------------------------------------
# IoStats: the ONE store IO-accounting implementation
# ---------------------------------------------------------------------------

class IoStats:
    """Per-store IO accounting, backed by a ``MetricsRegistry``.

    Attribute reads/writes (``stats.bytes_read += n``) keep working -- they
    proxy the underlying counters -- so every historical call site and test
    is source-compatible; new code should use :meth:`account`, the single
    replacement for the four copy-pasted accounting blocks.
    """
    FIELDS = ("bytes_read", "read_seconds", "decode_seconds", "batches")
    __slots__ = ("_registry", "_prefix")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "io"):
        object.__setattr__(self, "_registry", registry or MetricsRegistry())
        object.__setattr__(self, "_prefix", prefix)
        for f in self.FIELDS:
            self._registry.counter(f"{prefix}.{f}")

    def _counter(self, field: str) -> Counter:
        return self._registry.counter(f"{self._prefix}.{field}")

    def __getattr__(self, name):
        if name in IoStats.FIELDS:
            return self._counter(name).value
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in IoStats.FIELDS:
            self._counter(name).set(value)
        else:
            object.__setattr__(self, name, value)

    def account(self, nbytes: int = 0, read_seconds: float = 0.0,
                decode_seconds: float = 0.0, batches: int = 1) -> None:
        """One batch's accounting -- the shared instrumentation entry point."""
        self._counter("bytes_read").add(int(nbytes))
        self._counter("read_seconds").add(read_seconds)
        self._counter("decode_seconds").add(decode_seconds)
        self._counter("batches").add(batches)

    def merge(self, other: "IoStats") -> "IoStats":
        """Fold another store's accounting in (multi-store aggregation)."""
        for f in self.FIELDS:
            self._counter(f).add(getattr(other, f))
        return self

    def reset(self) -> None:
        for f in self.FIELDS:
            self._counter(f).reset()

    def snapshot(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        d["throughput_mbs"] = self.throughput_mbs()
        return d

    def throughput_mbs(self) -> float:
        total = self.read_seconds + self.decode_seconds
        return (self.bytes_read / 1e6) / max(total, 1e-9)

    def __repr__(self) -> str:
        body = ", ".join(f"{f}={getattr(self, f)}" for f in self.FIELDS)
        return f"IoStats({body})"

    def __eq__(self, other) -> bool:
        if not isinstance(other, IoStats):
            return NotImplemented
        return all(getattr(self, f) == getattr(other, f)
                   for f in self.FIELDS)
