"""Telemetry: the span tracer (``obs/trace.py``, the JAX package's with
device ranges, parent ids, the epoch clock and recording under a
``torch.profiler`` capture added), the metrics registry and ``IoStats``,
and ``obs/torchprof.py`` (profiler regions, the opt-in ``torch.profiler``
capture and the recompile watcher; the counterpart of
``repro/obs/jaxprof.py``)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, IoStats,
                                     MetricsRegistry, get_registry)
from repro_torch.obs.trace import (NULL_SPAN, Tracer, active, capture_tracer,
                                   configure, counter, device_range, enabled, get_tracer,
                                   instant, shutdown, span)
from repro_torch.obs.torchprof import (RecompileEvent, RecompileWatcher, annotation,
                                       block_until_ready, cache_size, get_watcher,
                                       named_scope, profiler_trace)

__all__ = ["Counter", "Gauge", "Histogram", "IoStats", "MetricsRegistry",
           "get_registry", "NULL_SPAN", "Tracer", "active", "capture_tracer", "configure",
           "counter", "device_range", "enabled", "get_tracer", "instant", "shutdown", "span",
           "RecompileEvent", "RecompileWatcher", "annotation", "block_until_ready",
           "cache_size", "get_watcher", "named_scope", "profiler_trace"]
