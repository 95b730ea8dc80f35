"""Telemetry: the span tracer (``obs/trace.py``, copied whole from the JAX
package), the metrics registry and ``IoStats``."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, IoStats,
                                     MetricsRegistry, get_registry)
from repro_torch.obs.trace import (NULL_SPAN, Tracer, configure, counter, enabled,
                                   get_tracer, instant, shutdown, span)

__all__ = ["Counter", "Gauge", "Histogram", "IoStats", "MetricsRegistry",
           "get_registry", "NULL_SPAN", "Tracer", "configure", "counter", "enabled",
           "get_tracer", "instant", "shutdown", "span"]
