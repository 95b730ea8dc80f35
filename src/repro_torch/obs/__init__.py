"""Telemetry: the metrics registry and ``IoStats``.  The span tracer
(``obs/trace.py``) waits for ROADMAP Queue 1 item 9."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, IoStats,
                                     MetricsRegistry, get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "IoStats", "MetricsRegistry",
           "get_registry"]
