"""LM serving: the slot scheduler, the continuous-batching engine and the
load generator.  The surrogate engine waits for ROADMAP Queue 1 item 10."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.scheduler import SlotScheduler

__all__ = ["Request", "ServeEngine", "SlotScheduler"]
