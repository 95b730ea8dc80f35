"""Serving: the slot scheduler, the continuous-batching LM engine, the
seed-ensemble surrogate engine and the load generator."""
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.surrogate_engine import SurrogateQuery, SurrogateServeEngine

__all__ = ["Request", "ServeEngine", "SlotScheduler", "SurrogateQuery",
           "SurrogateServeEngine"]
