"""Streaming datagen subsystem: simulate -> compress-on-device -> sharded store.

Counterpart of ``repro/datagen``: declarative ``ProductionPlan``s (scenario
sweeps + codec + shard geometry, hashing as the JAX package's do), a
streaming producer that simulates and encodes on the card while a
bounded-queue async writer overlaps device->host transfer and disk IO,
atomic per-shard commits with full-provenance manifests, exact
kill-and-resume, and multi-host shard partitioning.  ``resolve_store`` /
``open_produced`` are the read-side entry points that ``train_surrogate``
and ``certify_tolerance`` use to accept produced-dataset paths.
"""
from repro_torch.datagen.plan import (CodecPlan, ProductionPlan, ScenarioPlan,
                                      PLAN_FORMAT)
from repro_torch.datagen.produce import (NonFiniteMemberError,
                                         ProducedDataset, ProduceReport,
                                         ScenarioReport, PRODUCTION_NAME,
                                         finalize, finalize_scenario,
                                         load_provenance, open_produced,
                                         produce, produced_training_arrays,
                                         resolve_store, scenario_conditions)
from repro_torch.datagen.writer import ShardWriter, WriterStats

__all__ = [
    "CodecPlan", "ProductionPlan", "ScenarioPlan", "PLAN_FORMAT",
    "NonFiniteMemberError", "ProducedDataset", "ProduceReport",
    "ScenarioReport", "PRODUCTION_NAME",
    "finalize", "finalize_scenario", "load_provenance", "open_produced",
    "produce", "produced_training_arrays", "resolve_store",
    "scenario_conditions", "ShardWriter", "WriterStats",
]
