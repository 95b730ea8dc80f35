"""Set-up shared by the cells: the produced dataset a cell trains from.

``produce`` of ``ScenarioPlan(spec, members, seed)`` writes the store
under the run's temporary directory, as a user produces one.  The
reference reads the same files back with its own code
(``reference/zfp.py``, ``reference/data.py``).
"""
from __future__ import annotations

import dataclasses
import os


def plan_for(cfg: dict, members: int, seed: int):
    """The production plan of ``members`` members of the configuration's
    ensemble, their parameters drawn from ``seed``."""
    from repro_torch.datagen import CodecPlan, ProductionPlan, ScenarioPlan
    from repro_torch.sim import ensemble
    spec = dataclasses.replace(getattr(ensemble, cfg["spec"]), ny=cfg["ny"], nx=cfg["nx"],
                               nsnaps=cfg["nsnaps"], nsteps=cfg["nsteps"])
    return ProductionPlan(scenarios=(ScenarioPlan(spec.name, spec, int(members), int(seed)),),
                          codec=CodecPlan(**cfg["codec"]), shard_size=cfg["shard_size"])


def produce_store(cfg: dict, seed: int, root: str, dev, members=None) -> str:
    """Produce the configuration's ensemble (``num_sims`` members unless
    ``members``) into ``root``; returns the scenario directory (the
    finalized store)."""
    from repro_torch.datagen import produce
    plan = plan_for(cfg, members or cfg["num_sims"], seed)
    report = produce(plan, root, device=dev)
    if not report.finalized:
        raise RuntimeError(f"production into {root} did not finalize")
    return os.path.join(root, plan.scenarios[0].name)
