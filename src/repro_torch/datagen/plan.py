"""Production plans: declarative simulate -> compress -> shard specifications.

A copy of ``repro/datagen/plan.py``: the same plans serialize to the same
canonical JSON and hash to the same ``config_hash`` in both packages, so a
``production.json`` either package wrote names its plan for the other.
A spec's time step is the one field the JAX package lacks: left out of the
JSON while it is the solver's default, so such plans hash as they do there;
a plan that carries another (``RT_PAPER_SPEC``'s) is the port's alone.

A ``ProductionPlan`` pins everything that determines the bytes of a produced
dataset: the scenario sweep (which ``EnsembleSpec`` ensembles, how many
members, which parameter-sampling seed), the codec (error-bounded
fixed-accuracy tolerance or fixed-rate bits), and the shard geometry.  Plans serialize to canonical JSON
and hash deterministically (``config_hash``), so a resumed production run
can verify it is continuing the *same* plan and the provenance manifest can
name the exact configuration that produced every byte on disk.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple

from repro_torch.sim.ensemble import EnsembleSpec, sample_params
from repro_torch.sim.solver import DT, SimParams

PLAN_FORMAT = "repro-production-plan-v1"
CODEC_MODES = ("fixed_accuracy", "fixed_rate")


@dataclasses.dataclass(frozen=True)
class CodecPlan:
    """On-device compression configuration for produced snapshots.

    ``use_pallas`` selects nothing in this package (the device of the
    snapshots picks the CUDA kernel or its plain version, which give the
    same bits).  It is kept, with its name and meaning in the JSON, because
    the JAX package's fixed-rate plans hash it: a plan that differs in it
    must hash differently here too.
    """
    mode: str = "fixed_accuracy"
    tolerance: float = 1e-3          # fixed_accuracy: L-inf bound per sample
    bits_per_value: int = 12         # fixed_rate: uniform planes per value
    use_pallas: bool = False         # the JAX package's Pallas encode switch

    def validate(self) -> None:
        if self.mode not in CODEC_MODES:
            raise ValueError(f"codec mode {self.mode!r} not in {CODEC_MODES}")
        if self.mode == "fixed_accuracy" and not self.tolerance > 0:
            raise ValueError("fixed_accuracy needs tolerance > 0")
        if self.mode == "fixed_rate" and not 0 < self.bits_per_value <= 30:
            raise ValueError("fixed_rate needs 0 < bits_per_value <= 30")

    def to_dict(self) -> dict:
        """Canonical form carrying only the fields that can change the
        produced bytes in the JAX package.  ``use_pallas`` is excluded under
        fixed-accuracy (its Pallas and jnp encoders give the same bits), so
        flipping it does not perturb the plan hash and refuse a resume of a
        byte-identical dataset; fixed-rate plans keep it, as the JAX
        package hashes them."""
        if self.mode == "fixed_accuracy":
            return {"mode": self.mode, "tolerance": self.tolerance}
        return {"mode": self.mode, "bits_per_value": self.bits_per_value,
                "use_pallas": self.use_pallas}


@dataclasses.dataclass(frozen=True)
class ScenarioPlan:
    """One ensemble sweep: ``num_sims`` members of ``spec`` from ``seed``.

    The member parameters are *derived*, never stored: ``params()`` re-draws
    the same ``sample_params(spec, num_sims, seed)`` sweep every time, so a
    resumed run re-simulates exactly the members the first run planned.
    """
    name: str
    spec: EnsembleSpec
    num_sims: int
    seed: int = 0

    def validate(self) -> None:
        if not self.name or "/" in self.name:
            raise ValueError(f"scenario name {self.name!r} must be a plain "
                             "directory name")
        if self.num_sims <= 0:
            raise ValueError("num_sims must be positive")

    def params(self) -> list:
        return sample_params(self.spec, self.num_sims, self.seed)

    @property
    def num_samples(self) -> int:
        return self.num_sims * self.spec.nsnaps

    @property
    def sample_shape(self) -> Tuple[int, int, int]:
        """Channels-first (C, H, W) store layout (compress trailing 2 dims)."""
        return (6, self.spec.ny, self.spec.nx)


@dataclasses.dataclass(frozen=True)
class ProductionPlan:
    """Everything that determines a produced dataset, bit for bit."""
    scenarios: Tuple[ScenarioPlan, ...]
    codec: CodecPlan = CodecPlan()
    shard_size: int = 32

    def validate(self) -> None:
        if not self.scenarios:
            raise ValueError("plan needs at least one scenario")
        names = [s.name for s in self.scenarios]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate scenario names: {names}")
        if self.shard_size <= 0:
            raise ValueError("shard_size must be positive")
        self.codec.validate()
        for s in self.scenarios:
            s.validate()

    def scenario(self, name: str) -> ScenarioPlan:
        for s in self.scenarios:
            if s.name == name:
                return s
        raise KeyError(f"no scenario {name!r} in plan "
                       f"({[s.name for s in self.scenarios]})")

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "format": PLAN_FORMAT,
            "shard_size": self.shard_size,
            "codec": self.codec.to_dict(),
            "scenarios": [_scenario_dict(s) for s in self.scenarios],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProductionPlan":
        if d.get("format") != PLAN_FORMAT:
            raise ValueError(f"unknown plan format {d.get('format')!r}")
        scenarios = []
        for sd in d["scenarios"]:
            spec = dict(sd["spec"])
            for k, v in spec.items():          # JSON lists -> spec tuples
                if isinstance(v, list):
                    spec[k] = tuple(v)
            scenarios.append(ScenarioPlan(name=sd["name"],
                                          spec=EnsembleSpec(**spec),
                                          num_sims=int(sd["num_sims"]),
                                          seed=int(sd["seed"])))
        plan = cls(scenarios=tuple(scenarios),
                   codec=CodecPlan(**d["codec"]),
                   shard_size=int(d["shard_size"]))
        plan.validate()
        return plan

    def config_hash(self) -> str:
        """Deterministic hash of the canonical plan JSON.

        Written into every provenance manifest; a resume against a directory
        whose hash differs is refused (it would silently mix two datasets).
        """
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()[:16]


def _scenario_dict(s: ScenarioPlan) -> dict:
    d = dataclasses.asdict(s)
    if s.spec.dt == DT:
        del d["spec"]["dt"]
    return d


def sim_provenance(p: SimParams) -> dict:
    """JSON-able record of one member's full conditioning parameters."""
    return dataclasses.asdict(p)
