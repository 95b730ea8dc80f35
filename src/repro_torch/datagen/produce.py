"""Streaming data production: simulate -> encode-on-device -> sharded store.

Counterpart of ``repro/datagen/produce.py``, with the same files and
formats: a root either package produced opens in the other, and the same
fields give the same shard and manifest bytes.

``produce(plan, root)`` turns a ``ProductionPlan`` into one on-disk
``ShardedCompressedStore`` per scenario (``root/<scenario>/``) without ever
materializing a dataset in host memory: each ensemble member runs through
the spectral solver on the card (one CUDA graph per snapshot interval), its
snapshots are compressed there in shard-sized chunks (kernel 2, the
fixed-accuracy encode, or kernel 4, the fixed-rate one), and the encoded
chunks stream through a bounded-queue ``ShardWriter`` that overlaps
device->host transfer + disk IO with the next member's simulation.  With
``device="cpu"`` the same path runs on the CPU (the kernels' plain
versions, which give the same bits).

Durability and resume:
  * ``production.json`` (atomic) carries full provenance: the plan, its
    config hash, a git-describe of the producing tree, and every member's
    exact ``SimParams``;
  * each committed shard appends one fsync'd line to a per-host progress
    log; shard files themselves commit via temp + ``os.replace``;
  * the final store ``manifest.json`` is assembled only once every shard is
    present -- its existence is the completion marker;
  * a killed run restarted with the same plan recomputes only the members
    that overlap unfinished shards and never rewrites a finished shard; the
    resulting store is bit-identical to an uninterrupted run (and to the
    in-memory ``ShardedCompressedStore`` build; tests/test_torch_datagen.py).

A member whose fields are not finite (a solver step too long for the
grid) is refused: ``produce`` raises ``NonFiniteMemberError`` before the
member reaches the writer, and the scenario is not finalized.  The codec
would encode NaN into finite values, so a store made from such a member
would train without complaint on garbage.

Multi-host: ``host_id``/``num_hosts`` partition the shard table with
``distributed.sharding.owned_shards``; each host writes its own shards and
progress file, and whichever host finishes last assembles the manifest.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.compression import codec_from_plan
from repro_torch.data.shards import (MANIFEST_NAME, ShardedCompressedStore,
                                     _shard_filename, atomic_write_json,
                                     build_manifest)
from repro_torch.datagen.plan import ProductionPlan, ScenarioPlan, sim_provenance
from repro_torch.datagen.writer import ShardWriter
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import owned_shards
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry
from repro_torch.sim.solver import DT, run_simulation

PRODUCTION_NAME = "production.json"
PRODUCTION_FORMAT = "repro-production-v1"


def _git_describe() -> str:
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def _progress_path(sdir: str, host_id: int) -> str:
    return os.path.join(sdir, f"progress.host{host_id:03d}.jsonl")


def _load_progress(sdir: str, plan_hash: str) -> dict:
    """Merge committed-shard records from every host's progress log.

    Progress files are append-only JSONL (one fsync'd line per committed
    shard, plus a plan-hash header per run), so logging stays O(shards)
    total instead of rewriting per-sample metadata on every commit.  A kill
    mid-append leaves at most one torn final line, which is skipped -- that
    shard is simply recomputed.  Entries whose shard file vanished (e.g. a
    partially copied directory) are dropped, so they get recomputed rather
    than trusted.
    """
    shards: dict = {}
    for path in sorted(glob.glob(os.path.join(sdir, "progress.host*.jsonl"))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue                       # torn tail from a kill
                if "plan_hash" in rec:
                    if rec["plan_hash"] != plan_hash:
                        raise ValueError(
                            f"{path} was produced by plan "
                            f"{rec['plan_hash']!r}, not {plan_hash!r}: "
                            "refusing to mix datasets -- use a new root")
                    continue
                k = int(rec["shard"])
                if os.path.exists(os.path.join(sdir, _shard_filename(k))):
                    shards[k] = rec["meta"]
    return shards


class NonFiniteMemberError(FloatingPointError):
    """A simulated member's fields hold NaN or infinity."""


def _scenario_tolerances(plan: ProductionPlan, sc: ScenarioPlan) -> np.ndarray:
    if plan.codec.mode == "fixed_accuracy":
        return np.full(sc.num_samples, plan.codec.tolerance, np.float32)
    return np.zeros(sc.num_samples, np.float32)    # fixed-rate: no L-inf bound


@dataclasses.dataclass
class ScenarioReport:
    name: str
    store_dir: str
    sims_run: int
    shards_written: int
    samples_produced: int
    bytes_written: int
    seconds: float
    transfer_seconds: float
    write_seconds: float
    finalized: bool
    preempted: bool


@dataclasses.dataclass
class ProduceReport:
    root: str
    plan_hash: str
    scenarios: List[ScenarioReport]

    @property
    def finalized(self) -> bool:
        return all(s.finalized for s in self.scenarios)

    def scenario(self, name: str) -> ScenarioReport:
        return next(s for s in self.scenarios if s.name == name)


# ---------------------------------------------------------------------------
# production
# ---------------------------------------------------------------------------

def produce(plan: ProductionPlan, root: str, *, host_id: int = 0,
            num_hosts: int = 1, overlap: bool = True,
            bandwidth_mbs: Optional[float] = None, queue_depth: int = 2,
            max_shards: Optional[int] = None,
            device: DeviceLike = None) -> ProduceReport:
    """Run (or resume) a production plan into ``root``, simulating and
    encoding on ``device`` (the card unless ``device="cpu"``).

    ``overlap=False`` runs the identical ingest inline (sequential
    baseline for benchmarks); ``bandwidth_mbs`` throttles shard writes to
    emulate a shared file system; ``max_shards`` stops after that many new
    shards per scenario *without* finalizing -- simulated preemption, the
    datagen analog of ``TrainConfig.max_steps``.
    """
    dev = resolve_device(device)
    plan.validate()
    plan_hash = plan.config_hash()
    os.makedirs(root, exist_ok=True)
    reports = []
    for sc in plan.scenarios:
        reports.append(_produce_scenario(
            plan, sc, os.path.join(root, sc.name), plan_hash,
            host_id=host_id, num_hosts=num_hosts, overlap=overlap,
            bandwidth_mbs=bandwidth_mbs, queue_depth=queue_depth,
            max_shards=max_shards, dev=dev))
    return ProduceReport(root=root, plan_hash=plan_hash, scenarios=reports)


def _write_provenance(plan: ProductionPlan, sc: ScenarioPlan, sdir: str,
                      plan_hash: str) -> None:
    path = os.path.join(sdir, PRODUCTION_NAME)
    if os.path.exists(path):
        with open(path) as f:
            prov = json.load(f)
        if prov.get("plan_hash") != plan_hash:
            raise ValueError(
                f"{sdir} holds a dataset from plan {prov.get('plan_hash')!r}"
                f"; this plan hashes to {plan_hash!r} -- refusing to resume "
                "into a different dataset (use a new root)")
        return
    prov = {
        "format": PRODUCTION_FORMAT,
        "plan_hash": plan_hash,
        "plan": plan.to_dict(),
        "scenario": sc.name,
        "git": _git_describe(),
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "sims": [sim_provenance(p) for p in sc.params()],
    }
    atomic_write_json(path, prov)


def _produce_scenario(plan: ProductionPlan, sc: ScenarioPlan, sdir: str,
                      plan_hash: str, *, host_id: int, num_hosts: int,
                      overlap: bool, bandwidth_mbs: Optional[float],
                      queue_depth: int, max_shards: Optional[int],
                      dev: torch.device) -> ScenarioReport:
    t_start = time.perf_counter()
    os.makedirs(sdir, exist_ok=True)
    _write_provenance(plan, sc, sdir, plan_hash)

    nsnaps = sc.spec.nsnaps
    n, size = sc.num_samples, plan.shard_size
    num_shards = -(-n // size)
    owned = [int(k) for k in owned_shards(num_shards, host_id, num_hosts)]
    done = _load_progress(sdir, plan_hash)
    unfinished = [k for k in owned if k not in done]
    preempted = False
    if max_shards is not None and len(unfinished) > max_shards:
        unfinished, preempted = unfinished[:max_shards], True

    # members overlapping any unfinished shard must re-simulate; finished
    # shards are never recomputed or rewritten
    sims = sorted({i for k in unfinished
                   for i in range(k * size // nsnaps,
                                  (min((k + 1) * size, n) - 1) // nsnaps + 1)})

    progress_path = _progress_path(sdir, host_id)
    if sims:            # header line: which plan this run's commits belong to
        with open(progress_path, "a") as pf:
            pf.write(json.dumps({"plan_hash": plan_hash}) + "\n")
            pf.flush()
            os.fsync(pf.fileno())

    def on_shard(k: int, meta: dict) -> None:
        # append-only commit log: one fsync'd line per shard, never a
        # rewrite, so progress IO stays O(shards) over the whole run
        with open(progress_path, "a") as pf:
            pf.write(json.dumps({"shard": k, "meta": meta}) + "\n")
            pf.flush()
            os.fsync(pf.fileno())

    writer = ShardWriter(sdir, size, n, unfinished, on_shard=on_shard,
                         bandwidth_mbs=bandwidth_mbs, overlap=overlap,
                         depth=queue_depth)
    params = sc.params()
    codec = codec_from_plan(plan.codec)
    reg = get_registry()
    # the default step is left to the solver's default only so that a stand-in
    # for run_simulation without a dt parameter still works: the JAX solver
    # that tests/test_torch_datagen.py feeds through here; that stub is the
    # only reason for the branch
    step = {} if sc.spec.dt == DT else {"dt": sc.spec.dt}
    try:
        for i in sims:
            # on the card this span ends in a wait for the member's whole
            # simulation: the solver's last scalar upload is a synchronous
            # copy behind the graph's replays (it also holds the capture's
            # device synchronise, a datagen.capture span); the finite flags'
            # read then waits only for the material's normalisation
            t0 = time.perf_counter()
            with obs_trace.span("datagen.simulate", cat="datagen",
                                scenario=sc.name, member=i):
                fields = run_simulation(params[i], ny=sc.spec.ny,
                                        nx=sc.spec.nx, nsteps=sc.spec.nsteps,
                                        nsnaps=nsnaps, device=dev, **step)
                # NaN propagates through min and max and an infinity is an
                # extreme: one pass over the fields, no temporary of their size
                low, high = torch.aminmax(fields.view(nsnaps, -1), dim=1)
                finite = (low.isfinite() & high.isfinite()).cpu()
            reg.histogram("datagen.simulate_seconds").observe(time.perf_counter() - t0)
            reg.counter("datagen.rk3_steps").add(sc.spec.rk3_steps)
            if not finite.all():
                reg.counter("datagen.nonfinite_members").add()
                raise NonFiniteMemberError(
                    f"scenario {sc.name!r}, member {i}: non-finite fields from "
                    f"snapshot {int((~finite).nonzero()[0])} of {nsnaps} (dt "
                    f"{sc.spec.dt} at {sc.spec.ny}x{sc.spec.nx}); the member was "
                    "not written and the scenario is not finalized")
            samples = fields.movedim(-1, 1)              # (T, C, H, W)
            for lo in range(0, nsnaps, size):
                chunk = samples[lo:lo + size]
                # the encode kernel is queued on the card and the worker's
                # copy waits for it (datagen.transfer); this span is its
                # dispatch, which waits for the stream once: the tolerances'
                # upload is a synchronous copy behind the chunk's blocking
                with obs_trace.span("datagen.encode", cat="datagen",
                                    scenario=sc.name, samples=len(chunk)):
                    cf = codec.encode_batch(chunk)
                writer.put(i * nsnaps + lo, cf)
        writer.close()
    except BaseException:
        # a preempted/failed run leaves committed shards + progress behind
        # for the next produce() call to resume from; abort() joins the
        # worker so nothing leaks a thread or queued device buffers
        writer.abort()
        raise

    finalized = False
    if not preempted:
        finalized = finalize_scenario(plan, sc, sdir)
    st = writer.stats
    # samples that actually landed in this run's shards: a resumed member's
    # snapshots that re-fed an already-finished shard are dropped, not produced
    produced_samples = sum(min((k + 1) * size, n) - k * size
                           for k in unfinished)
    return ScenarioReport(
        name=sc.name, store_dir=sdir, sims_run=len(sims),
        shards_written=st.shards_written, samples_produced=produced_samples,
        bytes_written=st.bytes_written,
        seconds=time.perf_counter() - t_start,
        transfer_seconds=st.transfer_seconds, write_seconds=st.write_seconds,
        finalized=finalized, preempted=preempted)


def finalize_scenario(plan: ProductionPlan, sc: ScenarioPlan,
                      sdir: str) -> bool:
    """Assemble the store manifest once every shard is present.

    Idempotent and multi-host safe: merges every host's progress file and
    returns False while any shard is still missing.  The manifest itself is
    written atomically, so readers either see a complete store or none.
    """
    n, size = sc.num_samples, plan.shard_size
    num_shards = -(-n // size)
    plan_hash = plan.config_hash()
    if os.path.exists(os.path.join(sdir, MANIFEST_NAME)):
        return True
    shards = _load_progress(sdir, plan_hash)
    if len(shards) < num_shards:
        return False
    widths = np.zeros(n, np.int64)
    logical = np.zeros(n, np.int64)
    for k in range(num_shards):
        meta = shards[k]
        lo = meta["start"]
        widths[lo:lo + meta["count"]] = meta["widths"]
        logical[lo:lo + meta["count"]] = meta["logical_bytes"]
    any_meta = shards[0]
    manifest = build_manifest(
        sc.sample_shape, any_meta["padded_shape"], any_meta["block_count"],
        size, n, _scenario_tolerances(plan, sc), widths, logical)
    atomic_write_json(os.path.join(sdir, MANIFEST_NAME), manifest)
    return True


def finalize(plan: ProductionPlan, root: str) -> bool:
    """Finalize every scenario of ``plan`` under ``root`` (multi-host tail
    step when no single host saw the last shard land)."""
    plan.validate()
    return all(finalize_scenario(plan, sc, os.path.join(root, sc.name))
               for sc in plan.scenarios)


# ---------------------------------------------------------------------------
# consuming produced datasets
# ---------------------------------------------------------------------------

def load_provenance(scenario_dir: str) -> dict:
    with open(os.path.join(scenario_dir, PRODUCTION_NAME)) as f:
        return json.load(f)


def scenario_conditions(scenario_dir: str) -> np.ndarray:
    """(num_samples, PARAM_DIM + 1) conditioning vectors for a produced
    scenario, rebuilt from the provenance manifest's exact ``SimParams``."""
    from repro_torch.models.surrogate import make_conditions
    from repro_torch.sim.solver import SimParams
    prov = load_provenance(scenario_dir)
    nsnaps = next(s for s in prov["plan"]["scenarios"]
                  if s["name"] == prov["scenario"])["spec"]["nsnaps"]
    pvec = np.stack([SimParams(**d).as_vector() for d in prov["sims"]])
    return make_conditions(pvec, nsnaps)


def _resolve_scenario_dir(path: str) -> str:
    """Directory of the finalized store a produced-dataset path names.

    Accepts a scenario directory (holds ``manifest.json``) or a production
    root containing exactly one finalized scenario.  Raises with the list of
    candidates when the choice is ambiguous or production never finalized.
    """
    if os.path.exists(os.path.join(path, MANIFEST_NAME)):
        return path
    cands = sorted(d for d in glob.glob(os.path.join(path, "*"))
                   if os.path.exists(os.path.join(d, PRODUCTION_NAME)))
    final = [d for d in cands
             if os.path.exists(os.path.join(d, MANIFEST_NAME))]
    if len(final) == 1:
        return final[0]
    if not cands:
        raise FileNotFoundError(f"{path} holds no produced dataset "
                                f"(no {MANIFEST_NAME} or {PRODUCTION_NAME})")
    if not final:
        raise FileNotFoundError(
            f"{path} holds unfinished production(s) {cands}: resume "
            "produce() to completion first")
    raise ValueError(f"{path} holds several scenarios {final}: pass one "
                     "scenario directory explicitly")


def resolve_store(path: str,
                  bandwidth_mbs: Optional[float] = None,
                  device: DeviceLike = None) -> ShardedCompressedStore:
    """Open the ``ShardedCompressedStore`` a produced-dataset path names;
    its batches decode on ``device`` (the card unless ``device="cpu"``)."""
    return ShardedCompressedStore.open(_resolve_scenario_dir(path),
                                       bandwidth_mbs=bandwidth_mbs,
                                       device=device)


def produced_training_arrays(path: str, conditions: Optional[np.ndarray] = None,
                             batch: int = 64, device: DeviceLike = None):
    """Materialize a produced dataset for array-consuming pipelines.

    Returns ``(conditions, fields)`` as numpy arrays, with channels-last
    (N, H, W, C) fields decoded batch-by-batch from the store on ``device``
    (the card unless ``device="cpu"``).  When ``conditions`` is None they
    are rebuilt from the provenance manifest's exact ``SimParams``.  This is
    the seam that lets ``certify_tolerance`` take a produced-dataset path.
    """
    sdir = _resolve_scenario_dir(path)
    store = ShardedCompressedStore.open(sdir, device=device)
    fields = np.concatenate(
        [store.get_batch(np.arange(lo, min(lo + batch, store.num_samples)))
         .cpu().numpy() for lo in range(0, store.num_samples, batch)])
    fields = np.moveaxis(fields, 1, -1)
    if conditions is None:
        conditions = scenario_conditions(sdir)
    if len(conditions) != len(fields):
        raise ValueError(f"{len(conditions)} conditions for {len(fields)} "
                         f"produced samples in {sdir}")
    return conditions, fields


class ProducedDataset:
    """Read-side handle on a production root: stores + provenance + conditions."""

    def __init__(self, root: str):
        self.root = root
        self.scenario_dirs = {
            os.path.basename(d.rstrip("/")): d
            for d in sorted(glob.glob(os.path.join(root, "*")))
            if os.path.exists(os.path.join(d, PRODUCTION_NAME))}
        if not self.scenario_dirs:
            raise FileNotFoundError(f"no produced scenarios under {root}")
        self._stores: dict = {}

    @property
    def names(self) -> list:
        return sorted(self.scenario_dirs)

    def provenance(self, name: str) -> dict:
        return load_provenance(self.scenario_dirs[name])

    def store(self, name: str, bandwidth_mbs: Optional[float] = None,
              device: DeviceLike = None) -> ShardedCompressedStore:
        """The scenario's store, decoding on ``device`` (the card unless
        ``device="cpu"``); opened once per scenario."""
        if name not in self._stores:
            self._stores[name] = ShardedCompressedStore.open(
                self.scenario_dirs[name], bandwidth_mbs=bandwidth_mbs,
                device=device)
        return self._stores[name]

    def conditions(self, name: str) -> np.ndarray:
        return scenario_conditions(self.scenario_dirs[name])


def open_produced(root: str) -> ProducedDataset:
    return ProducedDataset(root)
