"""A cell cut to a size the CPU runs in seconds (the configuration's shapes
kept, its scale cut), for the tests."""
import copy
import time

from portbench import harness

TINY = dict(ny=32, nx=16, nsteps=40, nsnaps=9, num_sims=4, base_channels=16, shard_size=8)
TRAIN_CELLS = ("pchip-resident", "pchip-hoststream", "rt-ensemble5")
CELLS = TRAIN_CELLS + ("pchip-datagen",)
SEED = 2 ** 31 + 17


def tiny_cell(name: str) -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell(name))
    cell.config.update(TINY)
    if cell.config["spec"] == "PCHIP_SPEC":
        cell.config.update(ny=32, nx=32)
    cell.config["train"].update(batch_size=8)
    cell.traffic.update(warmup_steps=2, trace_steps=3)
    if "check_step" in cell.traffic:
        cell.traffic["check_step"] = 4
    return cell


def run_tiny(name: str, trace: bool = False, seconds: float = 0.3, seed: int = SEED) -> dict:
    return harness.run_cell(tiny_cell(name), seed, seconds, trace, "cpu", time.perf_counter())
