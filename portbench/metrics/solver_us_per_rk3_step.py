"""Host microseconds the cell's production spends a solver step: the
program's registry histogram ``datagen.simulate_seconds`` (each member's
``datagen.simulate`` span, which ends in its wait for the device) summed,
over its counter ``datagen.rk3_steps``.  The registry records outside any
profiler capture, so the reading is the set-up's production whole: its
graph captures and its per-member waits counted.  A program without these
records reads nothing."""


def read(run):
    from repro_torch.obs.metrics import get_registry
    snap = get_registry().snapshot()
    steps = snap.get("datagen.rk3_steps")
    simulate = snap.get("datagen.simulate_seconds")
    if not steps or not isinstance(simulate, dict) or not simulate.get("count"):
        return None
    return 1e6 * simulate["mean"] * simulate["count"] / steps
