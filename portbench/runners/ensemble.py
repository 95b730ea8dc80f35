"""Runner of the seed-ensemble cells: ``train_ensemble`` on one shared
device-resident store.

Set-up produces the ensemble, uploads it, makes every member's initial
weights (one draw) and batch order (seeds ``seed .. seed + members - 1``)
and calls ``train_ensemble`` for the first steps, logging every step.
``train_ensemble`` takes neither hooks nor an optimizer state, so the
window is a second call on the parameters the first returned and on the
same batch order, continued: the loader runs ``warmup_steps`` steps of
set-up, then ``--seconds`` of steps, and ends the call by ending the
stream.  Adam's moments and step count start again in that call.

Both calls are held to the reference.  The first by its first steps
(each step's loss and each leaf's change), from the initial weights.  The
timed call by the loss it logs at its step ``check_step`` (it logs every
``check_step`` steps, inside the window): the reference follows that
call's first ``check_step`` batches from the parameters the first call
returned, with Adam started again as the call starts it.  A window too
short to reach that step is run on to it after it has closed.
"""
from __future__ import annotations

from portbench import counts, data, training
from portbench.batches import SeedBatches
from portbench.reference import surrogate as ref_model
from portbench.window import Window


def run(run) -> None:
    from repro_torch.core.ensemble import train_ensemble
    from repro_torch.data.store import channels_last
    from repro_torch.datagen import resolve_store, scenario_conditions
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.train.loop import TrainConfig

    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    tcfg, members = cfg["train"], tr["members"]
    if tr["store"] != "device_resident":
        raise ValueError(f"unknown store {tr['store']!r}")
    sdir = data.produce_store(cfg, seed, run.tmp, dev)
    run.mark("produce")
    host = resolve_store(sdir, device=dev)
    store = host.as_device_resident(device=dev)
    del host
    cond = scenario_conditions(sdir)
    run.mark("open")
    model_cfg = SurrogateConfig(height=cfg["ny"], width=cfg["nx"], fields=cfg["fields"],
                                base_channels=cfg["base_channels"])
    p0 = ref_model.init_params(cfg, seed, dev, members=members)
    loader = SeedBatches(store.num_samples, tcfg["batch_size"], store.shard_size, seed,
                         members=members)
    seeds = loader.seeds
    first = tr["first_steps"]

    def call(params, **kw):
        train_cfg = TrainConfig(epochs=training.EPOCHS, batch_size=tcfg["batch_size"],
                                lr=tcfg["lr"], seed=seed, **kw)
        return train_ensemble(model_cfg, train_cfg, cond, store, seeds,
                              target_transform=channels_last, params=params,
                              loader=loader, device=dev)

    res = call(p0, log_every=1, max_steps=first)
    losses = [loss for _, loss in res.losses]
    readings = [{"loss": [float(step_loss[m]) for step_loss in losses],
                 "change_norm": training.norms({k: v[m] for k, v in res.params.items()},
                                               {k: v[m] for k, v in p0.items()})}
                for m in range(members)]
    run.mark("first_steps")

    k = tr["check_step"]
    p1 = {name: v.detach().clone() for name, v in res.params.items()}
    win = Window(dev, tr["warmup_steps"], run.seconds, tr["trace_steps"] if run.trace else 0)
    loader.on_draw = lambda n: win.tick(n) or n < k
    res = call(res.params, log_every=k)
    loader.on_draw = None
    if not win.closed:
        raise RuntimeError("train_ensemble returned before its window closed")
    logged = dict(res.losses)
    del res
    window_readings = [{"loss": [float(logged[k][m])]} for m in range(members)]

    run.window, run.loader, run.store = win, loader, store
    run.window_batch0 = first + win.open_at
    run.rate_metric = "ensemble_samples_per_s"
    run.samples_per_step = members * tcfg["batch_size"]
    run.flops_per_step = counts.train_step_flops(cfg, members * tcfg["batch_size"])
    member_p0 = [{k: v[m] for k, v in p0.items()} for m in range(members)]
    member_batches = [[b[m] for b in loader.drawn[:first]] for m in range(members)]
    member_p1 = [{name: v[m] for name, v in p1.items()} for m in range(members)]
    window_batches = [[b[m] for b in loader.drawn[first:first + k]] for m in range(members)]

    def follow_first(**kw):
        return training.follow(cfg, sdir, member_p0, member_batches, dev, **kw)

    def follow_window(**kw):
        return [{"loss": r["loss"][-1:]}
                for r in training.follow(cfg, sdir, member_p1, window_batches, dev, **kw)]

    def release():
        run.store = None

    def check():
        tf32 = cfg["tf32"]
        return {**training.compare(readings, follow_first(tf32=tf32)),
                **training.window_gap(training.compare(window_readings,
                                                       follow_window(tf32=tf32)))}

    def calibrate():
        first_steps = training.calibration(follow_first, readings)
        window = training.calibration(follow_window, window_readings)
        for key in ("program", "control"):
            first_steps[key].update(training.window_gap(window[key]))
        for fault, numbers in window["faults"].items():
            first_steps["faults"][fault].update(training.window_gap(numbers))
        return first_steps

    run.release, run.check, run.calibrate = release, check, calibrate
