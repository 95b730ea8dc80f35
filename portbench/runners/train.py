"""Runner of the single-model training cells: ``train_surrogate`` whole.

Set-up produces the configuration's ensemble, opens it as the traffic
says (``"store"``: ``device_resident`` uploads it with
``as_device_resident``, the paper's workflow 2; ``host_stream`` reads the
shards from disk on the ``PrefetchLoader`` thread, workflow 1), makes the
initial weights and the batch order from the seed, and calls
``train_surrogate`` once.  Its hook reads the first steps and then drives
the window: ``warmup_steps`` more steps of set-up, then ``--seconds`` of
steps, after which the hook ends the call.
"""
from __future__ import annotations

from portbench import counts, data, training
from portbench.batches import SeedBatches
from portbench.reference import surrogate as ref_model
from portbench.window import Window


def run(run) -> None:
    from repro_torch.data.store import channels_last
    from repro_torch.datagen import resolve_store, scenario_conditions
    from repro_torch.models.surrogate import SurrogateConfig
    from repro_torch.obs.metrics import get_registry
    from repro_torch.train.loop import TrainConfig, train_surrogate

    cfg, tr, dev, seed = run.config, run.traffic, run.device, run.seed
    tcfg = cfg["train"]
    sdir = data.produce_store(cfg, seed, run.tmp, dev)
    run.mark("produce")
    store = resolve_store(sdir, device=dev)
    shard_size = store.shard_size
    if tr["store"] == "device_resident":
        store = store.as_device_resident(device=dev)
    elif tr["store"] != "host_stream":
        raise ValueError(f"unknown store {tr['store']!r}")
    cond = scenario_conditions(sdir)
    run.mark("open")
    model_cfg = SurrogateConfig(height=cfg["ny"], width=cfg["nx"], fields=cfg["fields"],
                                base_channels=cfg["base_channels"])
    p0 = ref_model.init_params(cfg, seed, dev)
    loader = SeedBatches(store.num_samples, tcfg["batch_size"], shard_size, seed)
    first = tr["first_steps"]
    reg = get_registry()

    def counters():
        return {"fetch_wait": reg.counter("train.fetch_wait_seconds").value,
                "read_seconds": store.stats.read_seconds, "batches": store.stats.batches}

    win = Window(dev, first + tr["warmup_steps"], run.seconds,
                 tr["trace_steps"] if run.trace else 0, counters)
    readings = {"loss": []}

    def hook(step, model, loss):
        if step <= first:
            readings["loss"].append(float(loss))
            params = dict(model.named_parameters())
            if step == 1:
                readings["grad_norm"] = training.norms({k: p.grad for k, p in params.items()})
            if step == first:
                readings["change_norm"] = training.norms(
                    {k: p.detach() for k, p in params.items()}, p0)
                run.mark("first_steps")
        if not win.tick(step):
            raise training.WindowClosed

    train_cfg = TrainConfig(epochs=training.EPOCHS, batch_size=tcfg["batch_size"],
                            lr=tcfg["lr"], seed=seed, log_every=tcfg["log_every"],
                            prefetch=tcfg["prefetch"])
    try:
        train_surrogate(model_cfg, train_cfg, cond, store, params=p0, hooks=[hook],
                        target_transform=channels_last, loader=loader, device=dev)
    except training.WindowClosed:
        pass
    if not win.closed:
        raise RuntimeError("train_surrogate returned before its window closed")

    run.window, run.loader, run.store = win, loader, store
    run.window_batch0 = win.open_at
    run.rate_metric = "train_samples_per_s"
    run.samples_per_step = tcfg["batch_size"]
    run.flops_per_step = counts.train_step_flops(cfg, tcfg["batch_size"])

    def release():
        win.counters = None
        run.store = None

    def check():
        refs = training.follow(cfg, sdir, [p0], [loader.drawn[:first]], dev,
                               tf32=cfg["tf32"])
        return training.compare([readings], refs)

    run.release, run.check = release, check
    run.calibrate = lambda: training.calibration(
        lambda **kw: training.follow(cfg, sdir, [p0], [loader.drawn[:first]], dev, **kw),
        [readings])
