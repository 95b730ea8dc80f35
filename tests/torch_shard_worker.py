"""One rank of a CPU gloo group for the port's sharded-step tests.

    python tests/torch_shard_worker.py CASE RANK WORLD STORE_FILE IN_NPZ OUT_NPZ

Joins a ``torch.distributed`` gloo group of WORLD ranks through a
``FileStore`` (no network), builds a named mesh over it and runs the case:

* ``train:<arch>`` -- mesh (data 2, model 2).  IN_NPZ holds the parameters
  (``p/<leaf key>``, the JAX package's ``init_lm`` of the reduced config)
  and a batch (``tokens``, ``labels``).  Writes the sharded
  ``loss_and_grads`` (loss, ``g/<key>`` full gradients), the updated
  parameters of the dry run's ``make_train_step`` (``u/<key>``) and of the
  unsharded port's ``train_step`` (``w/<key>``), and the logits of a sharded
  prefill and ``DECODE_STEPS`` decode steps (``sp``, ``sd<i>``) beside the
  unsharded port's (``up``, ``ud<i>``).
* ``pod`` -- mesh (pod 2, data 1, model 2).  Writes, for 8 and 24 bits, the
  pod-compressed step's loss (``loss_gc<b>``), the raw step's loss
  (``loss_raw``), whether the updated parameters are finite, the
  collective-permute bytes of the step (``perm_gc<b>``), and this rank's
  :func:`exchange` mean of ``exchange_tree(rank)`` at 12 bits (``x/<key>``).

Rank 0 writes OUT_NPZ for ``train``; every rank writes
``OUT_NPZ.<rank>.npz`` for ``pod``.  Not a test file: the tests start it.
"""
import sys

import numpy as np

DECODE_STEPS = 3
PROMPT, MAX_SEQ = 12, 16
EXCHANGE_BITS = 12


def exchange_tree(rank: int) -> dict:
    """This rank's gradient shard for the exchange check (made from a seed
    with numpy): a 2-D leaf, a 3-D leaf and a small one."""
    rng = np.random.default_rng(500 + rank)
    return {"w": (1e-2 * rng.normal(size=(24, 40))).astype(np.float32),
            "e": (1e-3 * rng.normal(size=(3, 8, 20))).astype(np.float32),
            "b": (1e-2 * rng.normal(size=(7,))).astype(np.float32)}


def _nest(flat: dict, prefix: str) -> dict:
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _flat(tree, prefix: str, out: dict) -> dict:
    from repro_torch.compression import tree_flatten_with_path
    for key, leaf in tree_flatten_with_path(tree)[0]:
        out[prefix + key] = leaf.detach().float().numpy()
    return out


def run_train(arch: str, inputs: dict, out_path: str, rank: int) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.compression import tree_map
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import (batch_specs, distribute_tree,
                                                  gather_tree, opt_specs, param_specs)
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import adam_init_tree, loss_and_grads, train_step
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamConfig

    cfg = reduced_config(arch)
    params = lm.params_from_jax(_nest(inputs, "p/"), "cpu")
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    pspecs = param_specs(params)
    dparams = distribute_tree(params, mesh, pspecs)
    dbatch = distribute_tree(batch, mesh, batch_specs(cfg, "train", False))
    out = {}
    lm.set_constraint_mesh(mesh)
    try:
        loss, grads = loss_and_grads(dparams, cfg, dbatch)
        out["loss"] = np.asarray(float(loss.full_tensor()), np.float32)
        _flat(gather_tree(grads), "g/", out)
        opt = distribute_tree(adam_init_tree(params), mesh, opt_specs(pspecs))
        new, _, _ = dryrun.make_train_step(cfg)(dparams, opt, dbatch)
        _flat(gather_tree(new), "u/", out)
        with torch.no_grad():
            pbatch = {"tokens": dbatch["tokens"][:, :PROMPT]}
            logits, cache = lm.lm_prefill(dparams, cfg, pbatch, MAX_SEQ)
            out["sp"] = logits.full_tensor().numpy()
            tok = dbatch["tokens"][:, PROMPT]
            for i in range(DECODE_STEPS):
                logits, cache = lm.serve_step(dparams, cfg, cache, tok, PROMPT + i)
                out[f"sd{i}"] = logits.full_tensor().numpy()
                tok = logits.argmax(-1).to(torch.int32)
    finally:
        lm.set_constraint_mesh(None)
    # the launcher's step updates its parameters in place: give it a copy,
    # the prefill below reads the initial ones
    ref, _, _ = train_step(tree_map(torch.clone, params), adam_init_tree(params), batch, cfg,
                           AdamConfig(lr=1e-4, grad_clip=1.0))
    _flat(ref, "w/", out)
    with torch.no_grad():
        logits, cache = lm.lm_prefill(params, cfg, {"tokens": batch["tokens"][:, :PROMPT]},
                                      MAX_SEQ)
        out["up"] = logits.numpy()
        tok = batch["tokens"][:, PROMPT]
        for i in range(DECODE_STEPS):
            logits, cache = lm.serve_step(params, cfg, cache, tok, PROMPT + i)
            out[f"ud{i}"] = logits.numpy()
            tok = torch.from_numpy(out[f"sd{i}"]).argmax(-1).to(torch.int32)
    if rank == 0:
        np.savez(out_path, **out)


def run_pod(inputs: dict, out_path: str, rank: int) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import reduced_config
    from repro_torch.core.grad_compress import as_codec
    from repro_torch.distributed.sharding import (batch_specs, distribute_tree,
                                                  opt_specs, param_specs)
    from repro_torch.launch import dryrun
    from repro_torch.launch.comm_analysis import CommAnalysis
    from repro_torch.launch.train import adam_init_tree
    from repro_torch.models import lm

    cfg = reduced_config("internlm2-1.8b")
    params = lm.params_from_jax(_nest(inputs, "p/"), "cpu")
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "labels")}
    mesh = init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=("pod", "data", "model"))
    pod_mesh = mesh["data", "model"]
    pspecs = param_specs(params)
    dbatch = distribute_tree(batch, mesh, batch_specs(cfg, "train", True))
    out = {}
    lm.set_constraint_mesh(mesh)
    try:
        raw = distribute_tree(params, mesh, pspecs)
        opt = distribute_tree(adam_init_tree(params), mesh, opt_specs(pspecs))
        _, _, loss = dryrun.make_train_step(cfg)(raw, opt, dbatch)
        out["loss_raw"] = np.asarray(float(loss.full_tensor()), np.float32)
        for bits in (8, 24):
            local = distribute_tree(params, pod_mesh, pspecs)
            opt = distribute_tree(adam_init_tree(params), pod_mesh, opt_specs(pspecs))
            analysis = CommAnalysis(mesh)
            with analysis:
                new, _, loss = dryrun.make_train_step_podcompressed(cfg, mesh, bits)(
                    local, opt, dbatch)
            out[f"loss_gc{bits}"] = np.asarray(float(loss), np.float32)
            out[f"perm_gc{bits}"] = np.asarray(analysis.collectives["collective-permute"])
            out[f"finite_gc{bits}"] = np.asarray(all(
                bool(torch.isfinite(t.to_local().float()).all())
                for t in _leaves(new)))
    finally:
        lm.set_constraint_mesh(None)
    mean = dryrun.exchange({k: torch.from_numpy(v) for k, v in exchange_tree(rank).items()},
                           mesh, as_codec(EXCHANGE_BITS), 2)
    for k, v in mean.items():
        out[f"x/{k}"] = v.numpy()
    np.savez(f"{out_path}.{rank}.npz", **out)


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    return [tree]


def main(argv) -> int:
    case, rank, world, store_file, in_path, out_path = argv
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    inputs = dict(np.load(in_path))
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        if case.startswith("train:"):
            run_train(case.split(":", 1)[1], inputs, out_path, rank)
        else:
            run_pod(inputs, out_path, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
