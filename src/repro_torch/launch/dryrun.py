"""Dry run of the production meshes: the port of ``repro/launch/dryrun.py``.

It runs on the CPU by design, as the reference runs on 512 placeholder host
devices: one process starts torch's ``fake`` process group of 256 or 512
ranks (:func:`repro_torch.launch.mesh.init_fake_process_group`), builds the
(16, 16) or (2, 16, 16) mesh, and runs one step of each (arch, shape) cell
once on meta DTensors: parameters, optimizer state, inputs and caches at
their sharded placements, no values, no allocation, collectives that move
nothing.  :class:`repro_torch.launch.comm_analysis.CommAnalysis` counts
what one device would run: its local FLOPs, dot bytes and collective bytes
by kind and mesh axis.

Each cell writes JSON with the reference's keys (dryrun.py:348-385) to
``experiments/dryrun_torch/``, with these differences:

* ``trace_seconds`` (CPU seconds to trace the step eagerly) takes the place
  of ``compile_seconds``;
* ``xla_cost_analysis`` has no counterpart (there is no compiler), and
  ``collective_bytes_uncorrected`` equals ``collective_bytes_per_device``:
  bytes are counted in the dtype sent;
* ``memory_analysis`` holds the argument and output bytes per device, from
  the local shards, and the peak from ``MemTracker`` where it runs (an
  ``{"error": ...}`` entry where it does not);
* ``terms`` are modelled from the H100 SXM datasheet constants of
  :mod:`repro_torch.launch.mesh`, never measured: ``collective_s`` sums
  each mesh axis's bytes over the bandwidth of the link that axis crosses.

A decode cell's step takes its position as a number, ``seq_len - 1``: the
step attends over the whole cache, as the reference's compiled step does
with its position masks.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --cell all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --cell train_4k \\
      --mesh multi --grad-compress-bits 12
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.compression import (CompressedField, decode_tree, encode_tree,
                                     tree_flatten)
from repro_torch.configs import (ALL_ARCHS, SHAPE_CELLS, ArchConfig, ShapeCell,
                                 cell_applicable, get_config)
from repro_torch.core.grad_compress import as_codec
from repro_torch.distributed.sharding import (batch_specs, distribute_tree, opt_specs,
                                              param_specs, resolve_specs)
from repro_torch.launch.comm_analysis import CommAnalysis
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, axis_links,
                                     init_fake_process_group, link_bandwidth,
                                     make_production_mesh)
from repro_torch.launch.train import (adam_init_tree, apply_adam, loss_and_grads,
                                      replicated)
from repro_torch.models import lm
from repro_torch.train.optimizer import AdamConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input (dryrun.py:38): the
    encoder-decoder splits the sequence between its tokens and its
    ``encoder_embeds``; the VLM's tokens leave room for ``frontend_seq``
    image embeddings."""
    b, s = cell.global_batch, cell.seq_len
    f32, i32 = torch.float32, torch.int32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "decode":
        return {"tokens": meta((b,), i32), "pos": meta((), i32)}
    if cfg.encoder_layers:                       # enc-dec: split the budget
        half = s // 2
        return {"tokens": meta((b, half), i32), "labels": meta((b, half), i32),
                "encoder_embeds": meta((b, half, cfg.frontend_dim), f32)}
    out = {"tokens": meta((b, s - cfg.frontend_seq), i32),
           "labels": meta((b, s - cfg.frontend_seq), i32)}
    if cfg.frontend == "vision":
        out["frontend_embeds"] = meta((b, cfg.frontend_seq, cfg.frontend_dim), f32)
    return out


def _abstract_state(cfg: ArchConfig):
    """Parameters and Adam state on the meta device (dryrun.py:58)."""
    params = lm.init_lm(0, cfg, device="meta")
    return params, adam_init_tree(params)


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, microbatches: int = 1):
    """Training step (dryrun.py:68); ``microbatches > 1`` is gradient
    accumulation over micro-slices of the global batch, summed in f32."""
    opt_cfg = AdamConfig(lr=1e-4, grad_clip=1.0)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = loss_and_grads(params, cfg, batch)
        else:
            k = microbatches
            loss, grads = None, None
            for i in range(k):
                mb = {n: x[i * (x.shape[0] // k):(i + 1) * (x.shape[0] // k)]
                      for n, x in batch.items()}
                l, g = loss_and_grads(params, cfg, mb)
                g = _tree_map(lambda t: t.float(), g)
                loss = l if loss is None else loss + l
                grads = g if grads is None else _tree_map(torch.add, grads, g)
            loss = loss / k
            grads = _tree_map(lambda g: g / k, grads)
        grads = _tree_map(lambda g: g.float(), grads)
        params, opt_state = apply_adam(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss

    return train_step


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def pod_local(x: DTensor, pod_mesh) -> DTensor:
    """A full-mesh DTensor as the same local shards on the pod's submesh:
    what this rank holds of its own pod's part."""
    full = x.device_mesh.mesh_dim_names
    pl = [x.placements[full.index(n)] for n in pod_mesh.mesh_dim_names]
    return DTensor.from_local(x.to_local(), pod_mesh, pl, run_check=False)


def make_train_step_podcompressed(cfg: ArchConfig, mesh, codec=12):
    """THE PAPER'S TECHNIQUE ON THE WIRE: error-bounded ZFP compression of
    the cross-pod gradient exchange (dryrun.py:106; DESIGN.md §4.3).

    Parameters and optimizer state are DTensors on the pod-local submesh
    ``mesh["data", "model"]``, so they are replicated across pods by
    construction, and the gradients reduce only within a pod.  Each rank
    then compresses its OWN gradient shard through the tree codec (blocks
    align with the shard, no resharding), passes only the encoded fields
    (payload, emax, nplanes) around the "pod" ring ``n_pod - 1`` times,
    decodes every payload and averages in the reference's order (its own
    pod first, then the ring's), so parameters stay identical across pods.
    ``codec`` is a codec of the port or an int (fixed-rate bits): on the
    card kernels 4 and 1 at fixed rate (the tree codec decodes its stacked
    payloads with kernel 1; 2 and 1 at fixed accuracy), on the CPU their
    plain versions.  The step takes the batch on the full mesh
    (batch over ("pod", "data")) and returns the loss averaged over pods."""
    codec = as_codec(codec)
    opt_cfg = AdamConfig(lr=1e-4, grad_clip=1.0)
    pod_mesh = mesh["data", "model"]
    n_pod = mesh.size(mesh.mesh_dim_names.index("pod"))

    def train_step(params, opt_state, batch):
        lm.set_constraint_exclude(("pod",))
        try:
            loss, grads = loss_and_grads(params, cfg,
                                         {k: pod_local(x, pod_mesh) for k, x in batch.items()})
            mean = exchange(_tree_map(lambda g: g.to_local().float(), grads), mesh, codec,
                            n_pod)
            grads = _tree_map(lambda m, g: DTensor.from_local(
                m.to(g.dtype), g.device_mesh, g.placements, run_check=False,
                shape=g.shape, stride=g.stride()).float(), mean, grads)
            params, opt_state = apply_adam(grads, opt_state, params, opt_cfg)
            return params, opt_state, pod_mean(loss, mesh, n_pod)
        finally:
            lm.set_constraint_exclude(())

    return train_step


def exchange(local_grads, mesh, codec, n_pod: int):
    """The cross-pod combine of this rank's gradient shards (a tree of plain
    f32 tensors): encode, ``n_pod - 1`` ring passes of the encoded fields
    over "pod" (``funcol.permute_tensor``, pod i to pod i + 1), a decode of
    every payload, the mean.  Returns a tree like ``local_grads``."""
    import torch.distributed._functional_collectives as funcol
    leaves, treedef = tree_flatten(local_grads)
    shapes_only = any(t.device.type == "meta" for t in leaves)
    codec_call = _shapes_only if shapes_only else (lambda fn, *a: fn(*a))
    enc, meta = codec_call(lambda t: encode_tree(codec, t), local_grads)
    acc = codec_call(lambda e: decode_tree(e, meta, codec=codec), enc)
    group = mesh.get_group("pod")
    ring = [(i + 1) % n_pod for i in range(n_pod)]

    def send(t):
        # permute_tensor's splits count elements along dim 0: send it flat
        return _waited(funcol.permute_tensor(t.reshape(-1), ring, group)).reshape(t.shape)

    for _ in range(n_pod - 1):
        enc = [_fields_map(send, e) for e in enc]
        dec = codec_call(lambda e: decode_tree(e, meta, codec=codec), enc)
        acc = [a + d for a, d in zip(acc, dec)]
    return treedef.unflatten([a / n_pod for a in acc])


def _fields_map(fn, x):
    """``fn`` on a tensor, or on each tensor of an encoded field."""
    if isinstance(x, CompressedField):
        return dataclasses.replace(x, payload=fn(x.payload), emax=fn(x.emax),
                                   nplanes=fn(x.nplanes))
    return fn(x) if isinstance(x, torch.Tensor) else x


def _shapes_only(fn, tree):
    """``fn(tree)`` for a tree of meta tensors (the dry run): the codec runs
    on fake CPU tensors of the same shapes, which carry shapes and compute
    nothing, and its tensors come back as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def swap(device):
        def conv(x):
            if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
                return type(x)(conv(v) for v in x)
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            return _fields_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), x)
        return conv

    with FakeTensorMode():
        out = fn(swap("cpu")(tree))
    return swap("meta")(out)


def pod_mean(loss, mesh, n_pod: int):
    """The mean over pods of a loss replicated within each pod."""
    import torch.distributed._functional_collectives as funcol
    local = replicated(loss)
    local = local.to_local() if isinstance(local, DTensor) else local
    return _waited(funcol.all_reduce(local, "sum", mesh.get_group("pod"))) / n_pod


def _waited(t):
    """A functional collective's result, waited for where it is pending."""
    return t.wait() if hasattr(t, "wait") else t


def make_prefill_step(cfg: ArchConfig, max_seq: int):
    def prefill(params, batch):
        return lm.lm_prefill(params, cfg, batch, max_seq)
    return prefill


def make_serve_step(cfg: ArchConfig):
    def serve(params, cache, tokens, pos):
        return lm.serve_step(params, cfg, cache, tokens, pos)
    return serve


# ---------------------------------------------------------------------------
# analytic per-device HBM-traffic model (documented in EXPERIMENTS.md §Roofline)
# ---------------------------------------------------------------------------

def analytic_memory_traffic(cfg: ArchConfig, cell: ShapeCell,
                            n_chips: int, n_model: int = 16) -> float:
    """Napkin HBM bytes/device/step (dryrun.py:191, verbatim): TP-sharded
    weight reads per pass, optimizer state r/w, residual-stream + FFN
    activations, per-chunk KV rereads, cache reads for decode, and vocab
    logits."""
    n_dp = n_chips // n_model
    p_total = lm.param_count(cfg)
    p_active = lm.active_param_count(cfg)
    d, f, l = cfg.d_model, max(cfg.d_ff, 1), cfg.num_layers
    hkv, hd = max(cfg.num_kv_heads, 1), max(cfg.hdim, 1)
    s = cell.seq_len
    b_loc = max(cell.global_batch // n_dp, 1)
    v = cfg.vocab_size

    if cfg.num_experts:
        f_act = 3 * cfg.experts_per_token * cfg.d_ff + cfg.moe_dense_ff
    else:
        f_act = 2 * f
    act_layer_bytes = 6 * d + f_act                       # per token, bf16=2B
    nc = max(s // cfg.attn_chunk, 1)
    kv_reread = 0.0
    if cfg.family != "ssm":
        kv_reread = l * b_loc * nc * s * hkv * hd * 2 * 2  # k+v per q-chunk

    cache_bytes = 0.0
    if cell.kind != "train" and cfg.family != "ssm":
        cache_bytes = l * cell.global_batch * s * hkv * hd * 2 * 2 / n_chips
    if cfg.family == "ssm" or cfg.hybrid:
        cache_bytes += (l * cell.global_batch * cfg.ssm_heads * cfg.ssm_head_dim
                        * cfg.ssm_state * 4) / n_chips

    if cell.kind == "train":
        weights = 4 * p_total * 2 / n_model                # fwd/dgrad/wgrad/remat
        opt = p_total * 20 / n_chips                       # f32 m,v r/w + p
        acts = l * b_loc * s * act_layer_bytes * 2 * 3     # fwd+bwd+remat
        vocab = 2 * b_loc * s * (v / n_model) * 4          # logits chunks f32
        return weights + opt + acts + kv_reread + vocab
    if cell.kind == "prefill":
        weights = p_total * 2 / n_model
        acts = l * b_loc * s * act_layer_bytes * 2
        return weights + acts + kv_reread + cache_bytes    # cache write
    # decode: every weight (active) + the whole cache, once per token
    weights = p_active * 2 / n_model
    return weights + cache_bytes


# ---------------------------------------------------------------------------
# per-cell dry run
# ---------------------------------------------------------------------------

def local_bytes(*trees) -> int:
    """Bytes one device holds of the tensors of ``trees`` (DTensors count
    their local shard)."""
    total = 0
    for tree in trees:
        for t in tree_flatten(tree)[0]:
            if isinstance(t, torch.Tensor):
                loc = t.to_local() if isinstance(t, DTensor) else t
                total += loc.numel() * loc.element_size()
    return total


def traced(step, args, mesh):
    """``step(*args)`` under :class:`CommAnalysis` and ``MemTracker``.
    Returns (outputs, the analysis, the tracker's entry: ``{"peak_bytes":
    n}`` per device, or ``{"error": ...}`` where the tracker fails, the
    step then run again without it)."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        mt = MemTracker()
        analysis = CommAnalysis(mesh)
        with mt, analysis:
            out = step(*args)
        snap = mt.get_tracker_snapshot("peak")
        return out, analysis, {"peak_bytes": int(max(d["Total"] for d in snap.values()))}
    except Exception as e:                             # tracker gaps
        err = {"error": f"{type(e).__name__}: {e}"[:300]}
    analysis = CommAnalysis(mesh)
    with analysis:
        out = step(*args)
    return out, analysis, err


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool,
             save: bool = True, cfg_override=None, microbatches: int = 1,
             pod_grad_compress_bits: int = 0, mesh=None) -> Dict[str, Any]:
    """One cell: its step once on meta DTensors over the production mesh
    (or ``mesh``, any named mesh over the current process group), counted
    by :class:`CommAnalysis`.  Returns the JSON record (and writes it with
    ``save``)."""
    cfg = cfg_override or get_config(arch)
    ok, reason = cell_applicable(cfg, cell)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if mesh is not None:
        mesh_tag = "x".join(str(s) for s in mesh.shape)
    label = f"{arch} x {cell.name} x {mesh_tag}"
    if not ok:
        print(f"[dryrun] SKIP {label}: {reason}")
        return {"arch": arch, "cell": cell.name, "multi_pod": multi_pod,
                "skipped": reason}

    if mesh is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        init_fake_process_group(math.prod(shape))
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    compressed = bool(pod_grad_compress_bits and multi_pod and cell.kind == "train")
    state_mesh = mesh["data", "model"] if compressed else mesh
    params_m, opt_m = _abstract_state(cfg)
    pspecs = resolve_specs(param_specs(params_m), params_m, sizes)
    params = distribute_tree(params_m, state_mesh, pspecs)
    lm.set_constraint_mesh(mesh)
    t0 = time.time()
    try:
        ispec = input_specs(cfg, cell)
        if cell.kind == "train":
            opt = distribute_tree(opt_m, state_mesh, opt_specs(pspecs))
            bspecs = {k: v for k, v in batch_specs(cfg, "train", multi_pod).items()
                      if k in ispec}
            batch = distribute_tree(ispec, mesh, bspecs)
            step = (make_train_step_podcompressed(cfg, mesh, pod_grad_compress_bits)
                    if compressed else make_train_step(cfg, microbatches))
            args = (params, opt, batch)
            out, analysis, peak = traced(step, args, mesh)
        elif cell.kind == "prefill":
            bspecs = {k: v for k, v in batch_specs(cfg, "prefill", multi_pod).items()
                      if k in ispec}
            batch = distribute_tree(ispec, mesh, bspecs)
            step = make_prefill_step(cfg, cell.seq_len if not cfg.encoder_layers
                                     else cell.seq_len // 2)
            args = (params, batch)
            with torch.no_grad():
                out, analysis, peak = traced(step, args, mesh)
        else:                                          # decode
            cache = lm.init_cache(cfg, cell.global_batch, cell.seq_len, device="meta",
                                  enc_seq=cell.seq_len // 2 if cfg.encoder_layers else 0,
                                  mesh=mesh)
            # sharded over the batch axes only where the batch divides
            # (dryrun.py:318-322): resolve_specs drops them otherwise
            tokens = distribute_tree(
                {"tokens": ispec["tokens"]}, mesh,
                {"tokens": batch_specs(cfg, "decode", multi_pod)["tokens"]})["tokens"]
            step = make_serve_step(cfg)
            args = (params, cache, tokens, cell.seq_len - 1)
            with torch.no_grad():
                out, analysis, peak = traced(step, args, mesh)
    finally:
        lm.set_constraint_mesh(None)
    trace_s = time.time() - t0
    mem = {"argument_size_in_bytes": local_bytes(args),
           "output_size_in_bytes": local_bytes(out)}
    mem.update(peak)

    flops_dev = float(analysis.flops)
    coll_dev = float(analysis.collective_bytes)
    bytes_dev = float(analytic_memory_traffic(cfg, cell, n_chips, sizes["model"]))
    links = axis_links(mesh.shape, mesh.mesh_dim_names)
    coll_s_axis = {a: sum(v.values()) / link_bandwidth(links.get(a, "internode"))
                   for a, v in analysis.by_axis.items()}
    result = {
        "arch": arch, "cell": cell.name, "mesh": mesh_tag,
        "multi_pod": multi_pod, "n_chips": n_chips,
        "pod_grad_compress_bits": (pod_grad_compress_bits if cell.kind == "train" else 0),
        "trace_seconds": round(trace_s, 1),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_bytes_uncorrected": coll_dev,
        "collectives": {k: float(analysis.collectives[k]) for k in _COLLECTIVES},
        "collectives_by_axis": {a: dict(v) for a, v in analysis.by_axis.items()},
        "collective_bytes_by_dtype": dict(analysis.by_dtype),
        "dot_bytes_per_device": float(analysis.dot_bytes),
        "axis_links": links,
        "memory_analysis": mem,
        "terms": {
            "compute_s": flops_dev / PEAK_FLOPS_BF16,
            "memory_s": bytes_dev / HBM_BW,
            "collective_s": sum(coll_s_axis.values()),
        },
        "terms_are": "modelled from H100 SXM datasheet constants, not measured",
    }
    result["bottleneck"] = max(result["terms"], key=result["terms"].get)

    n_params = lm.param_count(cfg)
    n_active = lm.active_param_count(cfg)
    if cell.kind == "train":
        model_flops = 6 * n_active * cell.global_batch * cell.seq_len
    elif cell.kind == "prefill":
        model_flops = 2 * n_active * cell.global_batch * cell.seq_len
    else:
        model_flops = 2 * n_active * cell.global_batch
    traced_global = flops_dev * n_chips
    result.update(model_flops=model_flops, params=n_params, active_params=n_active,
                  useful_flops_ratio=model_flops / traced_global if traced_global else 0.0)

    print(f"[dryrun] OK {label}: trace={trace_s:.1f}s (CPU) "
          f"compute={result['terms']['compute_s']:.4f}s "
          f"memory={result['terms']['memory_s']:.4f}s "
          f"collective={result['terms']['collective_s']:.4f}s (modelled) "
          f"bottleneck={result['bottleneck']} "
          f"useful={result['useful_flops_ratio']:.2f}", flush=True)
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        gc_tag = f"_gc{pod_grad_compress_bits}" if result["pod_grad_compress_bits"] else ""
        tag = f"{arch}_{cell.name}_{result['mesh']}{gc_tag}.json"
        with open(os.path.join(RESULTS_DIR, tag), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="dry run of the production meshes, on "
                                             "the CPU (fake process group, meta tensors)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--cell", default="all",
                    help=f"one of {[c.name for c in SHAPE_CELLS]} or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="compress the cross-pod gradient exchange at this "
                         "fixed rate (train cells on the multi-pod mesh; "
                         "results save with a _gc<bits> suffix)")
    args = ap.parse_args(argv)

    archs = list(ALL_ARCHS) if args.arch == "all" else [args.arch]
    cells = [c for c in SHAPE_CELLS if args.cell in ("all", c.name)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    print("[dryrun] CPU, fake process group, meta tensors; terms modelled from "
          "H100 SXM datasheet constants", flush=True)
    failures = []
    try:
        for arch in archs:
            for cell in cells:
                for mp in meshes:
                    try:
                        run_cell(arch, cell, mp,
                                 pod_grad_compress_bits=args.grad_compress_bits)
                    except Exception as e:
                        failures.append((arch, cell.name, mp, str(e)[:200]))
                        print(f"[dryrun] FAIL {arch} x {cell.name} x mp={mp}: {e}",
                              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
