"""Fault-tolerant checkpoints: atomic manifests, auto-resume, lossy mode.

Counterpart of ``repro/train/checkpoint.py``, in the same on-disk format,
so a checkpoint written by either package restores in the other.

Layout per step:  <dir>/step_<n>/arrays.npz + manifest.json, committed by an
atomic rename of the temp directory; a top-level LATEST file is rewritten
last.  Restart reads LATEST (falling back to the newest complete manifest),
so a crash mid-write is never resumed from.

The module is generic over "a dict of trees" (``{"params": ..., "opt":
...}``), keyed leaf by leaf as :func:`repro_torch.compression.tree_leaf_keys`
names them.  Layouts belong to the caller: the train loop hands it the
surrogate's state in the JAX package's layout
(:func:`repro_torch.models.surrogate.params_to_jax`).

Lossy mode routes large float leaves through a codec via the tree codec:
the manifest records the codec spec and per-tree ``TreeCodecMeta``;
compressed leaves are stored as ``<tree>/<key>.zfp/{payload,emax,nplanes}``
(plus ``weights`` and ``tols`` for the residual codec).  Encodes run on the
leaves' own device -- the codec kernels on the card -- and only their
results go to the host for the ``.npz``.  ``lossy_bits`` is shorthand for
the fixed-rate codec.  :func:`certify_param_tolerances` runs Algorithm 1 on
the parameters with the optimizer's own per-step displacement as the bound,
giving per-leaf tolerances for a fixed-accuracy codec.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.compression import (TreeCodecMeta, as_tensor, codec_from_spec,
                                     codec_spec, decode_tree, encode_tree,
                                     get_codec, tree_flatten_with_path,
                                     tree_nbytes)
from repro_torch.device import resolve_device

# leaves smaller than this stay raw: header overhead beats the ratio there
MIN_LOSSY_SIZE = 4096


def _flatten(tree) -> Dict[str, Any]:
    return dict(tree_flatten_with_path(tree)[0])


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host array.  bf16 has no numpy dtype: its bits are
    written as 2-byte void records, the ``|V2`` the JAX package's
    ``np.savez`` writes for an ml_dtypes bfloat16 array."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`_to_numpy`: ``|V2`` records are bf16 bits."""
    if a.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))




def _resolve_codec(codec, lossy_bits):
    if codec is not None and lossy_bits is not None:
        raise ValueError("pass codec= or lossy_bits=, not both")
    if lossy_bits is not None:
        return get_codec("fixed_rate", bits_per_value=int(lossy_bits))
    return codec


def certify_param_tolerances(params_prev, params, *, multiple: float = 1.0,
                             min_size: int = MIN_LOSSY_SIZE,
                             d: int = 2, device=None) -> Dict[str, float]:
    """Per-leaf certified checkpoint tolerances via Algorithm 1 on parameters.

    A restored parameter may deviate by up to the optimizer's own per-step
    displacement without leaving the trajectory's noise floor.  For each
    large float leaf, ``e = multiple * mean|params - params_prev|`` (in
    float64, on the leaf's device), and Algorithm 1
    (:func:`repro_torch.core.tolerance.find_tolerance`, on the same device)
    finds the largest L-inf tolerance whose realized L1 error stays under
    ``e``.

    Returns ``{leaf_key: tolerance}``, ready for ``save_checkpoint(...,
    tolerances={"params": ...})``.  Leaves smaller than ``min_size``, and
    leaves that did not move, are skipped (they are stored raw).  Array
    leaves go to ``device`` (the card by default).
    """
    from repro_torch.core.tolerance import find_tolerance

    flat_prev = _flatten(params_prev)
    tols: Dict[str, float] = {}
    for key, leaf in _flatten(params).items():
        x = as_tensor(leaf, device)
        if not (x.is_floating_point() and x.numel() >= min_size):
            continue
        prev = as_tensor(flat_prev[key], x.device).to(x.device)
        e = float(multiple) * float((x.double() - prev.double()).abs().mean())
        if e <= 0.0:
            continue
        res = find_tolerance(x, e, d=d, device=x.device)
        if np.isfinite(res.compression_l1):
            tols[key] = res.tolerance
    return tols


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any],
                    extra: Optional[dict] = None,
                    lossy_bits: Optional[int] = None,
                    codec=None,
                    tolerances: Union[None, float, Mapping[str, Any]] = None,
                    keep: int = 3, device=None) -> str:
    """state: dict of trees (e.g. {"params": ..., "opt": ...}).

    codec: any registered codec; large float leaves route through it via
    ``encode_tree`` and the manifest records the spec and per-tree meta.
    lossy_bits: shorthand for the fixed-rate codec (mutually exclusive).
    tolerances: forwarded per state entry to ``encode_tree`` -- a scalar for
    every leaf, or ``{name: scalar-or-{leaf_key: tol}}`` (e.g. the output of
    :func:`certify_param_tolerances` under ``"params"``), and recorded in
    the manifest.
    device: where array leaves are encoded (the card by default); tensors
    encode on their own device.
    """
    codec = _resolve_codec(codec, lossy_bits)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {"step": step, "time": time.time(),
                            "lossy_bits": lossy_bits, "extra": extra or {}}
    raw_bytes = stored_bytes = 0
    if codec is None:
        for name, tree in state.items():
            for key, leaf in _flatten(tree).items():
                arr = _to_numpy(leaf)
                arrays[f"{name}/{key}"] = arr
                raw_bytes += arr.nbytes
        stored_bytes = raw_bytes
    else:
        meta["codec"] = {"spec": codec_spec(codec), "trees": {}}
        if tolerances is not None and not isinstance(tolerances, Mapping):
            meta["codec"]["tolerance"] = float(tolerances)
        for name, tree in state.items():
            tols = (tolerances.get(name)
                    if isinstance(tolerances, Mapping) else tolerances)
            enc, tmeta = encode_tree(codec, tree, min_size=MIN_LOSSY_SIZE,
                                     tolerances=tols, device=device)
            meta["codec"]["trees"][name] = tmeta.to_json()
            if isinstance(tols, Mapping):
                meta["codec"].setdefault("tolerances", {})[name] = {
                    k: float(v) for k, v in tols.items()}
            for e, spec in zip(enc, tmeta.leaves):
                full = f"{name}/{spec.key}"
                if spec.compressed:
                    for aname, a in codec.field_to_arrays(e).items():
                        arrays[f"{full}.zfp/{aname}"] = a
                else:
                    arrays[full] = _to_numpy(e)
            r, s = tree_nbytes(codec, enc, tmeta)
            raw_bytes += r
            stored_bytes += s
    meta["raw_bytes"] = raw_bytes
    meta["stored_bytes"] = stored_bytes
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):                    # re-save after restart
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic commit
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _is_checkpoint_dir(ckpt_dir: str, d: str) -> bool:
    # a leftover step_*.tmp from a crashed save is not a checkpoint: it must
    # neither count toward `keep` nor be offered for resume
    return (d.startswith("step_") and not d.endswith(".tmp")
            and os.path.isdir(os.path.join(ckpt_dir, d)))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if _is_checkpoint_dir(ckpt_dir, d))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    latest = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            cand = os.path.join(ckpt_dir, f.read().strip())
        if os.path.exists(os.path.join(cand, "manifest.json")):
            return cand
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if _is_checkpoint_dir(ckpt_dir, d))
    for d in reversed(steps):                    # newest complete manifest
        cand = os.path.join(ckpt_dir, d)
        if os.path.exists(os.path.join(cand, "manifest.json")):
            return cand
    return None


def restore_checkpoint(path: str, template: Dict[str, Any],
                       device=None) -> Tuple[Dict[str, Any], dict]:
    """Restore into the structure of ``template`` (a dict of trees of the
    saved structure).  Every leaf lands on the device of the template's
    leaf (``device`` for array leaves, the card by default), and
    compressed leaves decode there through the codec recorded in the
    manifest."""
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    codec_meta = meta.get("codec")
    codec = None
    tree_metas: Dict[str, TreeCodecMeta] = {}
    if codec_meta is not None:
        codec = codec_from_spec(codec_meta["spec"])
        tree_metas = {name: TreeCodecMeta.from_json(tm)
                      for name, tm in codec_meta["trees"].items()}

    def load(key, dev):
        return _from_numpy(data[key]).to(dev)

    out = {}
    for name, tree in template.items():
        pairs, treedef = tree_flatten_with_path(tree)
        devices = {k: leaf.device if isinstance(leaf, torch.Tensor)
                   else resolve_device(device) for k, leaf in pairs}
        if name in tree_metas:
            tmeta = tree_metas[name]
            enc = []
            for spec in tmeta.leaves:
                full = f"{name}/{spec.key}"
                if spec.compressed:
                    prefix = full + ".zfp/"
                    enc.append(codec.field_from_arrays(
                        {k[len(prefix):]: data[k] for k in data.files
                         if k.startswith(prefix)}, spec.shape2d,
                        device=devices[spec.key]))
                else:
                    enc.append(load(full, devices[spec.key]))
            restored = {spec.key: x for spec, x in
                        zip(tmeta.leaves, decode_tree(enc, tmeta, codec=codec))}
        else:
            restored = {k: load(f"{name}/{k}", dev) for k, dev in devices.items()}
        out[name] = treedef.unflatten([restored[k] for k, _ in pairs])
    return out, meta
