"""Mesh construction: the port of ``repro/launch/mesh.py``.

Functions, not module-level meshes, so importing this module starts no
process group; callers decide when a group and a mesh exist.

* :func:`make_production_mesh` -- (16, 16) ``("data", "model")`` = 256
  GPUs, or (2, 16, 16) ``("pod", "data", "model")`` = 512, over the ranks
  of the current process group.  The dry run builds it on the ``fake``
  process group (:func:`init_fake_process_group`): one CPU process plays
  every rank, and collectives move nothing.
* :func:`make_host_mesh` -- the (1, 1) ``("data", "model")`` mesh of one
  rank, on the card unless ``device="cpu"``.

The constants are the H100 SXM5 80 GB datasheet's (NVIDIA H100 Tensor
Core GPU datasheet; DGX H100 user guide for the node), roofline
denominators of the dry run's modelled terms.  None is a measurement.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# datasheet: H100 SXM5, dense bf16 tensor-core peak (1,979 TFLOP/s with sparsity)
PEAK_FLOPS_BF16 = 989.4e12
# datasheet: H100 SXM5 80 GB, HBM3
HBM_BW = 3.35e12
# datasheet: NVLink 4, 900 GB/s per GPU both directions together (18 links);
# one direction, the rate a ring step moves
NVLINK_BW = 450e9
# DGX H100: one ConnectX-7 400 Gb/s (NDR InfiniBand) port per GPU, one
# direction
INTERNODE_BW = 50e9
GPUS_PER_NODE = 8

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_process_group(world_size: int) -> None:
    """Start the ``fake`` process group of ``world_size`` ranks in this
    process (rank 0; every collective returns without moving data), the
    dry run's stand-in for a cluster.  An existing fake group of that size
    is kept; any other existing group is destroyed first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def init_single_rank_group(device: DeviceLike = None, store_dir: Optional[str] = None
                           ) -> None:
    """A one-rank process group for :func:`make_host_mesh`: NCCL on the card,
    gloo on the CPU, through a ``FileStore`` in ``store_dir`` (a fresh
    temporary directory by default; no network).  An existing group is
    kept."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    path = os.path.join(store_dir or tempfile.mkdtemp(prefix="repro_host_mesh_"), "store")
    dist.init_process_group(backend, store=dist.FileStore(path, 1), rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 = 256 GPUs per pod; 2 pods = 512 GPUs multi-pod.  Needs a
    process group of that many ranks (:func:`init_fake_process_group` for
    the dry run)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: DeviceLike = None, store_dir: Optional[str] = None):
    """The (1, 1) ``("data", "model")`` mesh of one rank (same axis names),
    on the card unless ``device="cpu"``; starts a one-rank group
    (:func:`init_single_rank_group`) where none exists."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    init_single_rank_group(dev, store_dir)
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


def axis_links(shape, axes) -> Dict[str, str]:
    """Which link each mesh axis's collectives cross, for ranks numbered
    with the last axis fastest and ``GPUS_PER_NODE`` ranks a node: an axis
    whose span (size times stride) fits in a node stays on NVLink,
    otherwise its ring crosses the inter-node link.  A 16-wide "model" axis
    spans two 8-GPU nodes, so it is inter-node bound, as are "data" and
    "pod" of the production meshes."""
    out, stride = {}, 1
    for size, name in reversed(list(zip(shape, axes))):
        out[name] = "nvlink" if size * stride <= GPUS_PER_NODE else "internode"
        stride *= size
    return out


def link_bandwidth(link: str) -> float:
    return {"nvlink": NVLINK_BW, "internode": INTERNODE_BW}[link]

