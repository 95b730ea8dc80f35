"""Per-device accounting of a traced step: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference parses the partitioned HLO of a compiled step and rescales
each ``while`` body by its trip count.  Here there is no HLO: the step runs
eagerly on DTensors (on the meta device in the dry run), every layer of the
Python loops runs, and :class:`CommAnalysis`, a dispatch mode, sees each
operator on the local shards after DTensor has lowered it.  So no loop
needs rescaling.  Per device it counts

  flops            -- 2 * M * N * K of every local matrix product
                      (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
  dot bytes        -- operand plus result bytes of those products
  collective bytes -- operand bytes of every collective, by kind (the five
                      of the reference: all-reduce, all-gather,
                      reduce-scatter, all-to-all, collective-permute) and
                      by mesh axis

Bytes are counted in the dtype actually sent (a bf16 all-reduce counts 2
bytes a value), so the reference's correction for XLA:CPU promoting bf16
reductions to f32 has no counterpart.  Two things are counted as what they
stand for, not as what runs underneath:

* DTensor's shard-to-shard redistribute on a CPU mesh runs as an
  all-gather and a local chunk; it is counted as one all-to-all of the
  local shard.
* ``funcol.permute_tensor`` runs as an ``all_to_all_single`` that sends the
  whole input to one rank; it is counted as a collective-permute.

Operators that DTensor runs to propagate shapes (on fake tensors, or on
meta tensors of the global shape) are not counted: they are not the
device's work.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_funcol = torch.ops._c10d_functional
_DOTS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
         _aten.baddbmm: (1, 2)}
# functional collective -> (kind, index of the group-name argument)
_COLL = {
    _funcol.all_reduce: ("all-reduce", 2),
    _funcol.all_reduce_coalesced: ("all-reduce", 2),
    _funcol.all_gather_into_tensor: ("all-gather", 2),
    _funcol.all_gather_into_tensor_coalesced: ("all-gather", 2),
    _funcol.reduce_scatter_tensor: ("reduce-scatter", 3),
    _funcol.reduce_scatter_tensor_coalesced: ("reduce-scatter", 3),
    _funcol.all_to_all_single: ("all-to-all", 3),
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CommAnalysis(TorchDispatchMode):
    """Counts what one device runs while the mode is on.  ``mesh``: the named
    DeviceMesh whose dims name the collectives' groups (a group the mesh
    does not name is counted under ``"other"``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.by_axis: Dict[str, Dict[str, float]] = {}
        self.by_dtype: Dict[str, float] = {}
        self._groups: Dict[str, str] = {}
        self.records = []           # (kind, axis, dtype, bytes), one per collective
        if mesh is not None:
            self.add_mesh(mesh)
        self._inside_alltoall = 0
        self._propagating = 0

    def add_mesh(self, mesh) -> None:
        for name in mesh.mesh_dim_names:
            self._groups[mesh.get_group(name).group_name] = name

    def record(self, kind: str, nbytes: float, axis: str, dtype: Optional[torch.dtype] = None):
        self.records.append((kind, axis, dtype, nbytes))
        self.collectives[kind] += nbytes
        ax = self.by_axis.setdefault(axis, {k: 0.0 for k in COLLECTIVES})
        ax[kind] += nbytes
        if dtype is not None:
            key = str(dtype).replace("torch.", "")
            self.by_dtype[key] = self.by_dtype.get(key, 0.0) + nbytes

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # let DTensor lower its op first; its local ops come back through here
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat, _ = tree_flatten((args, kwargs))
        if self._propagating or any(isinstance(t, FakeTensor) for t in flat):
            return out
        packet = getattr(func, "_overloadpacket", None)
        if packet in _DOTS:
            a, b = (args[i] for i in _DOTS[packet])
            k = a.shape[-1]
            self.flops += 2.0 * out.numel() * k
            self.dot_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        elif packet in _COLL and not self._inside_alltoall:
            kind, gi = _COLL[packet]
            src = args[0]
            if packet is _funcol.all_to_all_single and self._is_permute(args):
                kind = "collective-permute"
            self.record(kind, _nbytes(src), self._groups.get(args[gi], "other"),
                        src[0].dtype if isinstance(src, (list, tuple)) else src.dtype)
        return out

    @staticmethod
    def _is_permute(args) -> bool:
        splits = args[2]
        return splits is not None and sum(1 for s in splits if s) == 1

    @contextlib.contextmanager
    def _alltoall(self, t: torch.Tensor, mesh, mesh_dim: int):
        name = mesh.mesh_dim_names[mesh_dim] if mesh.mesh_dim_names else "other"
        self.record("all-to-all", _nbytes(t), name, t.dtype)
        self._inside_alltoall += 1
        try:
            yield
        finally:
            self._inside_alltoall -= 1

    def __enter__(self):
        from torch.distributed.tensor import placement_types
        self._orig = placement_types.shard_dim_alltoall
        analysis = self

        def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
            with analysis._alltoall(input, mesh, mesh_dim):
                return analysis._orig(input, gather_dim, shard_dim, mesh, mesh_dim)

        placement_types.shard_dim_alltoall = counted
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        self._orig_prop = ShardingPropagator._propagate_tensor_meta_non_cached

        def shapes_only(prop, *a, **k):
            analysis._propagating += 1
            try:
                return analysis._orig_prop(prop, *a, **k)
            finally:
                analysis._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = shapes_only
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        placement_types.shard_dim_alltoall = self._orig
        ShardingPropagator._propagate_tensor_meta_non_cached = self._orig_prop
        return super().__exit__(*exc)
