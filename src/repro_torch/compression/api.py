"""Codec seam: one interface over the compression paths the port has.

Counterpart of ``repro/compression/api.py``, with the port's own registry:

  get_codec("fixed_accuracy", tolerance=1e-3)
  get_codec("fixed_rate", bits_per_value=12)
  get_codec("fixed_accuracy+residual", tolerance=1e-3)

There is no backend switch.  The device of the tensors decides: a tensor on
the card goes through the CUDA kernels, a tensor on the CPU through their
plain versions (:mod:`repro_torch.kernels.ops`).  Manifests still record a
backend, because the JAX package's do: :func:`codec_spec` writes
``"backend": "pallas"`` (the JAX package's name for its kernel path and its
codecs' default), so a manifest the port writes opens in
``repro.compression.codec_from_spec`` unchanged.  :func:`codec_from_spec`
and :meth:`TreeCodecMeta.make_codec` accept either of the JAX package's
``BACKENDS`` as the recorded backend and ignore it; any other value raises.

Array and scalar leaves, and fields read back from arrays, are placed on
the card unless the caller passes ``device="cpu"``, as the JAX package
puts them on its default device; without a card that raises
(:func:`repro_torch.device.resolve_device`).  Tensors stay on their own
device.

The tree codec (:func:`encode_tree`, :func:`decode_tree`,
:func:`tree_nbytes`) carries the seam up to whole trees of tensors --
nested mappings, lists/tuples and ``NamedTuple`` s -- flattened in the JAX
package's leaf order and named with its key strings (:func:`tree_leaf_keys`),
so per-leaf tolerances, checkpoint keys and encoded bits agree across the
two packages.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Mapping, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.compression import transform as T
from repro_torch.compression.zfp import (CompressedField,
                                         compressed_nbytes_batch, crop,
                                         encode_fixed_accuracy_batch,
                                         encode_fixed_rate_batch,
                                         fa_precompute_batch, fa_stats_batch,
                                         trim_to_nplanes)
from repro_torch.device import resolve_device

# the JAX package's backend names; recorded in specs, selecting nothing here
BACKENDS = ("jnp", "pallas")
SPEC_BACKEND = "pallas"


@runtime_checkable
class Codec(Protocol):
    """What the data, datagen, core and train layers require of a codec
    (the JAX package's ``Codec``, api.py:46, without its ``backend``: here
    the tensors' device selects the path).  ``field_to_arrays`` /
    ``field_from_arrays`` turn a compressed field into named host arrays
    and back, so checkpoints and stores need not know its class."""

    @property
    def name(self) -> str: ...

    def encode_batch(self, xs, tolerances=None): ...

    def decode_batch(self, cf) -> torch.Tensor: ...

    def nbytes(self, cf) -> torch.Tensor: ...

    def field_to_arrays(self, cf) -> Dict[str, np.ndarray]: ...

    def field_from_arrays(self, arrays: Mapping[str, Any], shape2d, device=None): ...


def decode_stacked_payloads(payload, emax, padded_shape, shape,
                            nplanes=None) -> torch.Tensor:
    """One-kernel decode of a stacked batch of packed ZFP streams.

    payload (B, nb, wmax) int32, emax (B, nb) int32 -> (B, *shape) float32.
    Samples narrower than wmax are zero-padded (zero words decode as zero
    planes), so the result is exact per sample.  Without ``nplanes`` the
    batch goes through the fixed-rate decode at ``2 * wmax`` planes, as the
    host-streaming stores decode; with ``nplanes`` (B, nb) the
    fixed-accuracy decode masks each block's dropped planes.
    """
    from repro_torch.kernels import ops
    b, nb, wmax = payload.shape
    flat_p = payload.reshape(b * nb, wmax).contiguous()
    flat_e = emax.reshape(b * nb).contiguous()
    if nplanes is None:
        blocks = ops.zfp_decode_blocks(flat_p, flat_e, 2 * wmax)
    else:
        blocks = ops.zfp_decode_blocks_fa(flat_p, flat_e,
                                          nplanes.reshape(b * nb).contiguous())
    return crop(T.deblockify(blocks, (b,) + tuple(padded_shape)), shape)


def _pad4(shape2d) -> Tuple[int, ...]:
    r, c = shape2d
    return (r + (-r) % 4, c + (-c) % 4)


def _cf_to_arrays(cf: CompressedField) -> Dict[str, np.ndarray]:
    """Batched CompressedField -> named host arrays, the payload trimmed to
    the width its kept planes need (``trim_to_nplanes``: dropped words are
    zero by construction, and the decode accepts any narrower width)."""
    cf = trim_to_nplanes(cf)
    return {"payload": cf.payload.cpu().numpy(),
            "emax": cf.emax.cpu().numpy(),
            "nplanes": cf.nplanes.cpu().numpy()}


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def _cf_from_arrays(arrays: Mapping[str, Any], shape2d,
                    device=None) -> CompressedField:
    """Inverse of :func:`_cf_to_arrays`, with the tensors on ``device``
    (the card by default)."""
    shape2d = tuple(int(s) for s in shape2d)
    dev = resolve_device(device)
    return CompressedField(_tensor(arrays["payload"], dev),
                           _tensor(arrays["emax"], dev),
                           _tensor(arrays["nplanes"], dev),
                           shape2d, _pad4(shape2d))


@dataclasses.dataclass(frozen=True)
class FixedAccuracyCodec:
    """Error-bounded mode: per-sample L-inf tolerances, per-block plane counts.

    ``tolerance`` is the default when ``encode_batch`` gets no per-sample
    tolerances.
    """
    tolerance: Optional[float] = None

    @property
    def name(self) -> str:
        return "fixed_accuracy"

    def encode_batch(self, xs: torch.Tensor, tolerances=None) -> CompressedField:
        if tolerances is None:
            if self.tolerance is None:
                raise ValueError("fixed_accuracy encode needs per-sample "
                                 "tolerances or a codec-level default")
            tolerances = torch.full((xs.shape[0],), self.tolerance,
                                    dtype=torch.float32)
        return encode_fixed_accuracy_batch(xs, torch.as_tensor(
            tolerances, dtype=torch.float32, device=xs.device))

    def decode_batch(self, cf: CompressedField) -> torch.Tensor:
        return decode_stacked_payloads(cf.payload, cf.emax, cf.padded_shape,
                                       cf.shape, cf.nplanes)

    def nbytes(self, cf: CompressedField) -> torch.Tensor:
        return compressed_nbytes_batch(cf, mode="fixed_accuracy")

    # stats-only roundtrip for Algorithm 1's search: the tolerance-
    # independent encode state once, then (L1, nbytes) per candidate
    # tolerance with no packing (plain PyTorch on either device)
    precompute = staticmethod(fa_precompute_batch)
    stats = staticmethod(fa_stats_batch)

    field_to_arrays = staticmethod(_cf_to_arrays)
    field_from_arrays = staticmethod(_cf_from_arrays)


@dataclasses.dataclass(frozen=True)
class FixedRateCodec:
    """Uniform bits-per-value mode (dense payload, 1-byte block headers)."""
    bits_per_value: int = 12

    @property
    def name(self) -> str:
        return "fixed_rate"

    def encode_batch(self, xs: torch.Tensor, tolerances=None) -> CompressedField:
        del tolerances                   # rate is fixed; no error bound
        return encode_fixed_rate_batch(xs, self.bits_per_value)

    def decode_batch(self, cf: CompressedField) -> torch.Tensor:
        return decode_stacked_payloads(cf.payload, cf.emax, cf.padded_shape,
                                       cf.shape, cf.nplanes)

    def nbytes(self, cf: CompressedField) -> torch.Tensor:
        return compressed_nbytes_batch(cf, mode="fixed_rate")

    field_to_arrays = staticmethod(_cf_to_arrays)
    field_from_arrays = staticmethod(_cf_from_arrays)


# ---------------------------------------------------------------------------
# NeurLZ-style learned residual correction
# ---------------------------------------------------------------------------
# The einsums and the 6x6 ridge solve are plain tensor ops, as they are
# plain jnp outside any Pallas kernel in the JAX package; only the base
# stream's encode and decode go through the codec kernels.

_CORR_K = 6          # corrector features: bias, center, 4-neighborhood


@dataclasses.dataclass
class ResidualCorrectedField:
    """A fixed-accuracy stream plus a tiny per-sample learned corrector.

    ``weights`` ((N, K) float32) are ridge-regression coefficients mapping
    local features of the *decoded* field to the encode-time residual;
    ``tols`` ((N,) float32) is each sample's L-inf tolerance, which also
    clips the correction, so the bound degrades at most to 2*tol while the
    realized L1 error only shrinks (samples the correction does not help
    carry zero weights).
    """
    base: CompressedField
    weights: torch.Tensor
    tols: torch.Tensor


def _corrector_features(dec: torch.Tensor) -> torch.Tensor:
    """(N, ..., H, W) decoded batch -> (N, P, K) per-pixel feature rows."""
    feats = [torch.ones_like(dec), dec,
             torch.roll(dec, 1, dims=-2), torch.roll(dec, -1, dims=-2),
             torch.roll(dec, 1, dims=-1), torch.roll(dec, -1, dims=-1)]
    return torch.stack(feats, dim=-1).reshape(dec.shape[0], -1, _CORR_K)


def _fit_corrector(dec: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """Per-sample ridge solve of features(dec) @ w ~= residual: (N, K)."""
    a = _corrector_features(dec)                          # (N, P, K)
    r = residual.reshape(residual.shape[0], -1)           # (N, P)
    ata = torch.einsum("npk,npl->nkl", a, a)
    atr = torch.einsum("npk,np->nk", a, r)
    lam = 1e-6 * a.shape[1]
    eye = torch.eye(_CORR_K, dtype=ata.dtype, device=ata.device)
    return torch.linalg.solve(ata + lam * eye[None], atr)


def _apply_corrector(dec: torch.Tensor, weights: torch.Tensor,
                     tols: torch.Tensor) -> torch.Tensor:
    a = _corrector_features(dec)                          # (N, P, K)
    corr = torch.einsum("npk,nk->np", a, weights).reshape(dec.shape)
    clip = tols.reshape((-1,) + (1,) * (dec.dim() - 1))
    return dec + torch.minimum(torch.maximum(corr, -clip), clip)


@dataclasses.dataclass(frozen=True)
class ResidualCorrectedCodec:
    """Fixed-accuracy codec + NeurLZ-style learned residual correction.

    Encode compresses with the error-bounded codec, fits a K=6 linear
    corrector on the decoded field's local neighborhood per sample, and
    keeps the weights only where they reduce the realized L1 error, so the
    corrected stream is never less accurate than the plain one.  The
    correction is clipped to +/-tol, bounding the L-inf error by 2*tol.
    The weights cost (K+1) floats per sample, counted in ``nbytes``.
    """
    tolerance: Optional[float] = None

    @property
    def name(self) -> str:
        return "fixed_accuracy+residual"

    @property
    def _inner(self) -> FixedAccuracyCodec:
        return FixedAccuracyCodec(self.tolerance)

    def encode_batch(self, xs: torch.Tensor,
                     tolerances=None) -> ResidualCorrectedField:
        if tolerances is None:
            if self.tolerance is None:
                raise ValueError("fixed_accuracy+residual encode needs "
                                 "per-sample tolerances or a codec default")
            tolerances = torch.full((xs.shape[0],), self.tolerance,
                                    dtype=torch.float32)
        xs = xs.to(torch.float32)
        tols = torch.as_tensor(tolerances, dtype=torch.float32,
                               device=xs.device)
        cf = self._inner.encode_batch(xs, tols)
        dec = self._inner.decode_batch(cf)
        w = _fit_corrector(dec, xs - dec)
        dims = tuple(range(1, xs.dim()))
        l1_plain = (dec - xs).abs().mean(dim=dims)
        l1_corr = (_apply_corrector(dec, w, tols) - xs).abs().mean(dim=dims)
        w = torch.where((l1_corr < l1_plain)[:, None], w, torch.zeros_like(w))
        return ResidualCorrectedField(cf, w, tols)

    def decode_batch(self, rcf: ResidualCorrectedField) -> torch.Tensor:
        dec = self._inner.decode_batch(rcf.base)
        return _apply_corrector(dec, rcf.weights, rcf.tols)

    def nbytes(self, rcf: ResidualCorrectedField) -> torch.Tensor:
        return (compressed_nbytes_batch(rcf.base, mode="fixed_accuracy")
                + 4 * (rcf.weights.shape[-1] + 1))

    def field_to_arrays(self, rcf: ResidualCorrectedField) -> Dict[str, np.ndarray]:
        out = _cf_to_arrays(rcf.base)
        out["weights"] = rcf.weights.cpu().numpy()
        out["tols"] = rcf.tols.cpu().numpy()
        return out

    def field_from_arrays(self, arrays: Mapping[str, Any], shape2d,
                          device=None) -> ResidualCorrectedField:
        base = _cf_from_arrays(arrays, shape2d, device)
        dev = base.payload.device
        return ResidualCorrectedField(base, _tensor(arrays["weights"], dev),
                                      _tensor(arrays["tols"], dev))


# ---------------------------------------------------------------------------
# registry and specs
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable] = {}


def register_codec(name: str, factory) -> None:
    """Register a codec factory under ``name`` (``get_codec`` instantiates
    it with the caller's keyword parameters)."""
    if not callable(factory):
        raise TypeError(f"codec factory for {name!r} must be callable")
    _REGISTRY[name] = factory


def codec_names() -> list:
    return sorted(_REGISTRY)


def get_codec(name: str, *, backend: str = SPEC_BACKEND, **params):
    """Instantiate a codec of the port: ``get_codec("fixed_accuracy",
    tolerance=1e-3)`` or ``get_codec("fixed_rate", bits_per_value=12)``.
    ``backend`` must be one of the JAX package's and selects nothing: the
    tensors' device picks the route."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown codec {name!r}; registered: {codec_names()}")
    _check_backend(backend)
    return _REGISTRY[name](**params)


register_codec("fixed_accuracy", FixedAccuracyCodec)
register_codec("fixed_rate", FixedRateCodec)
register_codec("fixed_accuracy+residual", ResidualCorrectedCodec)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")


def codec_spec(codec) -> dict:
    """JSON-able ``{name, backend, params}`` reconstructing ``codec`` via
    :func:`codec_from_spec` -- the form manifests record.  The backend is
    always ``"pallas"`` (see the module docstring)."""
    return {"name": codec.name, "backend": SPEC_BACKEND,
            "params": dataclasses.asdict(codec)}


def codec_from_spec(spec: Mapping[str, Any]):
    """Inverse of :func:`codec_spec`.  The recorded backend must be one of
    the JAX package's and is ignored: the tensors' device picks the
    route."""
    _check_backend(spec["backend"])
    return get_codec(spec["name"], **spec["params"])


def codec_from_plan(codec_plan):
    """Codec for a datagen ``CodecPlan``-shaped object (duck-typed: ``mode``
    plus the mode's parameters).  The plan's ``use_pallas`` selects nothing
    here: the device of the tensors decides, as for every codec of the
    port."""
    if codec_plan.mode == "fixed_accuracy":
        return get_codec("fixed_accuracy", tolerance=codec_plan.tolerance)
    if codec_plan.mode == "fixed_rate":
        return get_codec("fixed_rate", bits_per_value=codec_plan.bits_per_value)
    raise ValueError(f"unknown codec mode {codec_plan.mode!r}")


# ---------------------------------------------------------------------------
# trees: flatten in the JAX package's order, with its key strings
# ---------------------------------------------------------------------------
# A tree is nested mappings (keys sorted, as jax.tree_util sorts dict
# keys), lists/tuples (by index) and NamedTuples (by field, keyed
# "." + name), with tensors (or arrays, scalars) as leaves; None holds no
# leaf.  A leaf's key is "/".join of its path's parts: JAX's AdamState
# flattens to ".step", ".m/ln_in/b", ...

@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree (:func:`tree_flatten`);
    ``node_type`` is None for a leaf."""
    node_type: Any = None
    keys: Tuple = ()
    children: Tuple["TreeDef", ...] = ()

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree holds")
        return out

    def _build(self, it):
        if self.node_type is None:
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("fewer leaves than the tree holds")
            return leaf
        kids = [c._build(it) for c in self.children]
        t = self.node_type
        if t is type(None):
            return None
        if issubclass(t, Mapping):
            return (dict if t is dict else t)(zip(self.keys, kids))
        if issubclass(t, tuple) and hasattr(t, "_fields"):
            return t(*kids)
        return t(kids)


_END = object()


def _node(tree):
    """(node type, original keys, key strings, children) of a container,
    or None for a leaf."""
    if tree is None:
        return type(None), (), (), ()
    if isinstance(tree, Mapping):
        keys = tuple(sorted(tree))
        return type(tree), keys, tuple(str(k) for k in keys), \
            tuple(tree[k] for k in keys)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree), tree._fields, \
            tuple("." + f for f in tree._fields), tuple(tree)
    if isinstance(tree, (list, tuple)):
        idx = tuple(range(len(tree)))
        return type(tree), idx, tuple(map(str, idx)), tuple(tree)
    return None


def tree_flatten_with_path(tree) -> Tuple[list, TreeDef]:
    """``([(key, leaf), ...], treedef)`` in the JAX package's leaf order."""
    out: list = []

    def walk(node, path) -> TreeDef:
        n = _node(node)
        if n is None:
            out.append(("/".join(path), node))
            return TreeDef()
        typ, keys, names, kids = n
        return TreeDef(typ, keys, tuple(walk(k, path + (s,))
                                        for s, k in zip(names, kids)))

    return out, walk(tree, ())


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    pairs, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def tree_leaf_keys(tree) -> list:
    """Stable '/'-joined path key per leaf, in flatten order (the naming
    the checkpoint manifest uses, equal to the JAX package's)."""
    return [k for k, _ in tree_flatten_with_path(tree)[0]]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of trees of the same
    structure in ``rest``), rebuilt with ``tree``'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])


# JAX dtype names of torch dtypes (LeafSpec.dtype holds JAX's names)
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.bfloat16: "bfloat16",
               torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
               torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
               torch.complex64: "complex64", torch.complex128: "complex128"}
DTYPES = {v: k for k, v in DTYPE_NAMES.items()}


def as_tensor(leaf, device=None) -> torch.Tensor:
    """A leaf as a tensor: tensors as they are, arrays and scalars on
    ``device`` (the card by default)."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.as_tensor(np.asarray(leaf), device=resolve_device(device))


# ---------------------------------------------------------------------------
# tree codec: the seam grown upward to whole trees
# ---------------------------------------------------------------------------

def leaf_2d_shape(shape) -> Tuple[int, int]:
    """Canonical 2D block view of a leaf shape: the trailing dim is the
    fast axis; 1D leaves fold into 64 rows when divisible (they pad 4x
    otherwise); scalars become (1, 1)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) >= 2:
        rows = 1
        for s in shape[:-1]:
            rows *= s
        return (rows, shape[-1])
    if len(shape) == 1 and shape[0] % 64 == 0:
        return (64, shape[0] // 64)
    return (1, shape[0] if shape else 1)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static per-leaf record: path key, original shape and JAX dtype
    name, whether the leaf went through the codec (False = carried raw)."""
    key: str
    shape: Tuple[int, ...]
    dtype: str
    compressed: bool

    @property
    def shape2d(self) -> Tuple[int, int]:
        return leaf_2d_shape(self.shape)

    @property
    def nbytes(self) -> int:
        size = 1
        for s in self.shape:
            size *= s
        return size * DTYPES[self.dtype].itemsize


@dataclasses.dataclass(frozen=True)
class TreeCodecMeta:
    """Hashable, JSON-serializable sidecar for one encoded tree.

    ``codec`` is the flattened ``codec_spec`` (name, backend, sorted param
    pairs); ``leaves`` one LeafSpec per flattened leaf.  ``to_json`` gives
    the JAX package's manifest entry for the same tree and codec.
    """
    codec: Tuple
    leaves: Tuple[LeafSpec, ...]

    def make_codec(self):
        name, backend, params = self.codec
        _check_backend(backend)
        return get_codec(name, **dict(params))

    def to_json(self) -> dict:
        name, backend, params = self.codec
        return {"codec": {"name": name, "backend": backend,
                          "params": dict(params)},
                "leaves": [{"key": l.key, "shape": list(l.shape),
                            "dtype": l.dtype, "compressed": l.compressed}
                           for l in self.leaves]}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "TreeCodecMeta":
        c = obj["codec"]
        return cls((c["name"], c["backend"],
                    tuple(sorted(c["params"].items()))),
                   tuple(LeafSpec(l["key"], tuple(int(s) for s in l["shape"]),
                                  l["dtype"], bool(l["compressed"]))
                         for l in obj["leaves"]))


def _codec_key(codec) -> Tuple:
    spec = codec_spec(codec)
    return (spec["name"], spec["backend"],
            tuple(sorted(spec["params"].items())))


def encode_tree(codec, tree, *, min_size: int = 0, tolerances=None,
                device=None):
    """Compress every eligible float leaf of ``tree`` through ``codec``,
    on the leaf's own device.  Array and scalar leaves go to ``device``
    first (the card by default).

    tolerances : None (codec default), a scalar applied to every leaf, or a
        ``{leaf_key: tol}`` mapping (keys as in :func:`tree_leaf_keys`; a
        fixed-accuracy leaf with no entry and no codec default is carried
        raw -- the checkpoint path uses this for certified per-leaf
        tolerances).  Ignored by fixed-rate codecs.
    min_size : leaves smaller than this (or non-float) are carried raw.

    Returns ``(encoded, meta)``: ``encoded`` is a list in flatten order
    whose entries are batched (N=1) compressed fields for compressed leaves
    and the original leaves otherwise; ``meta`` is the
    :class:`TreeCodecMeta` needed to invert.
    """
    pairs, _ = tree_flatten_with_path(tree)
    needs_tol = (getattr(codec, "tolerance", 0) is None
                 and codec.name.startswith("fixed_accuracy"))
    encoded, specs = [], []
    for key, leaf in pairs:
        x = as_tensor(leaf, device)
        tol = tolerances.get(key) if isinstance(tolerances, Mapping) \
            else tolerances
        eligible = (x.is_floating_point() and x.numel() >= max(min_size, 1)
                    and not (needs_tol and tol is None))
        spec = LeafSpec(key, tuple(int(s) for s in x.shape),
                        DTYPE_NAMES[x.dtype], bool(eligible))
        specs.append(spec)
        if not eligible:
            encoded.append(leaf)
            continue
        x2 = x.to(torch.float32).reshape(spec.shape2d)
        tols = None if tol is None else torch.tensor(
            [float(tol)], dtype=torch.float32, device=x.device)
        encoded.append(codec.encode_batch(x2[None], tols))
    return encoded, TreeCodecMeta(_codec_key(codec), tuple(specs))


def decode_tree(encoded, meta: TreeCodecMeta, codec=None,
                treedef: Optional[TreeDef] = None):
    """Invert :func:`encode_tree`: decode every compressed entry back to its
    original shape and dtype, on its tensors' device (raw entries pass
    through).  Returns a list in leaf order, or the tree when ``treedef``
    (from :func:`tree_flatten`) is given.  ``codec`` defaults to the one
    recorded in ``meta``."""
    if codec is None:
        codec = meta.make_codec()
    out = []
    for enc, spec in zip(encoded, meta.leaves):
        if not spec.compressed:
            out.append(enc)
            continue
        x = codec.decode_batch(enc)[0].reshape(spec.shape)
        out.append(x.to(DTYPES[spec.dtype]))
    if treedef is not None:
        return treedef.unflatten(out)
    return out


def tree_nbytes(codec, encoded, meta: TreeCodecMeta) -> Tuple[int, int]:
    """(raw_bytes, stored_bytes) for one encoded tree: logical codec bytes
    for compressed leaves, array bytes for raw ones.  Host-side
    accounting (it reads the plane counts back)."""
    raw = stored = 0
    for enc, spec in zip(encoded, meta.leaves):
        raw += spec.nbytes
        if spec.compressed:
            stored += int(codec.nbytes(enc).sum())
        else:
            stored += spec.nbytes
    return raw, stored
