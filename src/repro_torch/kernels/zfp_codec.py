"""CUDA ZFP kernels (fixed-accuracy and fixed-rate): build, load and launch.

The kernels live in ``repro_torch/csrc`` as CUDA C++ with a plain C
interface.  At first use each source is compiled by its own ``nvcc`` (all
started together) into a shared library under ``<repo>/build/``, keyed by a
hash of the sources and flags, and loaded with ``ctypes``.  Nothing is
built or imported at module import, so the module loads on machines with
no CUDA toolkit.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current stream, raises if the
launch returned an error, and adds one to its entry in :data:`LAUNCHES`
(under a lock: the prefetch worker launches decodes from its own thread).
The fixed-accuracy decode has two entries, flat and gathered (the
device-resident store's batch decode); both count as
``"zfp_decode_blocks_fa"``.  A launch inside a CUDA graph counts when the
graph replays (:func:`add_launches`), not when it is captured.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from repro_torch.compression.transform import MAX_WORDS, TOTAL_PLANES
from repro_torch.kernels import nvcc_build

SOURCES = {"zfp_fa_decode": "zfp_fa_decode.cu",
           "zfp_fa_encode": "zfp_fa_encode.cu",
           "zfp_fr_decode": "zfp_fr_decode.cu",
           "zfp_fr_encode": "zfp_fr_encode.cu"}
HEADERS = ("zfp_common.cuh", "zfp_lanes.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--ftz=true", "--fmad=false", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {"zfp_decode_blocks_fa": 0,
                            "zfp_encode_blocks_fa": 0,
                            "zfp_decode_blocks": 0,
                            "zfp_encode_blocks": 0}
_launch_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# nvcc output (ptxas registers and spills) of each source this process built
BUILD_LOGS: Dict[str, str] = {}


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _counted(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of :data:`LAUNCHES`."""
    with _launch_lock:
        return dict(LAUNCHES)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to :data:`LAUNCHES`.  A launch captured
    into a CUDA graph runs only when the graph replays: its capture takes
    the count back out (``times=-1``) and each replay adds it."""
    with _launch_lock:
        for k, n in counts.items():
            LAUNCHES[k] += times * n


GATHER_ENTRY = "zfp_decode_blocks_fa_gather_launch"


def has_gather(libs: Dict[str, ctypes.CDLL]) -> bool:
    """Whether these libraries have the gathered decode (an older
    checkout's, built as a baseline, may not)."""
    return hasattr(libs["zfp_fa_decode"], GATHER_ENTRY)


def bind(libs: Dict[str, ctypes.CDLL]) -> Dict[str, ctypes.CDLL]:
    """Declare the C entry points' argument types (every pointer and the
    stream as ``c_void_p``, so none is cut to 32 bits).  The gathered
    decode is bound only where the library has it."""
    ptr, nb, words = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    entries = [("zfp_fa_decode", "zfp_decode_blocks_fa_launch", 4, [nb, words]),
               ("zfp_fa_encode", "zfp_encode_blocks_fa_launch", 6, [nb]),
               ("zfp_fr_decode", "zfp_decode_blocks_launch", 3, [nb, words]),
               ("zfp_fr_encode", "zfp_encode_blocks_launch", 3, [nb, words])]
    if has_gather(libs):
        # n_samples, batch, then nb, W, lead, H, W, padded H, padded W
        entries.append(("zfp_fa_decode", GATHER_ENTRY, 5, [nb, nb] + [words] * 7))
    for key, fn, n_ptrs, tail in entries:
        f = getattr(libs[key], fn)
        f.argtypes = [ptr] * n_ptrs + tail + [ptr]
        f.restype = ctypes.c_int
    return libs


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load every kernel library; idempotent."""
    with _build_lock:
        if _libs:
            return _libs
        _libs.update(bind(nvcc_build.compile_and_load("zfp_codec", SOURCES, HEADERS,
                                                      NVCC_FLAGS, BUILD_LOGS)))
        return _libs


# the recompile watcher's probe (obs.torchprof): libraries built or loaded
# into this process, which a steady-state step must not add to
build._cache_size = lambda: len(_libs)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def zfp_decode_blocks_fa(payload: torch.Tensor, emax: torch.Tensor,
                         nplanes: torch.Tensor) -> torch.Tensor:
    """CUDA fixed-accuracy decode: ((nb, W) int32, (nb,) int32, (nb,) int32)
    -> (nb, 16) float32, with 1 <= W <= 15."""
    if payload.dim() != 2 or not 1 <= payload.shape[1] <= MAX_WORDS:
        raise ValueError(f"payload must be (nb, W) with 1 <= W <= {MAX_WORDS},"
                         f" got {tuple(payload.shape)}")
    nb, num_words = payload.shape
    dev = payload.device
    _check(payload, "payload", torch.int32, (nb, num_words), dev)
    _check(emax, "emax", torch.int32, (nb,), dev)
    _check(nplanes, "nplanes", torch.int32, (nb,), dev)
    fn = build()["zfp_fa_decode"].zfp_decode_blocks_fa_launch
    out = torch.empty((nb, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(payload.data_ptr(), emax.data_ptr(), nplanes.data_ptr(),
                     out.data_ptr(), nb, num_words, stream),
                  "zfp_decode_blocks_fa")
    _counted("zfp_decode_blocks_fa")
    return out


def check_field(nb: int, padded_shape, shape) -> tuple:
    """(lead, H, W, padded H, padded W) of a sample of ``shape`` stored
    padded to ``padded_shape`` in ``nb`` 4x4 blocks; raises where they do
    not fit together."""
    padded_shape, shape = tuple(padded_shape), tuple(shape)
    if len(shape) < 2 or len(padded_shape) != len(shape) \
            or padded_shape[:-2] != shape[:-2]:
        raise ValueError(f"shape {shape} and padded shape {padded_shape} must share "
                         f"their leading dims")
    (h, w), (ph, pw) = shape[-2:], padded_shape[-2:]
    lead = 1
    for d in shape[:-2]:
        lead *= d
    if ph % 4 or pw % 4 or not (0 < h <= ph and 0 < w <= pw) \
            or lead * (ph // 4) * (pw // 4) != nb:
        raise ValueError(f"{nb} blocks do not tile shape {shape} padded to "
                         f"{padded_shape}")
    return lead, h, w, ph, pw


def zfp_decode_blocks_fa_gather(payload: torch.Tensor, emax: torch.Tensor,
                                nplanes: torch.Tensor, idx: torch.Tensor,
                                padded_shape, shape) -> torch.Tensor:
    """CUDA gathered fixed-accuracy decode of a device-resident store's
    batch, in one launch: payload (N, nb, W) int32, emax and nplanes (N, nb)
    int32, idx (B,) int64 on the same card -> (B, *shape) float32, the
    samples ``idx`` decoded, deblockified from ``padded_shape`` and
    cropped.  An index outside [0, N) faults on the device (no host sync
    checks it here)."""
    if payload.dim() != 3 or not 1 <= payload.shape[2] <= MAX_WORDS:
        raise ValueError(f"payload must be (N, nb, W) with 1 <= W <= {MAX_WORDS},"
                         f" got {tuple(payload.shape)}")
    n, nb, num_words = payload.shape
    dev = payload.device
    _check(payload, "payload", torch.int32, (n, nb, num_words), dev)
    _check(emax, "emax", torch.int32, (n, nb), dev)
    _check(nplanes, "nplanes", torch.int32, (n, nb), dev)
    if idx.dim() != 1:
        raise ValueError(f"idx must be (B,), got {tuple(idx.shape)}")
    _check(idx, "idx", torch.int64, (idx.shape[0],), dev)
    lead, h, w, ph, pw = check_field(nb, padded_shape, shape)
    batch = idx.shape[0]
    if batch * nb >= 2 ** 31:
        raise ValueError(f"a batch of {batch} x {nb} blocks exceeds 2^31 blocks")
    fn = getattr(build()["zfp_fa_decode"], GATHER_ENTRY)
    out = torch.empty((batch,) + tuple(shape), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(payload.data_ptr(), emax.data_ptr(), nplanes.data_ptr(),
                     idx.data_ptr(), out.data_ptr(), n, batch, nb, num_words, lead,
                     h, w, ph, pw, stream),
                  "zfp_decode_blocks_fa (gathered)")
    _counted("zfp_decode_blocks_fa")
    return out


def zfp_encode_blocks_fa(blocks: torch.Tensor, tols: torch.Tensor,
                         log2tols: torch.Tensor):
    """CUDA fixed-accuracy encode: ((nb, 16) f32, (nb,) f32, (nb,) int32
    floor(log2(tol))) -> ((nb, 15) int32 payload, (nb,) int32 emax,
    (nb,) int32 nplanes)."""
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be (nb, 16), got {tuple(blocks.shape)}")
    nb = blocks.shape[0]
    dev = blocks.device
    _check(blocks, "blocks", torch.float32, (nb, 16), dev)
    _check(tols, "tols", torch.float32, (nb,), dev)
    _check(log2tols, "log2tols", torch.int32, (nb,), dev)
    fn = build()["zfp_fa_encode"].zfp_encode_blocks_fa_launch
    payload = torch.empty((nb, MAX_WORDS), dtype=torch.int32, device=dev)
    emax = torch.empty((nb,), dtype=torch.int32, device=dev)
    nplanes = torch.empty((nb,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(blocks.data_ptr(), tols.data_ptr(), log2tols.data_ptr(),
                     payload.data_ptr(), emax.data_ptr(), nplanes.data_ptr(),
                     nb, stream),
                  "zfp_encode_blocks_fa")
    _counted("zfp_encode_blocks_fa")
    return payload, emax, nplanes


def check_rate(num_words: int, bits_per_value: int) -> None:
    """A fixed-rate stream of ``bits_per_value`` planes has
    ``(bits_per_value + 1) // 2`` words, between 1 and ``MAX_WORDS``."""
    if num_words != (bits_per_value + 1) // 2 or not 1 <= num_words <= MAX_WORDS:
        raise ValueError(f"a fixed-rate payload of {bits_per_value} bits per value "
                         f"has (bits + 1) // 2 words in [1, {MAX_WORDS}], got "
                         f"{num_words}")


def zfp_decode_blocks(payload: torch.Tensor, emax: torch.Tensor,
                      bits_per_value: int) -> torch.Tensor:
    """CUDA fixed-rate decode: ((nb, W) int32, (nb,) int32) -> (nb, 16)
    float32, with W == (bits_per_value + 1) // 2 and 1 <= W <= 15."""
    if payload.dim() != 2:
        raise ValueError(f"payload must be (nb, W), got {tuple(payload.shape)}")
    nb, num_words = payload.shape
    check_rate(num_words, bits_per_value)
    dev = payload.device
    _check(payload, "payload", torch.int32, (nb, num_words), dev)
    _check(emax, "emax", torch.int32, (nb,), dev)
    fn = build()["zfp_fr_decode"].zfp_decode_blocks_launch
    out = torch.empty((nb, 16), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(payload.data_ptr(), emax.data_ptr(), out.data_ptr(), nb,
                     num_words, stream),
                  "zfp_decode_blocks")
    _counted("zfp_decode_blocks")
    return out


def zfp_encode_blocks(blocks: torch.Tensor, bits_per_value: int):
    """CUDA fixed-rate encode: (nb, 16) f32 -> ((nb, W) int32 payload,
    (nb,) int32 emax), W = (bits_per_value + 1) // 2, 1 <= bits <= 30."""
    if not 1 <= bits_per_value <= TOTAL_PLANES:
        raise ValueError(f"bits_per_value must be in [1, {TOTAL_PLANES}], got "
                         f"{bits_per_value}")
    if blocks.dim() != 2:
        raise ValueError(f"blocks must be (nb, 16), got {tuple(blocks.shape)}")
    nb = blocks.shape[0]
    dev = blocks.device
    _check(blocks, "blocks", torch.float32, (nb, 16), dev)
    fn = build()["zfp_fr_encode"].zfp_encode_blocks_launch
    num_words = (bits_per_value + 1) // 2
    payload = torch.empty((nb, num_words), dtype=torch.int32, device=dev)
    emax = torch.empty((nb,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fn(blocks.data_ptr(), payload.data_ptr(), emax.data_ptr(), nb,
                     bits_per_value, stream),
                  "zfp_encode_blocks")
    _counted("zfp_encode_blocks")
    return payload, emax
