"""CUDA flash attention (GQA, causal / sliding window, per-row key lengths):
build, load, choose a kernel and launch.

The kernels live in ``repro_torch/csrc/flash_attention.cu`` with a plain C
interface, built at first use by :mod:`.nvcc_build` into ``<repo>/build/``
and loaded with ``ctypes``.  Nothing is built at module import.

Three device kernels compute the same function; :func:`select_variant`, a
pure rule on dtypes, shapes, strides and alignment, names the one a call
launches, and that name goes to the C entry point:

* ``"prefill_wgmma"``: bf16 q, k, v, head dim 64 or 128, no ``kv_lens``,
  more than 8 queries, every (batch, head, seq) stride and base pointer
  16-byte aligned (TMA's rule).  Tensor cores (``wgmma``) fed by TMA.
* ``"decode_splitkv"``: at most 8 queries, q f32 or bf16, k/v f32 or bf16
  with 16-byte aligned rows, head dim <= 128, at most 64 query rows per KV
  head (group x Sq), ``kv_lens`` or not.  Split over the keys, each KV head
  read once per GQA group (per 8 of those rows), then a merge kernel.
* ``"scalar"``: everything else (f32 q with long queries, other head dims,
  f32 k/v with long queries, unaligned rows).

A variant whose preconditions fail raises; nothing falls back to another
variant or to plain code.  :func:`flash_attention` checks devices, dtypes,
shapes and the unit stride over D, allocates its output (and the split
scratch) with ``torch.empty``, passes every tensor's (batch, head, seq)
strides so views are read and written in place, launches on the current
stream, raises if the launch returned an error, and adds one to
:data:`LAUNCHES` and to the variant's entry of :data:`VARIANT_LAUNCHES`
under a lock.  :func:`flash_attention_partial` launches the split-KV decode
on one shard of a sequence-sharded cache and returns its f32 output with
each row's log-sum-exp, for the caller to merge the shards.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import nvcc_build

SOURCES = {"flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 128

VARIANTS = ("prefill_wgmma", "decode_splitkv", "scalar")
_VARIANT_CODE = {"scalar": 0, "prefill_wgmma": 1, "decode_splitkv": 2}
PREFILL_HEAD_DIMS = (64, 128)
DECODE_MAX_SQ = 8
DECODE_MAX_ROWS = 64         # group x Sq query rows one decode CTA holds
DECODE_TILE = 32             # keys per shared-memory stage of the decode
SPLIT_KEYS = (128, 64, 32)   # keys per decode split, longest first
MIN_CTAS = 2 * 132           # two CTAs per SM of the H100

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in VARIANTS}
# of those, the launches of the partial entry (each a decode_splitkv one)
PARTIAL_LAUNCHES: Dict[str, int] = {"flash_attention_partial": 0}
_launch_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# nvcc output (ptxas registers and spills) of the build this process made
BUILD_LOGS: Dict[str, str] = {}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["flash_attention"] = 0
        for v in VARIANTS:
            VARIANT_LAUNCHES[v] = 0
        PARTIAL_LAUNCHES["flash_attention_partial"] = 0


def _counted(variant: str = "scalar", partial: bool = False) -> None:
    with _launch_lock:
        LAUNCHES["flash_attention"] += 1
        VARIANT_LAUNCHES[variant] += 1
        PARTIAL_LAUNCHES["flash_attention_partial"] += int(partial)


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load the kernel library; idempotent."""
    with _build_lock:
        if _libs:
            return _libs
        libs = nvcc_build.compile_and_load("flash_attention", SOURCES, (), NVCC_FLAGS,
                                           BUILD_LOGS)
        fn = libs["flash_attention"].flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _libs.update(libs)
        return _libs


# the recompile watcher's probe (obs.torchprof): libraries built or loaded
# into this process, which a steady-state step must not add to
build._cache_size = lambda: len(_libs)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int], kv_lens: Optional[torch.Tensor],
               causal: bool = True) -> None:
    """Shape and type rules shared by the kernel and its plain version.
    More queries than keys are taken only where their alignment cannot
    matter: non-causal, no window, no ``kv_lens`` (cross-attention from a
    long decoder prompt onto a short encoder input)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of KV heads ({hkv})")
    if kv_lens is None and sq > sk and (causal or window is not None):
        raise ValueError(f"queries ({sq}) are end-aligned with keys ({sk}): need Sq <= Sk "
                         f"unless non-causal without a window")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")


# ---------------------------------------------------------------------------
# choosing the kernel
# ---------------------------------------------------------------------------

def _rows_aligned(t: torch.Tensor) -> bool:
    """Base pointer and (batch, head, seq) strides are multiples of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:3])


def _prefill_ok(q, k, v, kv_lens) -> bool:
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[3] in PREFILL_HEAD_DIMS and kv_lens is None
            and q.shape[2] > DECODE_MAX_SQ and all(_rows_aligned(t) for t in (q, k, v)))


def _decode_ok(q, k, v) -> bool:
    b, hq, sq, d = q.shape
    return (sq <= DECODE_MAX_SQ and q.dtype in _DTYPES and k.dtype in _DTYPES
            and d <= MAX_HEAD_DIM and d * k.element_size() % 16 == 0
            and (hq // k.shape[1]) * sq <= DECODE_MAX_ROWS
            and _rows_aligned(k) and _rows_aligned(v))


def select_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_lens: Optional[torch.Tensor], window: Optional[int]) -> str:
    """The kernel a call launches, from dtypes, shapes, strides and
    alignment alone (``window`` is taken by every variant): short queries
    go to the split-KV decode, long bf16 ones to the tensor-core prefill,
    and the rest to the scalar kernel."""
    if _decode_ok(q, k, v):
        return "decode_splitkv"
    if _prefill_ok(q, k, v, kv_lens):
        return "prefill_wgmma"
    return "scalar"


def split_plan(b: int, hkv: int, sk: int) -> Tuple[int, int]:
    """(splits, keys per split) of the split-KV decode: the longest split
    of SPLIT_KEYS that still gives MIN_CTAS CTAs over (B, Hkv, splits),
    from the key capacity Sk alone (``kv_lens`` is never read on the host)."""
    for keys in SPLIT_KEYS:
        if b * hkv * math.ceil(sk / keys) >= MIN_CTAS:
            break
    return max(1, math.ceil(sk / keys)), keys


def decode_scratch_shapes(b: int, hq: int, sq: int, d: int,
                          splits: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Shapes of the decode partials: (m, l) and the unnormalised acc, f32."""
    return (2, b, hq, sq, splits), (b, hq, sq, splits, d)


# ---------------------------------------------------------------------------
# launch
# ---------------------------------------------------------------------------

def _require_card(q, k, v, kv_lens) -> None:
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)) + \
            ((("kv_lens", kv_lens),) if kv_lens is not None else ()):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on the card with q ({dev}), got {t.device}")


def _current_stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA attention: q (B, Hq, Sq, D) f32 or bf16; k, v (B, Hkv, Sk, D) f32
    or bf16, rounded to q's dtype on load; ``kv_lens`` (B,) int32 per-row key
    lengths.  Returns (B, Hq, Sq, D) in q's dtype, laid out in memory as
    (B, Sq, Hq, D) (a transposed view), with D <= 128.  The kernel is
    :func:`select_variant`'s."""
    _check_launch_args(q, k, v, window, kv_lens, causal)
    return _launch_checked(q, k, v, causal, sm_scale, window, kv_lens,
                           select_variant(q, k, v, kv_lens, window))


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True, sm_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            kv_lens: Optional[torch.Tensor] = None,
                            q_shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-KV decode over one shard of a cache whose sequence is split
    over ranks: every query's end-aligned position moves ``q_shift`` (>= 0)
    further on, so a shard whose keys all precede the queries masks them as
    the whole cache would.  Returns (out (B, Hq, Sq, D) f32, normalised over
    this shard's keys, laid out as (B, Sq, Hq, D); lse (B, Hq, Sq) f32, each
    row's log-sum-exp of its scaled scores, -1e30 and out 0 for a row
    that saw no key).  Shards merge as ``sum_i e^(lse_i - M) out_i / sum_i e^(lse_i -
    M)``.  Only ``decode_splitkv``'s inputs are taken; others raise."""
    _check_launch_args(q, k, v, window, kv_lens, causal)
    if q_shift < 0:
        raise ValueError(f"q_shift must be >= 0, got {q_shift}")
    if select_variant(q, k, v, kv_lens, window) != "decode_splitkv":
        raise ValueError(f"the partial entry takes the split-KV decode's inputs only "
                         f"(at most {DECODE_MAX_SQ} queries), got q {tuple(q.shape)} "
                         f"{q.dtype}, k/v {tuple(k.shape)} {k.dtype}")
    return _launch_checked(q, k, v, causal, sm_scale, window, kv_lens, "decode_splitkv",
                           q_shift=q_shift, partial=True)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            sm_scale: Optional[float], window: Optional[int],
            kv_lens: Optional[torch.Tensor], variant: str) -> torch.Tensor:
    """Launch the named variant; raises if its preconditions fail (every
    input the prefill or decode kernel takes is one select_variant gives it)."""
    _check_launch_args(q, k, v, window, kv_lens, causal)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant != "scalar" and select_variant(q, k, v, kv_lens, window) != variant:
        raise ValueError(f"{variant} does not take q {tuple(q.shape)} {q.dtype}, k/v "
                         f"{tuple(k.shape)} {k.dtype} (strides {q.stride()}, "
                         f"{k.stride()}), kv_lens {'set' if kv_lens is not None else 'None'}")
    return _launch_checked(q, k, v, causal, sm_scale, window, kv_lens, variant)


def _check_launch_args(q, k, v, window, kv_lens, causal) -> None:
    check_args(q, k, v, window, kv_lens, causal)
    _require_card(q, k, v, kv_lens)
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q must be f32 or bf16 and k, v one of them, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit stride over D")
    if kv_lens is not None and (kv_lens.dtype != torch.int32 or not kv_lens.is_contiguous()):
        raise TypeError("kv_lens must be contiguous int32")


def _launch_checked(q, k, v, causal, sm_scale, window, kv_lens, variant,
                    q_shift: int = 0, partial: bool = False):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5) if sm_scale is None else float(sm_scale)
    dev = q.device
    out = torch.empty((b, sq, hq, d), dtype=torch.float32 if partial else q.dtype,
                      device=dev).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if partial else None
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *out.stride()[:3])
    ml = acc = None
    splits, split_keys = 0, 0
    if variant == "decode_splitkv":
        splits, split_keys = split_plan(b, hkv, sk)
        ml_shape, acc_shape = decode_scratch_shapes(b, hq, sq, d, splits)
        ml = torch.empty(ml_shape, dtype=torch.float32, device=dev)
        acc = torch.empty(acc_shape, dtype=torch.float32, device=dev)
    fn = build()["flash_attention"].flash_attention_launch
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             kv_lens.data_ptr() if kv_lens is not None else None,
             b, hq, hkv, sq, sk, d, strides, int(causal),
             0 if window is None else int(window), scale,
             int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
             _VARIANT_CODE[variant],
             ml.data_ptr() if ml is not None else None,
             acc.data_ptr() if acc is not None else None, splits, split_keys,
             int(q_shift), lse.data_ptr() if lse is not None else None,
             _current_stream(dev))
    if err != 0:
        raise RuntimeError(f"flash_attention ({variant}) launch failed with CUDA error {err}")
    _counted(variant, partial)
    return (out, lse) if partial else out
