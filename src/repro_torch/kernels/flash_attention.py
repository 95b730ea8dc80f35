"""CUDA flash attention (GQA, causal / sliding window, per-row key lengths):
build, load and launch.

The kernel lives in ``repro_torch/csrc/flash_attention.cu`` with a plain C
interface, built at first use by :mod:`.nvcc_build` into ``<repo>/build/``
and loaded with ``ctypes``.  Nothing is built at module import.

:func:`flash_attention` checks devices, dtypes, shapes and the unit stride
over D, allocates its output with ``torch.empty``, passes every tensor's
(batch, head, seq) strides so views are read and written in place, launches
on the current stream, raises if the launch returned an error, and adds one
to :data:`LAUNCHES` under a lock.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import nvcc_build

SOURCES = {"flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
MAX_HEAD_DIM = 128

# launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
_launch_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# nvcc output (ptxas registers and spills) of the build this process made
BUILD_LOGS: Dict[str, str] = {}

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["flash_attention"] = 0


def _counted() -> None:
    with _launch_lock:
        LAUNCHES["flash_attention"] += 1


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
                          ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _libs.update(libs)
        return _libs


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: Optional[int], kv_lens: Optional[torch.Tensor]) -> None:
    """Shape and type rules shared by the kernel and its plain version."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of KV heads ({hkv})")
    if kv_lens is None and sq > sk:
        raise ValueError(f"queries ({sq}) are end-aligned with keys ({sk}): need Sq <= Sk")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CUDA attention: q (B, Hq, Sq, D) f32 or bf16; k, v (B, Hkv, Sk, D) f32
    or bf16, rounded to q's dtype on load; ``kv_lens`` (B,) int32 per-row key
    lengths.  Returns (B, Hq, Sq, D) in q's dtype, laid out in memory as
    (B, Sq, Hq, D) (a transposed view), with D <= 128."""
    check_args(q, k, v, window, kv_lens)
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)) + \
            ((("kv_lens", kv_lens),) if kv_lens is not None else ()):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on the card with q ({dev}), got {t.device}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q must be f32 or bf16 and k, v one of them, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride over D")
    if kv_lens is not None and (kv_lens.dtype != torch.int32 or not kv_lens.is_contiguous()):
        raise TypeError("kv_lens must be contiguous int32")
    scale = 1.0 / (d ** 0.5) if sm_scale is None else float(sm_scale)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = build()["flash_attention"].flash_attention_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 kv_lens.data_ptr() if kv_lens is not None else None,
                 b, hq, hkv, sq, sk, d, strides, int(causal),
                 0 if window is None else int(window), scale,
                 int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error {err}")
    _counted()
    return out
