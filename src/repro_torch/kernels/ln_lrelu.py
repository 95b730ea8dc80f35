"""CUDA channel layer norm + LeakyReLU (the surrogate's blocks): build, load,
launch, and the autograd Function around the pair.

The kernels live in ``repro_torch/csrc/ln_lrelu.cu`` with a plain C
interface, built at first use by :mod:`.nvcc_build` into ``<repo>/build/``
and loaded with ``ctypes``; nothing is built at module import.  The source
notes what bounds the pair (about 20 bytes of memory traffic a float) and
how its design keeps to that; it replaces no TPU kernel (XLA fuses the JAX
layer).

:func:`forward` and :func:`backward` check devices, dtypes, shapes and
contiguity, allocate their outputs and the backward's partial-sum scratch
with ``torch.empty``, launch on the current stream, raise if a launch
returned an error, and count each launch in :data:`LAUNCHES` (under a
lock): ``ln_lrelu_fwd`` a forward, ``ln_lrelu_bwd`` and
``ln_lrelu_bwd_reduce`` the two launches of a backward.  An input with no
pixel launches nothing.  Their plain versions are
``kernels/ref.py`` ``ln_lrelu_forward`` / ``ln_lrelu_backward``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import nvcc_build
from repro_torch.kernels.zfp_codec import _check, _raise_on

SOURCES = {"ln_lrelu": "ln_lrelu.cu"}
# denormals kept and no contracted multiply-adds: PyTorch's elementwise ops
# round each product and sum on its own and keep denormals
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--ftz=false", "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel in this process
LAUNCHES: Dict[str, int] = {"ln_lrelu_fwd": 0, "ln_lrelu_bwd": 0, "ln_lrelu_bwd_reduce": 0}
_launch_lock = threading.Lock()

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# nvcc output (ptxas registers and spills) of the build this process made
BUILD_LOGS: Dict[str, str] = {}


def _counted(*names: str) -> None:
    with _launch_lock:
        for name in names:
            LAUNCHES[name] += 1


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    """A copy of :data:`LAUNCHES`."""
    with _launch_lock:
        return dict(LAUNCHES)


def build() -> Dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load the kernel library; idempotent."""
    with _build_lock:
        if _libs:
            return _libs
        libs = nvcc_build.compile_and_load("ln_lrelu", SOURCES, (), NVCC_FLAGS, BUILD_LOGS)
        lib = libs["ln_lrelu"]
        ptr, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.ln_lrelu_backward_blocks.argtypes = [i64, i32]
        lib.ln_lrelu_backward_blocks.restype = i64
        lib.ln_lrelu_forward_launch.argtypes = [ptr] * 6 + [i64, i64, i32, f32, f32, ptr]
        lib.ln_lrelu_forward_launch.restype = i32
        lib.ln_lrelu_backward_launch.argtypes = [ptr] * 10 + [i64, i64, i32, i64, f32, ptr]
        lib.ln_lrelu_backward_launch.restype = i32
        _libs.update(libs)
        return _libs


# the recompile watcher's probe (obs.torchprof; train/loop.py watches it):
# libraries built or loaded into this process, which a steady-state step
# must not add to
build._cache_size = lambda: len(_libs)


def _check_block(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    _check(x, "x", torch.float32, x.shape, x.device)
    _check(g, "g", torch.float32, (x.shape[1],), x.device)
    _check(b, "b", torch.float32, (x.shape[1],), x.device)


def forward(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float, slope: float,
            stats: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``leaky_relu(layernorm(x))`` over dim 1 of a contiguous (B, C, H, W)
    float32 x on the card, g and b (C,) -> (y, mean, rstd), the per-pixel
    mean and rstd (B, H, W); with ``stats=False`` neither is written and
    both come back None."""
    _check_block(x, g, b)
    bsz, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = torch.empty((bsz, h, w), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    if y.numel() == 0:
        return y, mean, rstd
    fn = build()["ln_lrelu"].ln_lrelu_forward_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                     mean.data_ptr() if stats else None, rstd.data_ptr() if stats else None,
                     bsz * h * w, h * w, c, eps, slope, stream),
                  "ln_lrelu forward")
    _counted("ln_lrelu_fwd")
    return y, mean, rstd


def backward(dy: torch.Tensor, x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
             mean: torch.Tensor, rstd: torch.Tensor, slope: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`forward`'s y for its cotangent ``dy``: (dx, dg,
    db), from x and the forward's mean and rstd."""
    _check_block(x, g, b)
    bsz, c, h, w = x.shape
    _check(dy, "dy", torch.float32, x.shape, x.device)
    _check(mean, "mean", torch.float32, (bsz, h, w), x.device)
    _check(rstd, "rstd", torch.float32, (bsz, h, w), x.device)
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx, torch.zeros_like(g), torch.zeros_like(b)
    dg, db = torch.empty_like(g), torch.empty_like(b)
    lib = build()["ln_lrelu"]
    pixels = bsz * h * w
    nblk = lib.ln_lrelu_backward_blocks(pixels, c)
    part = torch.empty((2, c, nblk), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _raise_on(lib.ln_lrelu_backward_launch(
            dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), g.data_ptr(),
            b.data_ptr(), dx.data_ptr(), part.data_ptr(), dg.data_ptr(), db.data_ptr(),
            pixels, h * w, c, nblk, slope, stream),
                  "ln_lrelu backward")
    _counted("ln_lrelu_bwd", "ln_lrelu_bwd_reduce")
    return dx, dg, db


class LayerNormLeakyRelu(torch.autograd.Function):
    """The pair under autograd: saves x and the forward's mean and rstd (no
    full-size intermediate), and its backward is one :func:`backward`."""

    @staticmethod
    def forward(ctx, x, g, b, eps: float, slope: float):
        y, mean, rstd = forward(x, g, b, eps, slope)
        ctx.save_for_backward(x, g, b, mean, rstd)
        ctx.slope = slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, g, b, mean, rstd = ctx.saved_tensors
        dx, dg, db = backward(dy.contiguous(), x, g, b, mean, rstd, ctx.slope)
        return dx, dg, db, None, None


def layernorm_leaky_relu(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                         eps: float, slope: float) -> torch.Tensor:
    """The block on the card: the Function where autograd records, else the
    forward kernel alone, which writes no statistics and saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad or b.requires_grad):
        return LayerNormLeakyRelu.apply(x, g, b, eps, slope)
    return forward(x, g, b, eps, slope, stats=False)[0]
