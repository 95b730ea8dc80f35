"""Operations and bytes of the work a cell asks for, from shapes and the
launches' inputs, whatever implements it.

Model FLOPs count the dense layer and the nine convolutions of the
surrogate (multiply and add as two); a training step is the forward, the
weight gradients of every layer and the input gradients of every layer but
the first (the condition vector needs none).  Layer norms, activations,
the loss and Adam are elementwise and are not counted.

The codec counts are the roofline's minimum traffic: every input byte
read once and every output byte written once; where the work depends on
the data, what these inputs need (a fixed-accuracy block needs the words
that hold its planes).  Operations per 4x4 block are the function's work
(unpack 8 a lane a word, the two 4-point lift passes, negabinary and
dequantize), as ``chip_smoke.py``'s bounds count them.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def surrogate_layers(ny: int, nx: int, fields: int, base_channels: int,
                     cond_dim: int) -> Iterator[Tuple[str, float]]:
    """(layer, forward FLOPs per sample) of the surrogate, in order."""
    h, w, c = ny // 16, nx // 16, base_channels
    yield "proj", 2.0 * cond_dim * h * w * c
    for i in range(4):
        cout = max(c // 2, 32)
        yield f"up{i}_t", 2.0 * c * cout * 16 * h * w      # 4x4 kernel, every input pixel
        h, w = 2 * h, 2 * w
        yield f"up{i}_c", 2.0 * cout * cout * 9 * h * w
        c = cout
    yield "out", 2.0 * c * fields * 9 * h * w


def train_step_flops(cfg: dict, samples: int) -> float:
    """FLOPs of one training step over ``samples`` samples (members x batch)."""
    layers = dict(surrogate_layers(cfg["ny"], cfg["nx"], cfg["fields"],
                                   cfg["base_channels"], cfg["cond_dim"]))
    fwd = sum(layers.values())
    return samples * (3.0 * fwd - layers["proj"])


# -- codec ------------------------------------------------------------------

DECODE_OPS_FRONT = 17 + 32 + 8 * 16 + 48       # negabinary, lifts, dequantize
FR_DECODE_OPS_FRONT = 32 + 8 * 16 + 48
# quantize, forward lifts, negabinary, the plane guess, packing 30 planes
ENCODE_OPS_FRONT = 16 + 32 + 5 + 64 + 8 * 16 + 32 + 16 + 5 + 2 * 16 * 30
ENCODE_OPS_CHECK = 16 + 32 + 8 * 16 + 48 + 48 + 3


def fa_gather_decode(words: np.ndarray, samples: int) -> Tuple[float, float]:
    """(bytes, operations) of one gathered fixed-accuracy decode: ``words``
    holds each decoded block's payload words (ceil of its planes over two),
    ``samples`` the gathered indices (int64 each).  Every block reads its
    words, its emax and its plane count and writes 16 floats."""
    words = np.asarray(words, np.float64)
    nb = words.size
    nbytes = 4.0 * words.sum() + 8.0 * nb + 64.0 * nb + 8.0 * samples
    ops = 128.0 * words.sum() + DECODE_OPS_FRONT * nb
    return nbytes, ops


def fa_encode(blocks: int) -> Tuple[float, float]:
    """(bytes, operations) of the fixed-accuracy encode of ``blocks`` blocks:
    16 floats, a tolerance and its exponent in; the 15-word payload row,
    emax and plane count out; one bound-verification pass a block (every
    block takes the first; more are data-dependent and not counted)."""
    nbytes = blocks * (64.0 + 8.0 + 4.0 * 15 + 8.0)
    ops = blocks * (ENCODE_OPS_FRONT + ENCODE_OPS_CHECK)
    return nbytes, ops


def fr_decode(blocks: int, words: int) -> Tuple[float, float]:
    """(bytes, operations) of one fixed-rate decode of ``blocks`` blocks of
    ``words`` payload words each (every word holds two planes to decode)."""
    nbytes = blocks * (4.0 * words + 4.0) + 64.0 * blocks
    ops = blocks * (96.0 * words + FR_DECODE_OPS_FRONT)
    return nbytes, ops
