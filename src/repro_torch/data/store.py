"""The ``ArrayStore`` protocol and the store -> model layout transform.

Counterpart of the protocol half of ``repro/data/store.py``.  The host
stores (raw and per-sample compressed) wait for a later slice, and so does
``IoStats`` (it lives in the telemetry package, ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class ArrayStore(Protocol):
    """Indexed batch access to a dataset plus its logical footprint."""
    shape: Tuple[int, ...]
    num_samples: int
    sample_nbytes: int

    def get_batch(self, idx: np.ndarray) -> torch.Tensor: ...

    @property
    def stored_bytes(self) -> int: ...


def channels_last(batch: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) store batch -> (B, H, W, C) model layout."""
    return batch.permute(0, 2, 3, 1)
