"""Dataset shard ownership (host-sliced, composes with the loaders).

A copy of ``owned_shards`` from ``repro/distributed/sharding.py``; the rest
of that module (partition rules for parameters and activations) waits for
ROADMAP Queue 1 item 12.
"""
from __future__ import annotations

import numpy as np


def owned_shards(num_shards: int, host_id: int, num_hosts: int) -> np.ndarray:
    """Contiguous balanced slice of dataset shard ids owned by one host.

    Host h owns shards [start_h, start_h + count_h): the first
    ``num_shards % num_hosts`` hosts take one extra shard.  Contiguous
    (rather than strided) ownership keeps each host's reads inside a
    minimal set of shard files -- the point of packing many samples per
    shard -- while the union over hosts partitions [0, num_shards)
    exactly, mirroring the data-parallel batch axis split.
    """
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    counts = np.full(num_hosts, num_shards // num_hosts, np.int64)
    counts[:num_shards % num_hosts] += 1
    start = int(counts[:host_id].sum())
    return np.arange(start, start + counts[host_id])
