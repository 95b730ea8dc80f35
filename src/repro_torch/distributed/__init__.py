"""Multi-host helpers: dataset shard ownership, and the sharding rules of
parameters, optimizer state, batches and caches as DTensor placements."""
from repro_torch.distributed.sharding import (P, batch_specs, cache_specs,
                                              distribute_tree, gather_tree,
                                              make_shardings, opt_specs,
                                              owned_shards, param_specs,
                                              placements, resolve_specs)

__all__ = ["P", "batch_specs", "cache_specs", "distribute_tree", "gather_tree",
           "make_shardings", "opt_specs", "owned_shards", "param_specs",
           "placements", "resolve_specs"]
