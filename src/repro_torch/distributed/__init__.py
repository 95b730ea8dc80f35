"""Multi-host helpers.  Only dataset shard ownership is ported; mesh and
parameter sharding wait for ROADMAP Queue 1 item 12."""
from repro_torch.distributed.sharding import owned_shards

__all__ = ["owned_shards"]
