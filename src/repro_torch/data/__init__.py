"""Stores and loaders."""
from repro_torch.data.device_store import DeviceResidentCompressedStore
from repro_torch.data.loader import (EnsembleLoader, PrefetchLoader,
                                     ShardAwareLoader, ShardedLoader)
from repro_torch.data.shards import ShardedCompressedStore
from repro_torch.data.store import (ArrayStore, CompressedArrayStore, IoStats,
                                    RawArrayStore, channels_last, throttle)

__all__ = ["ArrayStore", "CompressedArrayStore", "DeviceResidentCompressedStore",
           "EnsembleLoader", "IoStats", "PrefetchLoader", "RawArrayStore", "ShardAwareLoader",
           "ShardedCompressedStore", "ShardedLoader", "channels_last",
           "throttle"]
