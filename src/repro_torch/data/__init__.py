"""Stores and loaders."""
from repro_torch.data.device_store import DeviceResidentCompressedStore
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.store import ArrayStore, channels_last

__all__ = ["ArrayStore", "DeviceResidentCompressedStore", "ShardedLoader",
           "channels_last"]
