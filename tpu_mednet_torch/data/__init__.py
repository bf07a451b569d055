"""Host-side data access of the port (own copies; no tpu_mednet import)."""

from tpu_mednet_torch.data.readers import DataReader, MemoryReader, open_reader
from tpu_mednet_torch.data.stores import VolumeDataset, VolumeGroup

__all__ = ["DataReader", "MemoryReader", "VolumeDataset", "VolumeGroup", "open_reader"]
