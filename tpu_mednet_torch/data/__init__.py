"""Host-side data access of the port (own copies; no tpu_mednet import)
and the device-resident patch sampler."""

from tpu_mednet_torch.data.device_sampler import DevicePatchSampler
from tpu_mednet_torch.data.readers import DataReader, MemoryReader, open_reader
from tpu_mednet_torch.data.stores import VolumeDataset, VolumeGroup

__all__ = ["DataReader", "DevicePatchSampler", "MemoryReader", "VolumeDataset",
           "VolumeGroup", "open_reader"]
