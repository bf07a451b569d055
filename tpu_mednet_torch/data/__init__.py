"""Host-side data access of the port (own copies; no tpu_mednet import),
the host and device-resident patch samplers, and the grid sampler."""

from tpu_mednet_torch.data.device_sampler import DevicePatchSampler
from tpu_mednet_torch.data.grid import GridPatchSampler
from tpu_mednet_torch.data.patch_sampler import PatchSampler
from tpu_mednet_torch.data.readers import (DataReader, HDF5Reader, MemoryReader, NiftiReader,
                                           ZarrReader, open_reader)
from tpu_mednet_torch.data.stores import VolumeDataset, VolumeGroup

__all__ = ["DataReader", "DevicePatchSampler", "GridPatchSampler", "HDF5Reader",
           "MemoryReader", "NiftiReader", "PatchSampler", "VolumeDataset", "VolumeGroup",
           "ZarrReader", "open_reader"]
