"""In-memory volume group store for assembled inference results.

The port's own copy of ``VolumeDataset``/``VolumeGroup`` from
``tpu_mednet/data/stores.py``: a dict-backed group of named arrays with
per-dataset attrs.  Persistence (HDF5, zarr, NIfTI export) is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class VolumeDataset:
    """A named array plus an attrs dict (zarr/h5py-dataset-alike)."""

    def __init__(self, array: np.ndarray):
        self.array = array
        self.attrs: Dict[str, object] = {}

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    def __getitem__(self, idx):
        return self.array[idx]

    def __setitem__(self, idx, value):
        self.array[idx] = value

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.array, dtype=dtype)


class VolumeGroup:
    """Dict-backed group of named volumes with attrs.

    API subset of a zarr group sufficient for the stitching pipeline:
    ``require_dataset``, item access and iteration.
    """

    def __init__(self):
        self._datasets: Dict[str, VolumeDataset] = {}

    def require_dataset(self, key: str, shape: Tuple[int, ...], dtype) -> VolumeDataset:
        ds = self._datasets.get(key)
        if ds is None:
            ds = VolumeDataset(np.zeros(shape, dtype=dtype))
            self._datasets[key] = ds
        elif ds.shape != tuple(shape) or ds.dtype != np.dtype(dtype):
            raise ValueError(
                f"dataset {key!r} exists with shape={ds.shape} dtype={ds.dtype}, "
                f"requested shape={tuple(shape)} dtype={np.dtype(dtype)}"
            )
        return ds

    def __getitem__(self, key: str) -> VolumeDataset:
        return self._datasets[key]

    def __contains__(self, key: str) -> bool:
        return key in self._datasets

    def __iter__(self) -> Iterator[str]:
        return iter(self._datasets)

    def keys(self):
        return self._datasets.keys()

    def items(self):
        return self._datasets.items()

    def __len__(self) -> int:
        return len(self._datasets)
