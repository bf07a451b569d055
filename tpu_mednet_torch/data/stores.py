"""In-memory volume group store for assembled inference results.

The port's own copy of ``VolumeDataset``/``VolumeGroup`` from
``tpu_mednet/data/stores.py``: a dict-backed group of named arrays with
per-dataset attrs, persisted to HDF5 (``h5py``, imported when used) or to
zarr (the ``zarr`` package, else the port's ``zarrlite``).  NIfTI export
waits with ``utils/nifti.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from tpu_mednet_torch.data.readers import _h5py, _zarr


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

    # -- persistence ------------------------------------------------------

    def to_hdf5(self, path, group: Optional[str] = None) -> None:
        """Persist all datasets (with attrs) into an HDF5 file/group."""
        with _h5py("to_hdf5").File(str(path), "a") as hf:
            target = hf.require_group(group) if group else hf
            for key, ds in self._datasets.items():
                if key in target:
                    del target[key]
                out = target.create_dataset(key, data=ds.array)
                for name, value in ds.attrs.items():
                    out.attrs[name] = value

    def to_zarr(self, path, group: Optional[str] = None) -> None:
        """Persist into a zarr store (zarr package, or the port's zarrlite)."""
        root = _zarr().open(str(path), mode="a")
        try:
            target = root.require_group(group) if group else root
            for key, ds in self._datasets.items():
                arr = target.create_dataset(
                    key, data=ds.array, shape=ds.shape, dtype=ds.dtype,
                    overwrite=True
                )
                for name, value in ds.attrs.items():
                    arr.attrs[name] = value
        finally:
            # a ZipStore writes its central directory only on close()
            store = getattr(root, "store", None)
            if store is not None and hasattr(store, "close"):
                store.close()

    def save(self, path, group: Optional[str] = None) -> None:
        """Persist to ``.h5``/``.hdf5``/``.hdf`` or else to zarr, by suffix
        (the intended behaviour of the reference's save branch,
        predict.py:100-115, whose suffix test was buggy)."""
        name = Path(str(path)).name
        if name.endswith(".nii") or name.endswith(".nii.gz"):
            raise NotImplementedError(
                "NIfTI export is not yet ported to tpu_mednet_torch (ROADMAP §1, "
                "'to_nifti and the NIfTI reader'); save to .zarr or .h5")
        if Path(str(path)).suffix in (".h5", ".hdf5", ".hdf"):
            self.to_hdf5(path, group)
        else:
            self.to_zarr(path, group)
