"""In-memory volume group store for assembled inference results.

The port's own copy of ``VolumeDataset``/``VolumeGroup`` from
``tpu_mednet/data/stores.py``: a dict-backed group of named arrays with
per-dataset attrs, persisted to HDF5 (``h5py``, imported when used) or to
zarr (the ``zarr`` package, else the port's ``zarrlite``), or to a
directory of NIfTI volumes (``utils/nifti.py``).
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

    def to_nifti(self, path, group: Optional[str] = None) -> None:
        """Write per-key ``.nii.gz`` volumes under ``<path>[/<group>]``, the
        layout ``NiftiReader`` reads: (C, X, Y, Z) arrays write as 3D NIfTI
        when C == 1, else as 4D with the channel axis trailing; an
        ``affine`` attr lands in the sform."""
        from tpu_mednet_torch.utils.nifti import save_nifti

        base = Path(str(path)) / group if group else Path(str(path))
        base.mkdir(parents=True, exist_ok=True)
        for key, ds in self._datasets.items():
            arr = np.asarray(ds.array)
            if arr.ndim == 4:
                arr = arr[0] if arr.shape[0] == 1 else np.moveaxis(arr, 0, -1)
            affine = ds.attrs.get("affine")
            save_nifti(base / f"{key}.nii.gz", arr,
                       None if affine is None else np.asarray(affine))

    def save(self, path, group: Optional[str] = None) -> None:
        """Persist to ``.h5``/``.hdf5``/``.hdf``, to a directory of NIfTI
        volumes for a path named ``*.nii`` (``to_nifti``), or else to zarr,
        by suffix (the intended behaviour of the reference's save branch,
        predict.py:100-115, whose suffix test was buggy)."""
        name = Path(str(path)).name
        if name.endswith(".nii") or name.endswith(".nii.gz"):
            self.to_nifti(path, group)
            return
        if Path(str(path)).suffix in (".h5", ".hdf5", ".hdf"):
            self.to_hdf5(path, group)
        else:
            self.to_zarr(path, group)
