"""Volume readers over HDF5, zarr and in-memory stores.

The port's own copy of ``tpu_mednet/data/readers.py`` (``DataReader``,
``HDF5Reader``, ``ZarrReader``, ``MemoryReader``, ``open_reader``), since
the port imports nothing of the JAX package: uniform
``<file>/<group>/<key>`` access to channels-first (C, X, Y, Z) volumes,
bulk preload with timing telemetry, shape and ``affine`` queries.

- ``h5py`` is imported when an HDF5 file is opened, and its absence raises
  there with the way out (a zarr store);
- ``ZarrReader`` uses the ``zarr`` package where it is installed and the
  port's stdlib-only copy of the v2 format (``zarrlite``) where it is not.

``NiftiReader`` reads a directory of ``<group>/<key>.nii[.gz]`` volumes
through the port's dependency-free ``utils/nifti.py``.  ``read`` yields one
volume at a time, so a caller that streams a group holds one volume;
``dtype=None`` keeps the stored dtype (``read_single_volume``).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _zarr():
    try:  # optional dependency; fall back to the bundled v2 implementation
        import zarr
    except ImportError:
        from tpu_mednet_torch.data import zarrlite as zarr
    return zarr


def _h5py(what: str):
    try:
        import h5py
    except ImportError:
        raise ImportError(f"{what} needs h5py, which is not installed; write the "
                          "volumes to a zarr store (.zarr) instead") from None
    return h5py


def missing_subject_error(reader, group: str, key: str) -> KeyError:
    """A KeyError that names the store, group, and key instead of the
    backend's bare object-path message — the first thing a user with a
    stale keyfile entry hits."""
    path = getattr(reader, "path_data", "<memory store>")
    try:
        groups = reader.list_groups()
        if group not in groups:
            return KeyError(
                f"group {group!r} not found in {path!s} (available groups: "
                f"{groups}) — check --image_group/--label_group/"
                f"--heatmap_group")
        avail = reader.list_keys(group)
        sample = ", ".join(list(avail)[:5])
        more = "..." if len(avail) > 5 else ""
        return KeyError(
            f"subject {key!r} not found in group {group!r} of {path!s} "
            f"({len(avail)} subjects present, e.g. {sample}{more}) — stale "
            f"keyfile entry?")
    except Exception:  # listing failed: still name the store and key
        return KeyError(f"subject {key!r} not found in group {group!r} of "
                        f"{path!s}")


class DataReader:
    """Abstract reader (reference dataset.py:109-148)."""

    def read(self, subject_keys: Sequence[str], group: str,
             dtype=np.float16) -> Iterator[np.ndarray]:
        """One volume per key, read when the iterator reaches it, cast to
        ``dtype``; ``dtype=None`` keeps the stored dtype (the JAX readers'
        ``dtype=None, preload=False``)."""
        raise NotImplementedError

    def read_data_to_memory(self, subject_keys: Sequence[str], group: str,
                            dtype=np.float16) -> deque:
        """Bulk-read a group into a deque, logging the wall time
        (reference dataset.py:114-139)."""
        logger.info("loading group [%s]...", group)
        t = time.perf_counter()
        data = deque(self.read(subject_keys, group, dtype))
        logger.debug("finished: %.3f s", time.perf_counter() - t)
        return data

    def get_data_shape(self, subject_keys: Sequence[str], group: str) -> Dict[str, tuple]:
        raise NotImplementedError

    def get_data_attribute(self, subject_keys: Sequence[str], group: str,
                           attribute: str) -> Dict[str, object]:
        raise NotImplementedError

    def list_keys(self, group: str) -> list:
        """Enumerate the subject keys stored under ``group`` (sorted)."""
        raise NotImplementedError

    def list_groups(self) -> list:
        """Enumerate the top-level groups of the store (sorted)."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _NodeReader(DataReader):
    """A reader over a store whose nodes are ``root[f"{group}/{key}"]``
    arrays with ``.attrs`` (h5py files and zarr groups alike)."""

    root = None

    def _node(self, group, k):
        try:
            return self.root[f"{group}/{k}"]
        except KeyError:
            raise missing_subject_error(self, group, k) from None

    def read(self, subject_keys, group, dtype=np.float16):
        for k in subject_keys:
            yield np.asarray(self._node(group, k)[:], dtype=dtype)

    def get_data_shape(self, subject_keys, group):
        return {k: self._node(group, k).shape for k in subject_keys}

    def get_data_attribute(self, subject_keys, group, attribute):
        return {k: self._node(group, k).attrs[attribute] for k in subject_keys}

    def list_keys(self, group):
        return sorted(self.root[group].keys())

    def list_groups(self):
        return sorted(self.root.keys())


class HDF5Reader(_NodeReader):
    """HDF5-backed reader (reference ``DataReaderHDF5``, dataset.py:150-177)."""

    def __init__(self, path_data):
        self.path_data = path_data
        self.root = _h5py("HDF5Reader").File(str(path_data), "r")

    def close(self):
        self.root.close()


class ZarrReader(_NodeReader):
    """zarr-backed reader — the working equivalent of the reference's
    ``DataReaderZarr`` (dataset.py:179-207)."""

    def __init__(self, path_data):
        self.path_data = path_data
        self.root = _zarr().open(str(path_data), mode="r")

    def close(self):
        # directory stores hold no handle, but a ZipStore keeps the zip file
        # open (real zarr and zarrlite both expose it as ``.store``)
        store = getattr(self.root, "store", None)
        if store is not None and hasattr(store, "close"):
            store.close()


class NiftiReader(DataReader):
    """Reader over a directory of per-subject NIfTI volumes, laid out as the
    container stores' groups::

        <root>/<group>/<key>.nii[.gz]      e.g.  data/images/s0.nii.gz

    Volumes come channels-first (C, X, Y, Z): a 3D NIfTI gets a leading
    singleton channel, a 4D one's trailing axis becomes the channel axis.
    Shape and ``affine`` queries read headers only.
    """

    def __init__(self, path_data):
        self.path_data = Path(str(path_data))
        if not self.path_data.is_dir():
            raise FileNotFoundError(
                f"NiftiReader expects a directory of <group>/<key>.nii[.gz] volumes, "
                f"got {path_data!r}")

    def _path(self, group: str, key: str) -> Path:
        for suffix in (".nii.gz", ".nii"):
            p = self.path_data / group / f"{key}{suffix}"
            if p.exists():
                return p
        raise KeyError(f"no NIfTI volume {group}/{key}(.nii|.nii.gz) under {self.path_data}")

    @staticmethod
    def _to_channels_first_shape(shape: tuple) -> tuple:
        if len(shape) == 3:
            return (1, *shape)
        if len(shape) == 4:
            return (shape[3], *shape[:3])
        raise ValueError(f"NIfTI volumes must be 3D or 4D, got {len(shape)}D {shape}")

    def read(self, subject_keys, group, dtype=np.float16):
        from tpu_mednet_torch.utils.nifti import load_nifti

        for k in subject_keys:
            data, _ = load_nifti(self._path(group, k))
            if data.ndim == 3:
                data = data[None]
            elif data.ndim == 4:
                data = np.moveaxis(data, -1, 0)  # (X, Y, Z, C) -> (C, X, Y, Z)
            else:
                raise ValueError(
                    f"NIfTI volumes must be 3D or 4D, got {data.ndim}D ({group}/{k})")
            yield np.asarray(data, dtype=dtype)

    def get_data_shape(self, subject_keys, group):
        from tpu_mednet_torch.utils.nifti import read_nifti_header

        return {k: self._to_channels_first_shape(read_nifti_header(self._path(group, k))[0])
                for k in subject_keys}

    def get_data_attribute(self, subject_keys, group, attribute):
        if attribute != "affine":
            raise KeyError(
                f"NIfTI volumes carry only the 'affine' attribute, not {attribute!r}")
        from tpu_mednet_torch.utils.nifti import read_nifti_header

        return {k: read_nifti_header(self._path(group, k))[2] for k in subject_keys}

    def list_keys(self, group):
        keys = set()
        for p in (self.path_data / group).glob("*.nii*"):
            for suffix in (".nii.gz", ".nii"):
                if p.name.endswith(suffix):
                    keys.add(p.name[: -len(suffix)])
                    break
        return sorted(keys)

    def list_groups(self):
        return sorted(d.name for d in self.path_data.iterdir()
                      if d.is_dir() and next(d.glob("*.nii*"), None) is not None)


class MemoryReader(DataReader):
    """Reader over an in-memory ``{group: {key: array}}`` mapping.

    Backs tests, synthetic fixtures and the chip smoke run without touching
    disk.  Attributes live in ``attrs[group][key][name]``.
    """

    def __init__(self, store: Dict[str, Dict[str, np.ndarray]],
                 attrs: Optional[Dict[str, Dict[str, Dict[str, object]]]] = None):
        self.store = store
        self.attrs = attrs or {}

    def _node(self, group, k):
        try:
            return self.store[group][k]
        except KeyError:
            raise missing_subject_error(self, group, k) from None

    def read(self, subject_keys, group, dtype=np.float16):
        for k in subject_keys:
            yield np.asarray(self._node(group, k), dtype=dtype)

    def get_data_shape(self, subject_keys, group):
        return {k: self._node(group, k).shape for k in subject_keys}

    def get_data_attribute(self, subject_keys, group, attribute):
        default = np.eye(4)
        return {
            k: self.attrs.get(group, {}).get(k, {}).get(attribute, default)
            for k in subject_keys
        }

    def list_keys(self, group):
        return sorted(self.store[group].keys())

    def list_groups(self):
        return sorted(self.store.keys())


def read_single_volume(reader: DataReader, key: str, group: str) -> np.ndarray:
    """One subject's volume in its stored dtype (the host tools' idiom);
    raises the reader's ``KeyError`` for a missing key or group."""
    return np.asarray(next(iter(reader.read([key], group, dtype=None))))


def open_reader(path, reader_cls=None) -> DataReader:
    """Pick a reader by file suffix unless an explicit class is given."""
    if reader_cls is not None:
        return reader_cls(path)
    p = Path(str(path))
    if p.suffix in (".h5", ".hdf5", ".hdf"):
        return HDF5Reader(p)
    if p.suffix in (".zarr", ".zip"):
        return ZarrReader(p)
    if p.is_dir():
        # zarr markers win; .nii files one level into a group directory
        # select the NIfTI layout; loose top-level .nii files are refused;
        # other marker-less directories are zarr
        if (p / ".zgroup").exists() or (p / ".zarray").exists():
            return ZarrReader(p)
        if next(p.glob("*/*.nii*"), None) is not None:
            return NiftiReader(p)
        if next(p.glob("*.nii*"), None) is not None:
            raise ValueError(
                f"{path!s} holds loose .nii files at the top level; the NIfTI reader "
                "expects <root>/<group>/<key>.nii[.gz] — nest them in group "
                "directories (e.g. images/)")
        return ZarrReader(p)
    raise ValueError(f"cannot infer reader for {path!r}")
