"""Volume readers: the port's own copy of the in-memory reader.

Copied from ``tpu_mednet/data/readers.py`` (``DataReader``,
``MemoryReader``, ``missing_subject_error``, ``open_reader``), since the
port imports nothing of the JAX package.  Volumes are channels-first
(C, X, Y, Z) arrays.  The HDF5, zarr and NIfTI readers are not ported
yet: ``open_reader`` raises for a file path unless a reader class is given.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

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
        raise NotImplementedError

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


def open_reader(path, reader_cls=None) -> DataReader:
    """Open ``path`` with ``reader_cls``; file readers are not ported yet."""
    if reader_cls is not None:
        return reader_cls(path)
    raise NotImplementedError(
        f"cannot open {path!r}: the HDF5/zarr/NIfTI readers are not yet ported "
        "to tpu_mednet_torch; pass reader=MemoryReader(...) or a reader_cls"
    )
