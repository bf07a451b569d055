"""zarrlite: a minimal, stdlib-only zarr **v2** store implementation.

The port's own copy of ``tpu_mednet/data/zarrlite.py`` (the port imports
nothing of the JAX package): the zarr v2 on-disk format
(https://zarr-specs.readthedocs.io/en/latest/v2/v2.0.html) in the standard
library and numpy, so the zarr reader and ``VolumeGroup.to_zarr`` run
without the ``zarr`` package.  Stores written by either copy, or by real
zarr with the ``zlib``/``gzip``/``null`` compressors, read back byte-equal
in the others.

Only the API subset the package uses: ``open``, ``Group``
(getitem/setitem/iter/contains/require_group/create_dataset/attrs),
``Array`` (shape/dtype/attrs/basic indexing), ``ZipStore``.  Fancy
indexing, filters, object dtypes, v3 and blosc are out of scope;
blosc-compressed chunks raise with a clear message.  Modules that need
zarr import the real package first and fall back to this one.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
import zipfile
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

ZARR_FORMAT = 2
DEFAULT_COMPRESSOR = {"id": "zlib", "level": 1}

_ARRAY_META = ".zarray"
_GROUP_META = ".zgroup"
_ATTRS_KEY = ".zattrs"


# --------------------------------------------------------------------------
# JSON helpers: fill_value / attrs encoding per the v2 spec
# --------------------------------------------------------------------------

def _encode_fill_value(value, dtype: np.dtype):
    """JSON-encode a fill value (spec: NaN/Infinity as strings)."""
    if value is None:
        return None
    if dtype.kind == "f":
        v = float(value)
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    if dtype.kind in "ui":
        return int(value)
    if dtype.kind == "b":
        return bool(value)
    raise ValueError(f"unsupported dtype for fill_value: {dtype}")


def _decode_fill_value(value, dtype: np.dtype):
    if value is None:
        return None
    if isinstance(value, str):
        if value == "NaN":
            return dtype.type(np.nan)
        if value == "Infinity":
            return dtype.type(np.inf)
        if value == "-Infinity":
            return dtype.type(-np.inf)
        raise ValueError(f"unsupported fill_value string {value!r}")
    return dtype.type(value)


def _jsonify(obj):
    """Best-effort conversion of attr values to JSON-serializable form."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    return obj


# --------------------------------------------------------------------------
# Compressors (numcodecs-compatible ids)
# --------------------------------------------------------------------------

def _compress(raw: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.compress(raw, compressor.get("level", 1))
    if cid == "gzip":
        return gzip.compress(raw, compresslevel=compressor.get("level", 1))
    raise RuntimeError(
        f"zarrlite cannot write compressor {cid!r}; use zlib/gzip/null "
        "or install the real zarr package"
    )


def _decompress(buf: bytes, compressor: Optional[dict]) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(buf)
    if cid == "gzip":
        return gzip.decompress(buf)
    raise RuntimeError(
        f"zarrlite cannot read compressor {cid!r} (chunk needs the real "
        "zarr package / numcodecs)"
    )


# --------------------------------------------------------------------------
# Stores: flat key -> bytes mappings
# --------------------------------------------------------------------------

class DirectoryStore:
    """Keys are ``/``-separated paths mapped to files under ``root``."""

    writable = True

    def __init__(self, root):
        self.root = Path(str(root))

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if self.root.resolve() not in p.parents and p != self.root.resolve():
            raise KeyError(f"key escapes store root: {key!r}")
        return p

    def __getitem__(self, key: str) -> bytes:
        p = self._path(key)
        if not p.is_file():
            raise KeyError(key)
        return p.read_bytes()

    def __setitem__(self, key: str, value: bytes) -> None:
        if not self.writable:
            raise OSError("store opened read-only")
        p = self._path(key)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(value)

    def __delitem__(self, key: str) -> None:
        if not self.writable:
            raise OSError("store opened read-only")
        p = self._path(key)
        if p.is_file():
            p.unlink()
        elif p.is_dir():
            shutil.rmtree(p)
        else:
            raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return self._path(key).is_file()

    def listdir(self, prefix: str = "") -> List[str]:
        p = self._path(prefix) if prefix else self.root
        if not p.is_dir():
            return []
        return sorted(c.name for c in p.iterdir())

    def rmdir(self, prefix: str = "") -> None:
        if not self.writable:
            raise OSError("store opened read-only")
        p = self._path(prefix) if prefix else self.root
        if p.is_dir():
            shutil.rmtree(p)

    def close(self) -> None:
        pass


class ZipStore:
    """zarr-v2-compatible zip store (read, and append-style write).

    Matches real zarr's ``ZipStore`` layout: store keys are member names.
    Rewriting an existing key appends a duplicate member; like the real
    implementation, the last-written member wins on read (``zipfile``
    keeps the final entry per name in ``NameToInfo``).
    """

    def __init__(self, path, mode: str = "r", compression=zipfile.ZIP_STORED):
        self.path = str(path)
        self.mode = mode
        self.writable = mode in ("w", "a", "x")
        self._zf = zipfile.ZipFile(self.path, mode=mode, compression=compression)

    def __getitem__(self, key: str) -> bytes:
        try:
            return self._zf.read(key)
        except KeyError:
            raise KeyError(key)

    def __setitem__(self, key: str, value: bytes) -> None:
        if not self.writable:
            raise OSError("ZipStore opened read-only")
        import warnings

        with warnings.catch_warnings():
            # rewriting a key appends a duplicate member (last wins — the
            # documented semantic here and in real zarr); zipfile's
            # 'Duplicate name' UserWarning is just noise for that
            warnings.filterwarnings("ignore", message="Duplicate name")
            self._zf.writestr(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._zf.NameToInfo

    def listdir(self, prefix: str = "") -> List[str]:
        prefix = prefix.strip("/")
        if prefix:
            prefix += "/"
        children = set()
        for name in self._zf.namelist():
            if not name.startswith(prefix):
                continue
            rest = name[len(prefix):]
            if rest:
                children.add(rest.split("/", 1)[0])
        return sorted(children)

    def close(self) -> None:
        self._zf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# Attributes (.zattrs), persisted on every mutation like real zarr
# --------------------------------------------------------------------------

class Attributes:
    def __init__(self, store, prefix: str):
        self._store = store
        self._key = f"{prefix}{_ATTRS_KEY}" if not prefix else f"{prefix}/{_ATTRS_KEY}"

    def _load(self) -> dict:
        try:
            return json.loads(self._store[self._key].decode())
        except KeyError:
            return {}

    def _save(self, d: dict) -> None:
        self._store[self._key] = json.dumps(d, indent=1).encode()

    def __getitem__(self, name):
        return self._load()[name]

    def __setitem__(self, name, value):
        d = self._load()
        d[name] = _jsonify(value)
        self._save(d)

    def __delitem__(self, name):
        d = self._load()
        del d[name]
        self._save(d)

    def __contains__(self, name):
        return name in self._load()

    def get(self, name, default=None):
        return self._load().get(name, default)

    def update(self, other=(), **kw):
        d = self._load()
        d.update({k: _jsonify(v) for k, v in dict(other, **kw).items()})
        self._save(d)

    def keys(self):
        return self._load().keys()

    def items(self):
        return self._load().items()

    def asdict(self) -> dict:
        return self._load()

    def __iter__(self):
        return iter(self._load())

    def __len__(self):
        return len(self._load())


# --------------------------------------------------------------------------
# Array
# --------------------------------------------------------------------------

def _join(prefix: str, name: str) -> str:
    name = name.strip("/")
    return f"{prefix}/{name}" if prefix else name


class Array:
    """A zarr v2 array: ``.zarray`` metadata + chunk objects in a store.

    Reads decode only once (full materialization, cached) — this is a
    correctness shim for datasets that fit in host RAM, not an
    out-of-core engine; medical volumes here are hundreds of MB at most.
    """

    def __init__(self, store, path: str):
        self._store = store
        self.path = path
        meta_key = _join(path, _ARRAY_META)
        self._meta = json.loads(store[meta_key].decode())
        if self._meta.get("zarr_format") != ZARR_FORMAT:
            raise ValueError(
                f"unsupported zarr_format {self._meta.get('zarr_format')!r}"
            )
        if self._meta.get("filters"):
            raise RuntimeError("zarrlite does not support filters")
        self.shape: Tuple[int, ...] = tuple(self._meta["shape"])
        self.chunks: Tuple[int, ...] = tuple(self._meta["chunks"])
        self.dtype = np.dtype(self._meta["dtype"])
        self.order: str = self._meta.get("order", "C")
        self.compressor: Optional[dict] = self._meta.get("compressor")
        self.fill_value = _decode_fill_value(
            self._meta.get("fill_value"), self.dtype
        )
        self._sep: str = self._meta.get("dimension_separator", ".")
        self.attrs = Attributes(store, path)
        self._cache: Optional[np.ndarray] = None

    # -- geometry ----------------------------------------------------------

    @property
    def store(self):
        """The backing store (real-zarr v2 API compat)."""
        return self._store

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def _grid(self) -> Iterator[Tuple[int, ...]]:
        counts = [max(1, -(-s // c)) for s, c in zip(self.shape, self.chunks)]
        if not counts:
            yield ()
            return
        yield from np.ndindex(*counts)

    def _chunk_key(self, idx: Tuple[int, ...]) -> str:
        name = self._sep.join(map(str, idx)) if idx else "0"
        return _join(self.path, name)

    # -- read --------------------------------------------------------------

    def _materialize(self) -> np.ndarray:
        if self._cache is not None:
            return self._cache
        fill = self.fill_value if self.fill_value is not None else 0
        out = np.full(self.shape, fill, dtype=self.dtype)
        for idx in self._grid():
            key = self._chunk_key(idx)
            try:
                buf = self._store[key]
            except KeyError:
                continue  # missing chunk == fill_value
            raw = _decompress(buf, self.compressor)
            chunk = np.frombuffer(raw, dtype=self.dtype)
            chunk = chunk.reshape(self.chunks, order=self.order)
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            crop = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            out[sel] = chunk[crop]
        self._cache = out
        return out

    def __getitem__(self, sel):
        return self._materialize()[sel]

    def __array__(self, dtype=None, copy=None):
        a = self._materialize()
        return np.asarray(a, dtype=dtype) if dtype is not None else a

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    # -- write -------------------------------------------------------------

    def __setitem__(self, sel, value):
        if not getattr(self._store, "writable", False):
            raise OSError("store is read-only")
        full = np.array(self._materialize())  # copy: cache must not alias
        full[sel] = value
        self._write_full(full)
        self._cache = full

    def _write_full(self, data: np.ndarray) -> None:
        data = np.asarray(data, dtype=self.dtype)
        fill = self.fill_value if self.fill_value is not None else 0
        for idx in self._grid():
            sel = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            block = data[sel]
            if block.shape != self.chunks:
                padded = np.full(self.chunks, fill, dtype=self.dtype)
                padded[tuple(slice(0, e) for e in block.shape)] = block
                block = padded
            # serialize in the array's declared order: reads reshape with
            # order=self.order, so a C-order dump into an 'F' array would
            # silently transpose-scramble the chunk on the next read
            raw = block.tobytes(order=self.order)
            self._store[self._chunk_key(idx)] = _compress(raw, self.compressor)


def _create_array(
    store,
    path: str,
    data: Optional[np.ndarray] = None,
    shape: Optional[Sequence[int]] = None,
    dtype=None,
    chunks: Optional[Sequence[int]] = None,
    fill_value=0,
    compressor: Optional[dict] = "default",
    overwrite: bool = False,
) -> Array:
    meta_key = _join(path, _ARRAY_META)
    shadow_attrs = False
    if meta_key in store or _join(path, _GROUP_META) in store:
        if not overwrite:
            raise ValueError(
                f"array or group exists at {path!r} (pass overwrite=True)"
            )
        # the previous node's chunk/attr/child objects MUST go: under a new
        # .zarray they would be decoded as data (stale-chunk resurrection).
        # DirectoryStore deletes the subtree; ZipStore cannot delete, but a
        # full-data write shadows every chunk key (duplicate member, last
        # wins), so overwrite-with-data is still safe there — the old
        # .zattrs member must be shadowed too, or the new array would
        # resurrect the previous array's attributes.
        if hasattr(store, "rmdir"):
            store.rmdir(path)
        elif data is None:
            raise ValueError(
                f"cannot overwrite {path!r} without data= on a store that "
                "cannot delete (ZipStore): stale chunks would be read back "
                "as garbage under the new metadata"
            )
        else:
            shadow_attrs = True
    if data is not None:
        data = np.asarray(data, dtype=dtype)
        shape, dtype = data.shape, data.dtype
    if shape is None or dtype is None:
        raise ValueError("need data= or both shape= and dtype=")
    shape = tuple(int(s) for s in shape)
    dtype = np.dtype(dtype)
    if dtype.kind not in "fuib":
        raise ValueError(f"zarrlite supports numeric/bool dtypes, not {dtype}")
    chunks = tuple(int(c) for c in (chunks or shape))
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"bad chunks {chunks} for shape {shape}")
    if compressor == "default":
        compressor = DEFAULT_COMPRESSOR
    meta = {
        "zarr_format": ZARR_FORMAT,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": dtype.str,
        "compressor": compressor,
        "fill_value": _encode_fill_value(fill_value, dtype),
        "order": "C",
        "filters": None,
        "dimension_separator": ".",
    }
    store[meta_key] = json.dumps(meta, indent=1).encode()
    if shadow_attrs:
        store[_join(path, _ATTRS_KEY)] = b"{}"
    arr = Array(store, path)
    if data is not None:
        arr._write_full(data)
        arr._cache = np.array(data)
    return arr


# --------------------------------------------------------------------------
# Group
# --------------------------------------------------------------------------

class Group:
    """A zarr v2 group: ``.zgroup`` marker + children in a store."""

    def __init__(self, store, path: str = ""):
        self._store = store
        self.path = path
        self.attrs = Attributes(store, path)

    @property
    def store(self):
        """The backing store (real-zarr v2 API compat)."""
        return self._store

    # -- resolution --------------------------------------------------------

    def _abs(self, name: str) -> str:
        return _join(self.path, name)

    def __getitem__(self, name: str):
        p = self._abs(name)
        if _join(p, _ARRAY_META) in self._store:
            return Array(self._store, p)
        if _join(p, _GROUP_META) in self._store:
            return Group(self._store, p)
        raise KeyError(name)

    def __setitem__(self, name: str, value) -> None:
        self.create_dataset(name, data=np.asarray(value), overwrite=True)

    def __contains__(self, name: str) -> bool:
        p = self._abs(name)
        return (_join(p, _ARRAY_META) in self._store
                or _join(p, _GROUP_META) in self._store)

    def __iter__(self) -> Iterator[str]:
        for child in self._store.listdir(self.path):
            if child.startswith("."):
                continue
            if _join(self._abs(child), _ARRAY_META) in self._store or \
               _join(self._abs(child), _GROUP_META) in self._store:
                yield child

    def keys(self):
        return list(self)

    def array_keys(self):
        return [k for k in self
                if _join(self._abs(k), _ARRAY_META) in self._store]

    def group_keys(self):
        return [k for k in self
                if _join(self._abs(k), _GROUP_META) in self._store]

    def __len__(self) -> int:
        # count via __iter__ directly: list(self) would call __len__ as a
        # length hint and recurse
        return sum(1 for _ in self.__iter__())

    # -- creation ----------------------------------------------------------

    def _require_parents(self, name: str) -> str:
        """Create .zgroup markers for every intermediate path segment."""
        parts = name.strip("/").split("/")
        cur = self.path
        for part in parts[:-1]:
            cur = _join(cur, part)
            marker = _join(cur, _GROUP_META)
            if marker not in self._store:
                self._store[marker] = json.dumps(
                    {"zarr_format": ZARR_FORMAT}).encode()
        return _join(self.path, name.strip("/"))

    def require_group(self, name: str) -> "Group":
        p = self._require_parents(name)
        if _join(p, _ARRAY_META) in self._store:
            raise ValueError(f"array exists at {name!r}")
        marker = _join(p, _GROUP_META)
        if marker not in self._store:
            if not getattr(self._store, "writable", False):
                raise OSError("store is read-only")
            self._store[marker] = json.dumps({"zarr_format": ZARR_FORMAT}).encode()
        return Group(self._store, p)

    create_group = require_group

    def create_dataset(self, name: str, data=None, shape=None, dtype=None,
                       chunks=None, fill_value=0, compressor="default",
                       overwrite: bool = False) -> Array:
        if not getattr(self._store, "writable", False):
            raise OSError("store is read-only")
        p = self._require_parents(name)
        return _create_array(
            self._store, p, data=data, shape=shape, dtype=dtype,
            chunks=chunks, fill_value=fill_value, compressor=compressor,
            overwrite=overwrite,
        )

    create_array = create_dataset

    def close(self) -> None:
        self._store.close()


# --------------------------------------------------------------------------
# open()
# --------------------------------------------------------------------------

def open(path=None, mode: str = "r", store=None):  # noqa: A001 (zarr API name)
    """Open a zarr v2 hierarchy — ``zarr.open`` lookalike.

    ``path`` may be a directory store path or a ``.zip`` (ZipStore, like
    real zarr's suffix routing).  Returns the root ``Array`` if the root
    carries ``.zarray``, else the root ``Group`` (created under
    ``w``/``a``/implicitly for fresh stores).
    """
    if store is None:
        if path is None:
            raise ValueError("need path or store")
        p = Path(str(path))
        if p.suffix == ".zip":
            zmode = {"r": "r", "w": "w", "a": "a", "x": "x"}[mode]
            if zmode == "a" and not p.exists():
                zmode = "w"
            store = ZipStore(p, mode=zmode)
        else:
            if mode == "r" and not p.is_dir():
                raise FileNotFoundError(f"no zarr store at {path}")
            if mode == "w" and p.exists():
                shutil.rmtree(p)
            if mode in ("w", "a", "x"):
                p.mkdir(parents=True, exist_ok=True)
            store = DirectoryStore(p)
    if mode == "r":
        store.writable = False

    if _ARRAY_META in store:
        return Array(store, "")
    if _GROUP_META in store:
        return Group(store, "")
    if mode == "r":
        # tolerate marker-less stores that still contain children (some
        # writers omit the root .zgroup); otherwise fail loudly
        if store.listdir(""):
            return Group(store, "")
        raise KeyError(f"no zarr array or group at {path!r}")
    store[_GROUP_META] = json.dumps({"zarr_format": ZARR_FORMAT}).encode()
    return Group(store, "")


def open_group(path=None, mode: str = "r", store=None) -> Group:
    g = open(path, mode=mode, store=store)
    if not isinstance(g, Group):
        raise ValueError(f"{path!r} is an array, not a group")
    return g
