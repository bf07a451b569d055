"""The port's zarr/HDF5 stores and readers against the JAX package's.

Stores written by either package's ``zarrlite`` (directory and zip stores;
zlib, gzip and uncompressed chunks; partial edge chunks; attrs) read back
byte-equal in the other, file for file; ``VolumeGroup.save`` of either
package is read by the other's reader, to zarr and to HDF5.
"""

import numpy as np
import pytest

from tpu_mednet.data import readers as jax_readers
from tpu_mednet.data import zarrlite as jax_zarrlite
from tpu_mednet.data.stores import VolumeGroup as JaxVolumeGroup
from tpu_mednet_torch.data import readers, zarrlite
from tpu_mednet_torch.data.stores import VolumeGroup

ARRAYS = {
    "f32": (np.float32, (2, 7, 5, 6), (1, 4, 5, 3)),
    "f16": (np.float16, (1, 9, 8, 7), None),
    "u8": (np.uint8, (1, 5, 6, 7), (1, 2, 3, 4)),
    "i16": (np.int16, (3, 4, 5), (2, 2, 2)),
}


def _arrays():
    rng = np.random.default_rng(0)
    out = {}
    for name, (dtype, shape, chunks) in ARRAYS.items():
        a = rng.normal(0, 40, size=shape)
        out[name] = (a.astype(dtype), chunks)
    return out


def _write(lib, path, compressor):
    root = lib.open(str(path), mode="w")
    g = root.require_group("images")
    for name, (a, chunks) in _arrays().items():
        arr = g.create_dataset(name, data=a, chunks=chunks, compressor=compressor)
        arr.attrs["affine"] = np.diag([1.5, 2.0, 2.5, 1.0])
        arr.attrs["note"] = {"name": name, "shape": list(a.shape)}
    root.attrs["source"] = "test"
    root.store.close()


def _without_gzip_mtime(data: bytes) -> bytes:
    """A gzip member's header holds the time it was written (bytes 4-7);
    two writes a second apart differ there and nowhere else."""
    if data[:2] == b"\x1f\x8b":
        return data[:4] + bytes(4) + data[8:]
    return data


def _files(path):
    if path.suffix == ".zip":
        import zipfile

        with zipfile.ZipFile(path) as zf:
            return {n: _without_gzip_mtime(zf.read(n)) for n in zf.namelist()}
    return {str(p.relative_to(path)): _without_gzip_mtime(p.read_bytes())
            for p in path.rglob("*") if p.is_file()}


@pytest.mark.parametrize("compressor", ["default", {"id": "gzip", "level": 3}, None],
                         ids=["zlib", "gzip", "raw"])
@pytest.mark.parametrize("suffix", [".zarr", ".zip"])
@pytest.mark.parametrize("writer,reader", [(jax_zarrlite, zarrlite), (zarrlite, jax_zarrlite)],
                         ids=["jax-to-port", "port-to-jax"])
def test_stores_read_back_byte_equal(tmp_path, compressor, suffix, writer, reader):
    path = tmp_path / f"store{suffix}"
    _write(writer, path, compressor)
    other = tmp_path / f"other{suffix}"
    _write(reader, other, compressor)
    assert _files(path) == _files(other)  # the two copies write the same bytes
    root = reader.open(str(path), mode="r")
    assert root.attrs["source"] == "test"
    assert sorted(root["images"].keys()) == sorted(ARRAYS)
    for name, (a, chunks) in _arrays().items():
        got = root["images"][name]
        assert got.shape == a.shape and got.dtype == a.dtype
        assert got[:].tobytes() == a.tobytes()
        np.testing.assert_array_equal(np.asarray(got.attrs["affine"]),
                                      np.diag([1.5, 2.0, 2.5, 1.0]))
        assert got.attrs["note"] == {"name": name, "shape": list(a.shape)}
    root.store.close()


def _group(lib_group):
    g = lib_group()
    rng = np.random.default_rng(1)
    for key, shape in (("s0", (1, 6, 5, 4)), ("s1", (2, 3, 4, 5))):
        ds = g.require_dataset(key, shape, np.uint8)
        ds[:] = rng.integers(0, 4, size=shape, dtype=np.uint8)
        ds.attrs["affine"] = np.diag([2.0, 2.0, 2.0, 1.0]).tolist()
    return g


@pytest.mark.parametrize("suffix", [".zarr", ".zip", ".h5"])
@pytest.mark.parametrize("writer,reader", [(JaxVolumeGroup, readers),
                                           (VolumeGroup, jax_readers)],
                         ids=["jax-to-port", "port-to-jax"])
def test_volume_group_save_reads_back(tmp_path, suffix, writer, reader):
    group = _group(writer)
    path = tmp_path / f"pred{suffix}"
    group.save(path, group="prediction")
    group.save(path, group="prediction")  # saving twice overwrites
    with reader.open_reader(path) as r:
        assert r.list_groups() == ["prediction"]
        assert r.list_keys("prediction") == ["s0", "s1"]
        shapes = r.get_data_shape(["s0", "s1"], "prediction")
        affines = r.get_data_attribute(["s0", "s1"], "prediction", "affine")
        for key, got in zip(["s0", "s1"], r.read(["s0", "s1"], "prediction", dtype=np.uint8)):
            want = np.asarray(group[key])
            assert tuple(shapes[key]) == want.shape
            assert got.tobytes() == want.tobytes()
            np.testing.assert_array_equal(np.asarray(affines[key]),
                                          np.diag([2.0, 2.0, 2.0, 1.0]))


def test_readers_route_by_suffix_and_refuse_what_waits(tmp_path, monkeypatch):
    _group(VolumeGroup).save(tmp_path / "p.zarr", group="g")
    assert isinstance(readers.open_reader(tmp_path / "p.zarr"), readers.ZarrReader)
    nii = tmp_path / "nii" / "images"
    nii.mkdir(parents=True)
    (nii / "s0.nii.gz").write_bytes(b"")
    assert isinstance(readers.open_reader(tmp_path / "nii"), readers.NiftiReader)
    (tmp_path / "loose").mkdir()
    (tmp_path / "loose" / "s0.nii").write_bytes(b"")
    with pytest.raises(ValueError, match="loose .nii files"):
        readers.open_reader(tmp_path / "loose")
    _group(VolumeGroup).save(tmp_path / "out.nii")
    assert sorted(p.name for p in (tmp_path / "out.nii").iterdir()) == ["s0.nii.gz", "s1.nii.gz"]
    with pytest.raises(ValueError, match="cannot infer"):
        readers.open_reader(tmp_path / "missing.txt")
    with readers.open_reader(tmp_path / "p.zarr") as r, pytest.raises(KeyError, match="stale"):
        next(r.read(["nope"], "g"))
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)  # as on the card
    with pytest.raises(ImportError, match="zarr store"):
        readers.open_reader(tmp_path / "p.h5")
    with pytest.raises(ImportError, match="zarr store"):
        _group(VolumeGroup).save(tmp_path / "p.h5")


def test_read_data_to_memory_casts(tmp_path):
    _group(VolumeGroup).save(tmp_path / "p.zarr", group="g")
    with readers.open_reader(tmp_path / "p.zarr") as r:
        loaded = r.read_data_to_memory(["s0", "s1"], "g", dtype=np.float32)
        assert [a.dtype for a in loaded] == [np.float32, np.float32]
        assert loaded[1].shape == (2, 3, 4, 5)
