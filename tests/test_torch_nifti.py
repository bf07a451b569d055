"""NIfTI in and out of the port, against the JAX package.

``save_nifti`` writes the same bytes as JAX's writer (for ``.nii.gz`` the
same decompressed bytes: the gzip header carries the write time), and each
package reads back what the other wrote; ``NiftiReader`` reads a
``<root>/<group>/<key>.nii[.gz]`` directory as JAX's does; a
``VolumeGroup`` saved to ``*.nii`` reads back with its affine; and
``python -m tpu_mednet_torch.utils.export`` writes the same file names
and voxels as JAX's ``export_to_nii``.  All exact.
"""

import gzip

import numpy as np
import pytest

from tpu_mednet.data import readers as jax_readers
from tpu_mednet.utils import nifti as jax_nifti
from tpu_mednet.utils.export import export_to_nii
from tpu_mednet_torch.data import NiftiReader, VolumeGroup, readers, zarrlite
from tpu_mednet_torch.utils import export, nifti

AFFINE = np.array([[-1.5, 0.0, 0.0, 90.0], [0.0, 1.25, 0.0, -120.5],
                   [0.0, 0.0, 2.0, 33.0], [0.0, 0.0, 0.0, 1.0]])


def _payload(path):
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype,shape", [(np.uint8, (5, 6, 7)), (np.float32, (4, 5, 6, 3)),
                                         (np.int16, (3, 4, 5)), (np.float16, (4, 3, 2)),
                                         (np.bool_, (2, 3, 4))])
def test_save_nifti_writes_jax_bytes_and_each_reads_the_other(tmp_path, suffix, dtype, shape):
    data = (np.random.default_rng(0).normal(size=shape) * 50).astype(dtype)
    ours, theirs = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    nifti.save_nifti(ours, data, AFFINE)
    jax_nifti.save_nifti(theirs, data, AFFINE)
    assert _payload(ours) == _payload(theirs)
    for got, want in ((nifti.load_nifti(theirs), jax_nifti.load_nifti(theirs)),
                      (jax_nifti.load_nifti(ours), nifti.load_nifti(ours))):
        assert got[0].dtype == want[0].dtype and got[0].tobytes() == want[0].tobytes()
        np.testing.assert_array_equal(got[1], want[1])
    shape_h, dtype_h, affine_h = nifti.read_nifti_header(ours)
    assert (shape_h, dtype_h) == jax_nifti.read_nifti_header(ours)[:2] == (
        shape, nifti.load_nifti(ours)[0].dtype)
    np.testing.assert_allclose(affine_h, AFFINE.astype(np.float32))


def test_affine_helpers_match_jax():
    direction, spacing, origin = np.eye(3)[[1, 0, 2]], (0.8, 0.9, 1.5), (-10.0, 20.0, 5.5)
    for name in ("lps_affine_from_meta", "ras_affine_from_meta"):
        np.testing.assert_array_equal(getattr(nifti, name)(direction, spacing, origin),
                                      getattr(jax_nifti, name)(direction, spacing, origin))
    with pytest.raises(ValueError, match="3D/4D"):
        nifti.save_nifti("unused.nii", np.zeros((2, 2)))


def _write_directory(root):
    rng = np.random.default_rng(1)
    for key, shape in (("s0", (9, 8, 7)), ("s1", (6, 10, 8))):
        nifti.save_nifti(root / "images" / f"{key}.nii",
                         rng.normal(size=(*shape, 4)).astype(np.float32), AFFINE)
        nifti.save_nifti(root / "labels" / f"{key}.nii.gz",
                         rng.integers(0, 3, size=shape).astype(np.uint8), np.eye(4))


def test_nifti_reader_matches_jax(tmp_path):
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    (tmp_path / "notes").mkdir()
    _write_directory(tmp_path)
    ours, theirs = readers.open_reader(tmp_path), jax_readers.open_reader(tmp_path)
    assert isinstance(ours, NiftiReader) and isinstance(theirs, jax_readers.NiftiReader)
    assert ours.list_groups() == theirs.list_groups() == ["images", "labels"]
    keys = ours.list_keys("images")
    assert keys == theirs.list_keys("images") == ["s0", "s1"]
    for group, dtype in (("images", np.float16), ("labels", None)):
        assert ours.get_data_shape(keys, group) == theirs.get_data_shape(keys, group)
        for got, want in zip(ours.read(keys, group, dtype=dtype),
                             theirs.read(keys, group, dtype=dtype)):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        for k in keys:
            np.testing.assert_array_equal(ours.get_data_attribute(keys, group, "affine")[k],
                                          theirs.get_data_attribute(keys, group, "affine")[k])
    assert ours.get_data_shape(["s0"], "images")["s0"] == (4, 9, 8, 7)
    with pytest.raises(KeyError, match="only the 'affine'"):
        ours.get_data_attribute(keys, "images", "spacing")
    with pytest.raises(KeyError, match="no NIfTI volume"):
        next(ours.read(["s9"], "images"))


def test_volume_group_saves_nifti_that_both_packages_read(tmp_path):
    group = VolumeGroup()
    mask = np.random.default_rng(2).integers(0, 4, size=(1, 7, 6, 5)).astype(np.uint8)
    group.require_dataset("a", mask.shape, np.uint8)[:] = mask
    group["a"].attrs["affine"] = AFFINE.tolist()
    heat = np.random.default_rng(3).integers(0, 255, size=(3, 7, 6, 5)).astype(np.uint8)
    group.require_dataset("b", heat.shape, np.uint8)[:] = heat
    group.save(tmp_path / "pred.nii", group="prediction")
    for reader in (readers.open_reader(tmp_path / "pred.nii"),
                   jax_readers.open_reader(tmp_path / "pred.nii")):
        assert reader.list_keys("prediction") == ["a", "b"]
        a, b = reader.read(["a", "b"], "prediction", dtype=None)
        assert a.tobytes() == mask.tobytes() and b.tobytes() == heat.tobytes()
        affines = reader.get_data_attribute(["a", "b"], "prediction", "affine")
        np.testing.assert_allclose(affines["a"], AFFINE.astype(np.float32))
        np.testing.assert_array_equal(affines["b"], np.eye(4))


def _write_store(path):
    z = zarrlite.open(str(path), mode="w")
    rng = np.random.default_rng(4)
    for key in ("k0", "k1", "k2"):
        arr = z.require_group("prediction").create_dataset(
            key, data=rng.integers(0, 200, size=(3, 6, 5, 4)).astype(np.uint8))
        arr.attrs["affine"] = AFFINE.tolist()


@pytest.mark.parametrize("flags", [
    [],
    ["--dtype", "int"],
    ["--sum_channels", "--select_channels", "heatmaps"],
    ["--sum_channels", "--select_channels", "MASK", "--dtype", "int"],
    ["--sum_channels", "--test_keys", "keys.txt"],
], ids=["channels", "int", "sum-heatmaps", "sum-mask-int", "sum-all-keyfile"])
def test_export_writes_what_jax_export_to_nii_writes(tmp_path, flags, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_store(tmp_path / "pred.zarr")
    (tmp_path / "keys.txt").write_text("k2\nk0\n")
    argv = ["--data_path", str(tmp_path / "pred.zarr"), "--data_group", "prediction", *flags]
    assert export.main([*argv, "--export_dir", "ours"]) == 0
    export_to_nii.main([*argv, "--export_dir", "theirs"], standalone_mode=False)
    ours = sorted(p.relative_to(tmp_path / "ours") for p in (tmp_path / "ours").rglob("*.nii.gz"))
    theirs = sorted(p.relative_to(tmp_path / "theirs")
                    for p in (tmp_path / "theirs").rglob("*.nii.gz"))
    assert ours == theirs and len(ours) >= 2
    for rel in ours:
        assert _payload(tmp_path / "ours" / rel) == _payload(tmp_path / "theirs" / rel)
    with pytest.raises(SystemExit):
        export.main(["--data_path", "x.txt", "--export_dir", "ours"])
