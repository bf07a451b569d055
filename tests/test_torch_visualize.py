"""``python -m tpu_mednet_torch.cli.visualize`` against the JAX package's ``mednet-visualize``.

The cases of ``tests/test_visualize.py``, each run through both CLIs on
the same HDF5 (and zarr) stores: the same exit codes, messages, warnings
and figure files, byte for byte (the same matplotlib calls on the same
arrays).
"""

import logging

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
pytest.importorskip("matplotlib")

from tpu_mednet.cli import visualize as jax_visualize  # noqa: E402
from tpu_mednet_torch.cli import visualize  # noqa: E402
from tpu_mednet_torch.data import zarrlite  # noqa: E402


def _write_group(f, group, key, arr):
    ds = f.create_dataset(f"{group}/{key}", data=arr)
    ds.attrs["affine"] = np.eye(4)


@pytest.fixture()
def seg_stores(tmp_path):
    rng = np.random.default_rng(0)
    data, pred = tmp_path / "data.h5", tmp_path / "pred.h5"
    with h5py.File(data, "w") as f:
        for key in ("s0", "s1"):
            _write_group(f, "images", key, rng.normal(size=(1, 12, 12, 12)).astype(np.float16))
            lbl = np.zeros((1, 12, 12, 12), np.uint8)
            lbl[0, 3:9, 3:9, 3:9] = 1
            _write_group(f, "labels", key, lbl)
    with h5py.File(pred, "w") as f:
        for key in ("s0", "s1"):
            p = np.zeros((1, 12, 12, 12), np.uint8)
            p[0, 4:10, 3:9, 3:9] = 1
            _write_group(f, "prediction", key, p)
    return data, pred


def both(tmp_path, argv, caplog=None, capsys=None):
    """Run both CLIs with ``--out`` in their own directories; return each
    one's (exit code, {file name: bytes}, warnings, stdout)."""
    out = []
    for name, main in (("jax", jax_visualize.main), ("port", visualize.main)):
        figs = tmp_path / f"figs_{name}"
        if caplog is not None:
            caplog.clear()
        rc = main([*argv, "--out", str(figs)])
        warnings = [r.getMessage() for r in caplog.records
                    if r.levelno >= logging.WARNING] if caplog is not None else []
        stdout = capsys.readouterr().out.replace(str(figs), "<out>") if capsys else ""
        files = {p.name: p.read_bytes() for p in sorted(figs.glob("*"))} if figs.exists() else {}
        out.append((rc, files, warnings, stdout))
    return out


def assert_same(results, names):
    (jrc, jfiles, jwarn, jout), (rc, files, warn, out) = results
    assert rc == jrc == 0
    assert sorted(files) == sorted(jfiles) == sorted(names)
    for name in files:
        assert files[name] == jfiles[name], name
    assert warn == jwarn and out == jout


def test_seg_overlays(seg_stores, tmp_path, capsys):
    data, pred = seg_stores
    results = both(tmp_path, ["--data", str(data), "--pred", str(pred)], capsys=capsys)
    assert_same(results, ["s0_images.png", "s0_labels.png", "s1_images.png", "s1_labels.png"])
    assert "wrote 4 figures" in results[1][3]


def test_landmark_heatmaps_auto_detected(tmp_path):
    rng = np.random.default_rng(1)
    data, pred = tmp_path / "data.h5", tmp_path / "pred.h5"
    with h5py.File(data, "w") as f:
        _write_group(f, "images", "s0", rng.normal(size=(1, 10, 10, 10)).astype(np.float16))
        _write_group(f, "labels", "s0", np.zeros((1, 10, 10, 10), np.uint8))
        hm = np.zeros((2, 10, 10, 10), np.uint8)
        hm[0, 2, 2, 2] = 255
        hm[1, 7, 7, 7] = 255
        _write_group(f, "heatmaps", "s0", hm)
    with h5py.File(pred, "w") as f:
        pvol = np.zeros((3, 10, 10, 10), np.uint8)
        pvol[0, 3, 2, 2] = 255
        pvol[1, 7, 6, 7] = 255
        _write_group(f, "prediction", "s0", pvol)
    assert_same(both(tmp_path, ["--data", str(data), "--pred", str(pred)]),
                ["s0_heatmaps.png", "s0_images.png", "s0_labels.png"])


@pytest.mark.parametrize("which", ["pred", "data"])
def test_pred_only_and_data_only(seg_stores, tmp_path, which):
    data, pred = seg_stores
    argv = ["--pred", str(pred)] if which == "pred" else ["--data", str(data)]
    names = (["s0_labels.png", "s1_labels.png"] if which == "pred" else
             ["s0_images.png", "s0_labels.png", "s1_images.png", "s1_labels.png"])
    assert_same(both(tmp_path, argv), names)


def test_subject_subset_and_missing_key(seg_stores, tmp_path, caplog):
    data, pred = seg_stores
    keyfile = tmp_path / "keys.txt"
    keyfile.write_text("s1\nmissing\n")
    with caplog.at_level(logging.WARNING):
        results = both(tmp_path, ["--data", str(data), "--pred", str(pred), "--subjects",
                                  str(keyfile)], caplog=caplog)
    assert_same(results, ["s1_images.png", "s1_labels.png"])
    assert any("missing" in w for w in results[1][2])


def test_requires_some_input(tmp_path):
    for main in (jax_visualize.main, visualize.main):
        with pytest.raises(SystemExit, match="at least one of --data / --pred"):
            main(["--out", str(tmp_path / "figs")])


def test_seg_prediction_skips_auto_gt_heatmaps(seg_stores, tmp_path):
    data, pred = seg_stores
    with h5py.File(data, "a") as f:
        hm = np.zeros((2, 12, 12, 12), np.uint8)
        hm[0, 3, 3, 3] = 255
        _write_group(f, "heatmaps", "s0", hm)
        _write_group(f, "heatmaps", "s1", hm)
    names = ["s0_images.png", "s0_labels.png", "s1_images.png", "s1_labels.png"]
    assert_same(both(tmp_path / "auto", ["--data", str(data), "--pred", str(pred)]), names)
    assert_same(both(tmp_path / "explicit", ["--data", str(data), "--pred", str(pred),
                                             "--heatmap_group", "heatmaps"]),
                names + ["s0_heatmaps.png", "s1_heatmaps.png"])


def test_heatmap_channel_mismatch_renders_pred_only(tmp_path, caplog):
    rng = np.random.default_rng(2)
    data, pred = tmp_path / "data.h5", tmp_path / "pred.h5"
    with h5py.File(data, "w") as f:
        _write_group(f, "images", "s0", rng.normal(size=(1, 10, 10, 10)).astype(np.float16))
        _write_group(f, "heatmaps", "s0", np.zeros((3, 10, 10, 10), np.uint8))
    with h5py.File(pred, "w") as f:
        _write_group(f, "prediction", "s0", np.zeros((3, 10, 10, 10), np.uint8))
    with caplog.at_level(logging.WARNING):
        results = both(tmp_path, ["--data", str(data), "--pred", str(pred), "--label_group",
                                  ""], caplog=caplog)
    assert_same(results, ["s0_heatmaps.png", "s0_images.png", "s0_labels.png"])
    assert any("heatmap channels" in w for w in results[1][2])


def test_wrong_pred_group_fails_cleanly(seg_stores, tmp_path):
    _, pred = seg_stores
    for main in (jax_visualize.main, visualize.main):
        with pytest.raises(SystemExit, match="pred_group"):
            main(["--pred", str(pred), "--pred_group", "predictions", "--out",
                  str(tmp_path / "figs")])


def test_mistyped_group_warns_after_loop(seg_stores, tmp_path, caplog):
    data, pred = seg_stores
    with caplog.at_level(logging.WARNING):
        results = both(tmp_path, ["--data", str(data), "--pred", str(pred), "--image_group",
                                  "imagez"], caplog=caplog)
    assert_same(results, ["s0_labels.png", "s1_labels.png"])
    assert any("imagez" in w and "--image_group" in w for w in results[1][2])


def test_one_sided_heatmaps(tmp_path):
    """GT-only heatmaps: a single-row grid, over the projected image where
    there is one (the render differs from the background-free one)."""
    from tpu_mednet.cli.visualize import render_subject as jax_render
    from tpu_mednet_torch.cli.visualize import render_subject

    rng = np.random.default_rng(3)
    img = rng.normal(size=(1, 12, 12, 12)).astype(np.float32)
    hm = np.zeros((2, 12, 12, 12), np.uint8)
    hm[0, 5, 5, 5] = 255
    hm[1, 7, 7, 7] = 255
    got = {}
    for name, fn in (("jax", jax_render), ("port", render_subject)):
        for bg in ("bg", "nobg"):
            out = tmp_path / name / bg
            out.mkdir(parents=True)
            fn("s0", out, img if bg == "bg" else None, None, hm, None)
            got[name, bg] = (out / "s0_heatmaps.png").read_bytes()
    assert got["port", "bg"] == got["jax", "bg"] and got["port", "nobg"] == got["jax", "nobg"]
    assert got["port", "bg"] != got["port", "nobg"]


def test_zarr_stores_as_hdf5(seg_stores, tmp_path):
    """The port reads zarr (its own zarrlite) to the same figures as HDF5."""
    data, pred = seg_stores
    zdata, zpred = tmp_path / "data.zarr", tmp_path / "pred.zarr"
    for src, dst in ((data, zdata), (pred, zpred)):
        z = zarrlite.open(str(dst), mode="w")
        with h5py.File(src, "r") as f:
            for group in f:
                for key in f[group]:
                    arr = z.require_group(group).create_dataset(key, data=f[group][key][()])
                    arr.attrs["affine"] = np.eye(4)
    for store, name in (((data, pred), "h5"), ((zdata, zpred), "zarr")):
        assert visualize.main(["--data", str(store[0]), "--pred", str(store[1]), "--out",
                               str(tmp_path / name)]) == 0
    for f in sorted((tmp_path / "h5").glob("*.png")):
        assert (tmp_path / "zarr" / f.name).read_bytes() == f.read_bytes(), f.name
