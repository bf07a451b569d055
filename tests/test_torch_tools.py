"""The port's host tools against the JAX package's: ``stats``, ``pack``,
``inspect_ckpt``, ``utils/misc.py``, ``utils/flops.py`` and the SimpleITK
affine helpers.

Each pair runs the same numpy code on the same seeded stores, so results
are held exactly: ``stats`` results (and JSON) equal; ``pack``'s destination
stores equal byte for byte (zarr and HDF5 files as written, NIfTI volumes
after gunzip and zip members read out, since both headers hold the time of
writing) for the whole store, subsets and every format, with the same
refusal messages; ``inspect_ckpt`` on the
port's import of a reference ``.ckpt`` equal, field for field but the path,
to the JAX package's on its own import of the same file; the analytic
FLOPs equal for both block families at every config of the repo.
"""

import gzip
import json
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from tpu_mednet.cli import import_torch as jax_import_torch
from tpu_mednet.cli import inspect_ckpt as jax_inspect
from tpu_mednet.cli import pack as jax_pack
from tpu_mednet.cli import stats as jax_stats
from tpu_mednet.utils import flops as jax_flops
from tpu_mednet.utils import misc as jax_misc
from tpu_mednet.utils import nifti as jax_nifti
from tpu_mednet_torch.cli import import_torch, inspect_ckpt, pack, stats
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.utils import flops, misc, nifti
from tpu_mednet_torch.utils.torch_export import save_reference_checkpoint

REPO = Path(__file__).resolve().parent.parent
h5py = pytest.importorskip("h5py")


def tree_bytes(path: Path) -> dict:
    """Every file under ``path`` (or the file itself) by relative name, with
    ``.gz`` payloads decompressed and a zip's members in order (gzip and zip
    headers hold the time of writing)."""
    if path.suffix == ".zip":
        with zipfile.ZipFile(path) as zf:
            return {"members": [(i.filename, zf.read(i)) for i in zf.infolist()]}
    files = [path] if path.is_file() else sorted(p for p in path.rglob("*") if p.is_file())
    out = {}
    for p in files:
        raw = p.read_bytes()
        out[str(p.relative_to(path.parent if path.is_file() else path))] = (
            gzip.decompress(raw) if p.suffix == ".gz" else raw)
    return out


@pytest.fixture
def store(tmp_path):
    """An HDF5 store of three subjects: 2-channel fp32 images (one without
    an affine), uint8 class maps, 3-channel uint8 heatmaps, anisotropic
    affines; and a key file of two of them."""
    rng = np.random.default_rng(0)
    path = tmp_path / "src.h5"
    with h5py.File(path, "w") as hf:
        for i in range(3):
            shape = (10 + i, 9, 8)
            img = rng.normal(i, 1.0 + i, size=(2, *shape)).astype(np.float32)
            lbl = rng.integers(0, 3 + (i == 2), (1, *shape)).astype(np.uint8)
            hm = np.zeros((3, *shape), np.uint8)
            hm[i, 2, 3, 4] = 200
            ds = hf.create_dataset(f"images/s{i}", data=img)
            if i != 1:
                ds.attrs["affine"] = np.diag([1.5, 0.75 * (i + 1), 2.0, 1.0])
            hf.create_dataset(f"labels/s{i}", data=lbl).attrs["affine"] = np.eye(4)
            hf.create_dataset(f"heatmaps/s{i}", data=hm)
    (tmp_path / "sub.txt").write_text("s2\ns0\n")
    return path


@pytest.mark.parametrize("dst", ["out.zarr", "out.h5", "out.nii", "out.zip"])
def test_pack_writes_the_same_bytes(store, tmp_path, dst):
    for name, mod in (("jax", jax_pack), ("port", pack)):
        (tmp_path / name).mkdir()
        assert mod.main(["--src", str(store), "--dst", str(tmp_path / name / dst),
                         "--log_level", "WARNING"]) == 0
    ref = tree_bytes(tmp_path / "jax" / dst)
    assert ref and tree_bytes(tmp_path / "port" / dst) == ref


@pytest.mark.parametrize("fmt", ["out.zarr", "out.nii"])
def test_pack_subsets_equal_jax_and_round_trip(store, tmp_path, fmt):
    argv = ["--src", str(store), "--groups", "images", "labels",
            "--subjects", str(tmp_path / "sub.txt"), "--log_level", "WARNING"]
    for name, mod in (("jax", jax_pack), ("port", pack)):
        (tmp_path / name).mkdir()
        assert mod.main([*argv, "--dst", str(tmp_path / name / fmt)]) == 0
    assert tree_bytes(tmp_path / "port" / fmt) == tree_bytes(tmp_path / "jax" / fmt)
    # and back to HDF5 from the port's store, by both packages
    for name, mod in (("jax", jax_pack), ("port", pack)):
        assert mod.main(["--src", str(tmp_path / "port" / fmt),
                         "--dst", str(tmp_path / name / "back.h5")]) == 0
    assert tree_bytes(tmp_path / "port" / "back.h5") == tree_bytes(tmp_path / "jax" / "back.h5")


def test_pack_refusals_equal_jax(store, tmp_path):
    empty = tmp_path / "empty.zarr"
    VolumeGroup().save(empty)
    (tmp_path / "none.txt").write_text("\n")
    cases = [
        ["--src", str(empty), "--dst", str(tmp_path / "x.zarr")],
        ["--src", str(store), "--dst", str(tmp_path / "x.zarr"), "--groups", "nothing"],
        ["--src", str(store), "--dst", str(tmp_path / "x.zarr"), "--subjects",
         str(tmp_path / "none.txt")],
    ]
    for argv in cases:
        messages = []
        for mod in (jax_pack, pack):
            with pytest.raises(SystemExit) as exc:
                mod.main(argv)
            messages.append(str(exc.value.code))
        assert messages[0] == messages[1], argv
    assert "not found" in messages[0] or "no keys" in messages[0]


@pytest.mark.parametrize("argv", [
    [],
    ["--heatmap_group", "heatmaps"],
    ["--subjects", "sub.txt", "--label_group", ""],
])
def test_stats_equal_jax(store, tmp_path, capsys, argv):
    argv = [str(tmp_path / a) if a == "sub.txt" else a for a in argv]
    outs = []
    for name, mod in (("jax", jax_stats), ("port", stats)):
        path = tmp_path / f"{name}.json"
        assert mod.main(["--data", str(store), "--json", str(path), "--log_level",
                         "WARNING", *argv]) == 0
        outs.append((path.read_text(), capsys.readouterr().out))
    assert outs[1] == outs[0]
    # the function under the CLI, on the same arguments
    assert (stats.collect_stats(store, heatmap_group="heatmaps")
            == jax_stats.collect_stats(store, heatmap_group="heatmaps"))


def _reference_ckpt(path: Path, landmarks: bool) -> None:
    """A reference-style ``.ckpt`` of a seeded 2-level port model."""
    out = 5 if landmarks else 3
    model = ResidualUNet3D(1, out, f_maps=(4, 8), num_levels=2, dtype=torch.float32,
                           device="cpu", generator=torch.Generator().manual_seed(3))
    hp = dict(in_channels=1, out_channels=out, fmaps=4, learning_rate=0.002,
              lr_schedule="cosine", warmup_steps=0, ema_decay=0.0, batch_size=2)
    if landmarks:
        hp["loss_regression_weight"] = [0.01, 0.02, 0.03]
    save_reference_checkpoint(path, model.state_dict(), hparams=hp, step=12, epoch=3)


@pytest.mark.parametrize("landmarks", [False, True])
def test_inspect_of_an_import_equals_jax(tmp_path, capsys, landmarks):
    ckpt = tmp_path / "ref.ckpt"
    _reference_ckpt(ckpt, landmarks)
    infos, texts = [], []
    for name, imp, ins in (("jax", jax_import_torch, jax_inspect),
                           ("port", import_torch, inspect_ckpt)):
        out = tmp_path / name
        assert imp.main(["--checkpoint", str(ckpt), "--output", str(out),
                         "--log_level", "WARNING"]) == 0
        capsys.readouterr()
        assert ins.main(["--checkpoint", str(out), "--json"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info.pop("checkpoint") == str(out)
        infos.append(info)
        assert ins.main(["--checkpoint", str(out)]) == 0
        texts.append(capsys.readouterr().out.split("\n", 1)[1])
    assert infos[1] == infos[0]
    assert texts[1] == texts[0]
    assert infos[1]["steps"] == [12] and infos[1]["model"]["params"] > 0
    assert infos[1]["task"] == ("LandmarkNet" if landmarks else "SegmentationNet")


def test_inspect_of_a_broken_side_car_reports_the_error(tmp_path, capsys):
    """A side-car whose hparams build no model: the model block carries the
    error and the rest is still reported."""
    from tpu_mednet_torch.train import CheckpointManager, create_train_state

    model = ResidualUNet3D(1, 2, f_maps=(4, 8), num_levels=2, dtype=torch.float32,
                           device="cpu")
    CheckpointManager(tmp_path / "c").save(
        5, create_train_state(model), hparams={"in_channels": 1, "learning_rate": 0.1})
    info = inspect_ckpt.inspect_checkpoint(tmp_path / "c")
    assert "could not rebuild model" in info["model"]["error"]
    assert info["steps"] == [5] and info["optimizer"] == {"learning_rate": 0.1}


def test_misc_equals_jax():
    for s in ("debug", "INFO", "Warning", "error", "CRITICAL"):
        assert misc.log_level_string_to_int(s) == jax_misc.log_level_string_to_int(s)
    assert misc._log_level_string_to_int is misc.log_level_string_to_int
    assert misc._LOG_LEVEL_STRINGS == jax_misc._LOG_LEVEL_STRINGS
    messages = []
    for mod in (jax_misc, misc):
        with pytest.raises(Exception) as exc:
            mod.log_level_string_to_int("loud")
        messages.append((type(exc.value).__name__, str(exc.value)))
    assert messages[0] == messages[1]


def _config_geometries():
    """(in, out, f_maps, patch, batch) of every training config of the repo."""
    out = []
    for path in sorted((REPO / "configs").glob("*.yaml")):
        cfg = yaml.safe_load(path.read_text())
        if "fmaps" not in cfg:
            continue
        fm = cfg["fmaps"]
        f_maps = [fm * 2**k for k in range(5)] if isinstance(fm, int) else list(fm)
        out.append((cfg.get("in_channels", 1), cfg["out_channels"], f_maps,
                    tuple(cfg["patch_size"]), cfg.get("batch_size", 1)))
    return out


def test_flops_equal_jax():
    geometries = _config_geometries()
    assert len(geometries) >= 4
    for block in ("residual", "double"):
        for in_ch, out_ch, f_maps, patch, batch in geometries:
            for k in (3, 1):
                assert (flops.unet_forward_flops(in_ch, out_ch, f_maps, patch, block, k)
                        == jax_flops.unet_forward_flops(in_ch, out_ch, f_maps, patch, block, k))
            assert (flops.unet_train_step_flops(in_ch, out_ch, f_maps, patch, batch, block)
                    == jax_flops.unet_train_step_flops(in_ch, out_ch, f_maps, patch, batch,
                                                       block))
    assert flops._conv_flops((2, 3, 4), 3, 5, 7) == jax_flops._conv_flops((2, 3, 4), 3, 5, 7)


def test_sitk_helpers_equal_jax(tmp_path):
    image = SimpleNamespace(GetDirection=lambda: (0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0),
                            GetSpacing=lambda: (0.8, 1.25, 3.0),
                            GetOrigin=lambda: (12.0, -7.5, 40.0))
    got, ref = nifti.sitk_make_affine(image), jax_nifti.sitk_make_affine(image)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    errors = []
    for mod in (jax_nifti, nifti):
        with pytest.raises(ImportError) as exc:
            mod.sitk_to_nifti(image, tmp_path / "x.nii")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
