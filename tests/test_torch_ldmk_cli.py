"""``train_ldmks`` then LandmarkNet ``predict`` through ``main(argv)`` on the CPU.

``train_ldmks -c configs/landmarks.yaml`` with path and size overrides
(f_maps 4, 3 heatmaps + 2 classes, 16³ patches, fp32) on a zarr store with
a ``heatmaps`` group, a ``landmarks`` (3, 3) group and a class map trains 2
epochs with the host sampler and resumes to 3; then one epoch each with
``--device_sampler`` on the stored heatmaps and on the landmarks (heatmaps
rendered on the device).  ``predict -c configs/predict.yaml`` with
``prediction.model=LandmarkNet``, ``base.sigma`` of 3 entries and
``prediction.landmarks`` writes both stitches.  Against the JAX package's
``predict_volumes`` on the carried weights: heatmap bytes equal except by
1 where JAX's pre-cast value lies within 1e-3 of an integer, class maps
equal outside the 1e-4 top-2 band of JAX's class logits; the JSON equals
JAX's ``landmark_readout`` of the stored prediction, and the CSV holds the
same rows.  The guards of both CLIs, and CUDA by default.
"""

import csv
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data.readers import ZarrReader as JaxZarrReader
from tpu_mednet.inference.device_sliding import _grid_corners as jax_grid_corners
from tpu_mednet.inference.sliding_window import predict_volumes as jax_predict_volumes
from tpu_mednet.tasks import LandmarkTask as JaxLandmarkTask
from tpu_mednet.utils.evaluation import landmark_readout as jax_landmark_readout
from tpu_mednet.utils.torch_import import convert_state_dict
from tpu_mednet_torch.cli import predict, train_ldmks
from tpu_mednet_torch.data import zarrlite
from tpu_mednet_torch.inference.serving import detect_task_name
from tpu_mednet_torch.train import CheckpointManager, load_for_inference

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"s0": (24, 20, 22), "s1": (20, 24, 18), "s2": (22, 18, 24), "s3": (20, 20, 20),
          "s4": (18, 22, 26)}
TEST = ["s3", "s4"]
TIE_BAND = 1e-4
SIGMA = 4.0
HP = SimpleNamespace(in_channels=1, out_channels=5, fmaps=4, bf16=False,
                     loss_regression_weight=[0.015, 0.015, 0.015], loss_class="DICE",
                     loss_class_weight=[0.05, 1.0], loss_regression="L2")


def _write_store(root: Path) -> None:
    rng = np.random.default_rng(0)
    z = zarrlite.open(str(root / "data.zarr"), mode="w")
    for key, shape in SHAPES.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:11, 4:12, 2:10] = 1
        coords = rng.uniform(3, np.asarray(shape) - 3, size=(3, 3)).astype(np.float32)
        grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
        d2 = ((grid[None] - coords[:, None, None, None]) ** 2).sum(-1)
        hm = (255.0 * np.exp(-d2 / (2 * SIGMA**2))).astype(np.uint8)
        img = (rng.normal(0, 0.5, size=(1, *shape)) + lbl + hm.max(0) / 128.0)
        arr = z.require_group("images").create_dataset(key, data=img.astype(np.float32))
        arr.attrs["affine"] = np.diag([1.5, 1.5, 2.0, 1.0])
        z.require_group("labels").create_dataset(key, data=lbl)
        z.require_group("heatmaps").create_dataset(key, data=hm)
        z.require_group("landmarks").create_dataset(key, data=coords)
    (root / "train.txt").write_text("s0\ns1\ns2\n")
    (root / "val.txt").write_text("s3\n")
    (root / "test.txt").write_text("\n".join(TEST) + "\n")


def _train_argv(root: Path, *extra):
    return ["--device", "cpu", "-c", str(REPO / "configs" / "landmarks.yaml"),
            "--data_path", str(root / "data.zarr"), "--train_set", str(root / "train.txt"),
            "--val_set", str(root / "val.txt"), "--model_dir", str(root / "model"),
            "--log_dir", str(root / "logs"), "--patch_size", "16", "16", "16",
            "--fmaps", "4", "--patches_per_subject", "2", "--batch_size", "2",
            "--no_bf16", *extra]


def _predict_argv(root: Path, stitch: str, *extra):
    return ["--device", "cpu", "-c", str(REPO / "configs" / "predict.yaml"),
            f"base.data={root / 'data.zarr'}", f"base.sigma=[{SIGMA}, {SIGMA}, {SIGMA}]",
            f"prediction.test_set={root / 'test.txt'}",
            f"prediction.checkpoint={root / 'model' / 'best'}",
            f"prediction.data={root / f'pred_{stitch}.zarr'}",
            f"prediction.landmarks={root / f'landmarks_{stitch}.json'}",
            "prediction.model=LandmarkNet", "prediction.patch_size=[16, 16, 16]",
            "prediction.patch_overlap=[4, 4, 4]", "prediction.batch_size=4",
            f"prediction.stitch={stitch}", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ldmk_cli")
    _write_store(root)
    assert train_ldmks.main(_train_argv(root, "--max_epochs", "2")) == 0
    assert train_ldmks.main(_train_argv(root, "--max_epochs", "3", "--resume",
                                        str(root / "model"))) == 0
    for stitch in ("crop", "device"):
        assert predict.main(_predict_argv(root, stitch)) == 0
    return root


def test_train_writes_checkpoints_and_landmark_metrics(run):
    assert CheckpointManager(run / "model").available_steps == [3, 6, 9]
    best = CheckpointManager(run / "model" / "best")
    assert len(best.available_steps) == 1
    hp = best.restore_hparams()
    assert detect_task_name(hp) == "LandmarkNet"
    assert hp["loss_regression_weight"] == HP.loss_regression_weight
    assert hp["out_channels"] == 5 and hp["heatmap_group"] == "heatmaps"
    assert hp["_best_monitor"]["metric"] == "val_loss"
    records = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
               .splitlines()]
    names = set().union(*(r.keys() for r in records)) - {"step", "time"}
    assert names == {"train_loss", "class_loss", "regression_loss", "lr", "patches_per_sec",
                     "val_loss", "val_class_loss", "val_regression_loss",
                     "val_landmark_error", "val_dice0", "val_dice1"}
    assert sorted(r["step"] for r in records if "val_landmark_error" in r) == [3, 6, 9]
    assert all(np.isfinite(r["train_loss"]) for r in records if "train_loss" in r)


@pytest.mark.parametrize("extra", [["--heatmap_group", "heatmaps"],
                                   ["--landmark_group", "landmarks", "--heatmap_sigma", "4"]],
                         ids=["heatmap_group", "landmark_group"])
def test_device_sampler_runs(run, tmp_path, extra):
    argv = _train_argv(run, "--max_epochs", "1", "--device_sampler", *extra,
                       "--model_dir", str(tmp_path / "m"), "--log_dir", str(tmp_path / "l"))
    assert train_ldmks.main(argv) == 0
    records = [json.loads(line) for line in (tmp_path / "l" / "metrics.jsonl").read_text()
               .splitlines()]
    val = [r for r in records if "val_landmark_error" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val_loss"])
    assert CheckpointManager(tmp_path / "m").available_steps == [3]


def _jax_reference(run):
    """JAX ``predict_volumes`` and the clipped heatmap logits and class
    margin of the JAX model, stitched with the grid's cores, per subject."""
    weights, _ = load_for_inference(run / "model" / "best")
    variables = convert_state_dict({k: v.numpy() for k, v in weights.items()})
    jtask = JaxLandmarkTask.from_hparams(HP)
    with JaxZarrReader(run / "data.zarr") as r:
        images = dict(zip(TEST, r.read(TEST, "images", np.float32)))
    ref = jax_predict_volumes(jtask, variables, None, TEST, patch_size=[16] * 3,
                              patch_overlap=[4] * 3, batch_size=4, out_channels=4,
                              reader=JaxMemoryReader({"images": images}),
                              pad_mode="constant")
    stitched = {}
    for key in TEST:
        vol = images[key].astype(np.float16)
        img = np.asarray(vol.shape[1:])
        corners, padded = jax_grid_corners(img, [16] * 3, [4] * 3)
        pads = [(4, int(p - s - 4)) for p, s in zip(padded, img)]
        v = np.pad(np.moveaxis(vol, 0, -1), pads + [(0, 0)])
        tiles = np.stack([v[x:x + 16, y:y + 16, z:z + 16] for x, y, z in corners])
        logits = np.asarray(jtask.model.apply(variables, jnp.asarray(tiles.astype(np.float32)),
                                              train=False))
        out = np.zeros((*padded, 4), np.float32)  # 3 clipped heatmaps, class margin
        out_core = np.concatenate([np.clip(logits[..., :3], 0, 255),
                                   np.abs(logits[..., 3:4] - logits[..., 4:5])], -1)
        for (x, y, z), t in zip(corners, out_core):
            out[x + 4:x + 12, y + 4:y + 12, z + 4:z + 12] = t[4:12, 4:12, 4:12]
        stitched[key] = np.moveaxis(out[4:4 + img[0], 4:4 + img[1], 4:4 + img[2]], -1, 0)
    return ref, stitched


def test_predict_matches_jax_predict_volumes_and_reads_out_landmarks(run):
    ref, stitched = _jax_reference(run)
    for stitch in ("crop", "device"):
        with JaxZarrReader(run / f"pred_{stitch}.zarr") as r:
            got = dict(zip(TEST, r.read(TEST, "prediction", np.uint8)))
            affines = r.get_data_attribute(TEST, "prediction", "affine")
        readout = json.loads((run / f"landmarks_{stitch}.json").read_text())
        assert sorted(readout) == TEST
        for key in TEST:
            want = np.asarray(ref[key])
            assert got[key].shape == want.shape == (4, *SHAPES[key])
            diff = np.abs(got[key][:3].astype(np.int16) - want[:3].astype(np.int16))
            pre = stitched[key][:3]
            near = np.abs(pre - np.round(pre)) <= 1e-3
            assert diff.max() <= 1 and not (diff.astype(bool) & ~near).any(), (stitch, key)
            clear = stitched[key][3] > TIE_BAND
            assert clear.mean() > 0.99
            np.testing.assert_array_equal(got[key][3][clear], want[3][clear],
                                          err_msg=f"{stitch} {key}")
            assert readout[key] == jax_landmark_readout(got[key], 3, affine=affines[key])
            assert len(readout[key]) == 3 and all(
                0 <= v < s for lm in readout[key] for v, s in zip(lm["voxel"], SHAPES[key]))


def test_predict_writes_landmarks_as_csv(run, tmp_path):
    out = tmp_path / "lm.csv"
    assert predict.main(_predict_argv(run, "device", f"prediction.landmarks={out}",
                                      f"prediction.data={tmp_path / 'p.zarr'}")) == 0
    rows = list(csv.reader(out.read_text().splitlines()))
    assert rows[0] == ["subject", "landmark", "x_vox", "y_vox", "z_vox", "peak", "x_mm",
                       "y_mm", "z_mm"]
    want = json.loads((run / "landmarks_device.json").read_text())
    assert len(rows) == 1 + 3 * len(TEST)
    for row in rows[1:]:
        entry = want[row[0]][int(row[1])]
        assert [float(v) for v in row[2:5]] == entry["voxel"]
        assert [float(v) for v in row[6:9]] == entry["physical"]


@pytest.mark.parametrize("extra,match", [
    (["prediction.channel_selection=[0]"], "channel_selection"),
    (["prediction.model=SegmentationNet"], "trained as 'LandmarkNet'"),
])
def test_predict_guards(run, extra, match):
    with pytest.raises(ValueError, match=match):
        predict.main(_predict_argv(run, "crop", *extra))


@pytest.mark.parametrize("extra,error,match", [
    (["--landmark_group", "landmarks"], SystemExit, "requires --device_sampler"),
    (["--loss_regression_weight", "0.1", "0.1"], SystemExit, "out_channels"),
    (["--loss_regression_weight", "0.1", "0.1", "--out_channels", "4"], SystemExit,
     "3 heatmap channels"),
    (["--gpus", "3"], SystemExit, "data-parallel size 3"),
    (["--native_loader"], RuntimeError, "native loader requested but unavailable"),
    (["--neptune_project", "p"], None, "not installed"),
], ids=["landmarks_need_device_sampler", "heatmaps_vs_out_channels", "store_vs_config",
        "gpus", "native_loader", "neptune"])
def test_train_ldmks_refuses(run, tmp_path, monkeypatch, caplog, extra, error, match):
    # --native_loader requires the native pipeline: refused where its
    # library is unavailable; --gpus needs a batch that splits evenly over
    # the ranks; --neptune_project without the client warns and trains, as
    # the JAX CLI does
    monkeypatch.setenv("TPU_MEDNET_NO_NATIVE", "1")
    argv = _train_argv(run, "--max_epochs", "1", "--model_dir", str(tmp_path / "m"),
                       "--log_dir", str(tmp_path / "l"), *extra)
    if error is None:
        monkeypatch.setenv("NEPTUNE_API_TOKEN", "fake-token")
        monkeypatch.setitem(__import__("sys").modules, "neptune", None)
        with caplog.at_level("WARNING"):
            assert train_ldmks.main(argv) == 0
        assert match in caplog.text
        return
    with pytest.raises(error, match=match):
        train_ldmks.main(argv)


def test_train_ldmks_takes_the_spatial_and_remat_flags(run, tmp_path, monkeypatch):
    """The spatial flags build the JAX CLI's ``AugmentConfig`` with the
    Trainer's hook on top (the heatmap channels warp linearly), ``--remat
    all`` recomputes every stage, and the run trains."""
    from tpu_mednet import config as jax_config
    from tpu_mednet.cli import train_ldmks as jax_train_ldmks
    from tpu_mednet_torch.train import Trainer

    seen = {}
    orig = Trainer.__init__

    def init(self, task, *args, **kw):
        orig(self, task, *args, **kw)
        seen.update(augment=self.augment, remat=task.model.config.remat, task=task)

    monkeypatch.setattr(Trainer, "__init__", init)
    argv = _train_argv(run, "--max_epochs", "1", "--limit_train_batches", "1",
                       "--model_dir", str(tmp_path / "m"), "--log_dir", str(tmp_path / "logs"),
                       "--remat", "all", "--aug_elastic_sigma", "2", "--aug_rotate_deg", "15",
                       "--aug_scale", "0.85", "1.15")
    assert train_ldmks.main(argv) == 0
    jax_hp = jax_config.parse_with_config(jax_train_ldmks.build_parser(), argv[2:])
    want = dataclasses.replace(jax_config.augment_config_from_hparams(jax_hp),
                               label_trilinear_channels=seen["task"].num_heatmaps)
    assert dataclasses.asdict(seen["augment"]) == dataclasses.asdict(want)
    assert seen["augment"].label_trilinear_channels == 3 and seen["remat"] is True
    assert CheckpointManager(tmp_path / "m").available_steps == [1]
    records = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl")
               .read_text().splitlines()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert losses and all(np.isfinite(losses))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable here")


def test_train_ldmks_refuses_to_run_without_cuda_unless_told(run, no_cuda, capsys):
    argv = [a for a in _train_argv(run, "--max_epochs", "1") if a not in ("--device", "cpu")]
    assert train_ldmks.main(argv) == 2
    assert "CUDA is not available" in capsys.readouterr().err
