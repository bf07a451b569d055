"""The port's two CLIs end to end on the CPU (``--device cpu``), on a zarr store.

``train_seg -c configs/seg_organ.yaml`` with path and size overrides
(f_maps 4, 3 classes, 16³ patches, fp32) trains 2 epochs, resumes to 3,
and runs one epoch with the device sampler and the optimizer options;
``predict -c configs/predict.yaml`` writes both stitches of ``best/`` to
zarr stores that the JAX package's ``ZarrReader`` reads.  Their masks
equal the JAX package's ``predict_volumes`` on the carried weights on
every voxel where the JAX logits' top-2 margin exceeds 1e-4 (the tolerance
on record).  A reference-style ``.ckpt`` from the JAX package's
``save_reference_checkpoint`` predicts through the port.  ``predict``
with ``stitch: gaussian``, with ``tta: true``, and with both from a NIfTI
directory into ``*.nii`` (on the card's stitch and spilled to the host
one by the HBM guard, which also raises under ``error``) is held against
the JAX pipeline of the same stitch on the carried weights: class maps
equal outside the 1e-4 top-2 band of JAX's (TTA- and Gaussian-)averaged
probabilities (``test_torch_tta.assert_prediction_matches``).  The modes
that wait are refused, and both CLIs exit non-zero without CUDA unless
``--device cpu`` is given.
"""

import dataclasses
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data.readers import ZarrReader as JaxZarrReader
from tests.test_torch_tta import assert_prediction_matches, core_stitch, jax_tile_activations
from tests.test_torch_weighted import weighted_average
from tpu_mednet.inference import weighted as jax_weighted
from tpu_mednet.inference.device_sliding import _grid_corners as jax_grid_corners
from tpu_mednet.inference.sliding_window import predict_volumes as jax_predict_volumes
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.utils.torch_export import flax_to_state_dict, save_reference_checkpoint
from tpu_mednet.utils.torch_import import convert_state_dict
from tpu_mednet_torch.cli import predict, train_seg
from tpu_mednet_torch.data import NiftiReader, zarrlite
from tpu_mednet_torch.train import CheckpointManager, load_for_inference
from tpu_mednet_torch.utils.memory import HBMBudgetError
from tpu_mednet_torch.utils.nifti import save_nifti

REPO = Path(__file__).resolve().parent.parent
SHAPES = {"s0": (24, 20, 22), "s1": (20, 24, 18), "s2": (22, 18, 24), "s3": (20, 20, 20),
          "s4": (18, 22, 26)}
TIE_BAND = 1e-4
HP = SimpleNamespace(in_channels=1, out_channels=3, fmaps=4, bf16=False, loss="DICE",
                     loss_weight=None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models' many small ops run fastest on one thread; with
    several test workers on the host, more threads oversubscribe its cores
    (a spill test took 456 s instead of 25 s, six copies at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_store(root: Path, nan: bool = False) -> None:
    rng = np.random.default_rng(0)
    z = zarrlite.open(str(root / "data.zarr"), mode="w")
    for key, shape in SHAPES.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:11, 4:12, 2:10] = 1
        lbl[0, 12:17, 10:16, 11:17] = 2
        img = (rng.normal(0, 0.5, size=(1, *shape)) + lbl).astype(np.float32)
        if nan:
            img[:] = np.nan
        arr = z.require_group("images").create_dataset(key, data=img)
        arr.attrs["affine"] = np.diag([1.5, 1.5, 2.0, 1.0])
        z.require_group("labels").create_dataset(key, data=lbl)
    (root / "train.txt").write_text("s0\ns1\ns2\n")
    (root / "val.txt").write_text("s3\n")
    (root / "test.txt").write_text("s3\ns4\n")


def _train_argv(root: Path, *extra):
    return ["--device", "cpu", "-c", str(REPO / "configs" / "seg_organ.yaml"),
            "--data_path", str(root / "data.zarr"), "--train_set", str(root / "train.txt"),
            "--val_set", str(root / "val.txt"), "--model_dir", str(root / "model"),
            "--log_dir", str(root / "logs"), "--patch_size", "16", "16", "16",
            "--fmaps", "4", "--out_channels", "3", "--class_probabilities", "0.4", "0.3",
            "0.3", "--patches_per_subject", "2", "--batch_size", "2", "--no_bf16", *extra]


def _predict_argv(root: Path, stitch: str, checkpoint=None, *extra):
    return ["--device", "cpu", "-c", str(REPO / "configs" / "predict.yaml"),
            f"base.data={root / 'data.zarr'}", f"prediction.test_set={root / 'test.txt'}",
            f"prediction.checkpoint={checkpoint or root / 'model' / 'best'}",
            f"prediction.data={root / f'pred_{stitch}.zarr'}",
            "prediction.patch_size=[16, 16, 16]", "prediction.patch_overlap=[4, 4, 4]",
            "prediction.batch_size=4", f"prediction.stitch={stitch}", *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    _write_store(root)
    assert train_seg.main(_train_argv(root, "--max_epochs", "2")) == 0
    assert train_seg.main(_train_argv(root, "--max_epochs", "3", "--resume",
                                      str(root / "model"))) == 0
    for stitch in ("crop", "device"):
        assert predict.main(_predict_argv(root, stitch)) == 0
    return root


def test_train_writes_checkpoints_and_metrics(run):
    assert CheckpointManager(run / "model").available_steps == [3, 6, 9]
    best = CheckpointManager(run / "model" / "best")
    assert len(best.available_steps) == 1
    hp = best.restore_hparams()
    assert hp["ckpt_format"] == 2 and hp["fmaps"] == 4 and hp["device"] == "cpu"
    assert hp["_best_monitor"]["metric"] == "val_loss"
    records = [json.loads(line) for line in (run / "logs" / "metrics.jsonl").read_text()
               .splitlines()]
    names = set().union(*(r.keys() for r in records)) - {"step", "time"}
    assert names == {"train_loss", "lr", "patches_per_sec", "val_loss", "val_dice0",
                     "val_dice1", "val_dice2"}
    assert sorted(r["step"] for r in records if "val_loss" in r) == [3, 6, 9]
    assert list((run / "logs").glob("events.out.tfevents*"))  # tensorboardX is here


def test_device_sampler_run_with_the_optimizer_options(run, tmp_path):
    argv = _train_argv(run, "--max_epochs", "1", "--device_sampler", "--optimizer", "adamw",
                       "--weight_decay", "1e-4", "--lr_schedule", "cosine", "--warmup_steps",
                       "2", "--grad_clip_norm", "1.0", "--ema_decay", "0.99", "--nonfinite",
                       "skip", "--track_grad_norm", "--accumulate_grad_batches", "2",
                       "--model_dir", str(tmp_path / "m"), "--log_dir", str(tmp_path / "l"))
    assert train_seg.main(argv) == 0
    first = json.loads((tmp_path / "l" / "metrics.jsonl").read_text().splitlines()[0])
    assert first["lr"] == 0.0 and first["nonfinite"] == 0.0 and first["grad_norm"] > 0
    weights = CheckpointManager(tmp_path / "m").restore_weights()
    assert weights["ema"] is not None and sorted(weights["ema"]) == sorted(weights["params"])


def _jax_margin(model, variables, vol_f16, patch, overlap):
    """Top-2 logit margin of the JAX model, stitched with the grid's cores."""
    img = np.asarray(vol_f16.shape[1:])
    corners, padded = jax_grid_corners(img, patch, overlap)
    ov = np.asarray(overlap)
    pads = [(int(o), int(p - s - o)) for o, p, s in zip(ov, padded, img)]
    vol = np.pad(np.moveaxis(vol_f16, 0, -1), pads + [(0, 0)])
    tiles = np.stack([vol[x:x + patch[0], y:y + patch[1], z:z + patch[2]]
                      for x, y, z in corners]).astype(np.float32)
    logits = np.asarray(model.apply(variables, jnp.asarray(tiles), train=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    out = np.zeros(tuple(padded), np.float32)
    core = tuple(slice(o, p - o) for o, p in zip(ov, patch))
    for (x, y, z), m in zip(corners, margin):
        out[x + ov[0]:x + patch[0] - ov[0], y + ov[1]:y + patch[1] - ov[1],
            z + ov[2]:z + patch[2] - ov[2]] = m[core]
    return out[ov[0]:ov[0] + img[0], ov[1]:ov[1] + img[1], ov[2]:ov[2] + img[2]]


def test_predict_masks_match_jax_predict_volumes(run):
    weights, _ = load_for_inference(run / "model" / "best")
    variables = convert_state_dict({k: v.numpy() for k, v in weights.items()})
    jtask = JaxSegmentationTask.from_hparams(HP)
    with JaxZarrReader(run / "data.zarr") as r:
        store = {"images": {k: np.asarray(v) for k, v in
                            zip(["s3", "s4"], r.read(["s3", "s4"], "images", np.float32))}}
    ref = jax_predict_volumes(jtask, variables, None, ["s3", "s4"], patch_size=[16] * 3,
                              patch_overlap=[4] * 3, batch_size=4,
                              reader=JaxMemoryReader(store), pad_mode="constant")
    for stitch in ("crop", "device"):
        with JaxZarrReader(run / f"pred_{stitch}.zarr") as r:
            assert r.list_groups() == ["prediction"]
            got = dict(zip(["s3", "s4"], r.read(["s3", "s4"], "prediction", np.uint8)))
            affine = r.get_data_attribute(["s3"], "prediction", "affine")["s3"]
        np.testing.assert_array_equal(np.asarray(affine), np.diag([1.5, 1.5, 2.0, 1.0]))
        for key in ("s3", "s4"):
            want = np.asarray(ref[key])
            assert got[key].shape == want.shape == (1, *SHAPES[key])
            margin = _jax_margin(jtask.model, variables,
                                 store["images"][key].astype(np.float16), [16] * 3, [4] * 3)
            clear = margin > TIE_BAND
            assert clear.mean() > 0.99
            np.testing.assert_array_equal(got[key][0][clear], want[0][clear],
                                          err_msg=f"{stitch} {key}")


def test_predict_from_a_reference_ckpt(run, tmp_path):
    import jax

    # the reference's hparams carry no dtype, so the port predicts in bf16,
    # which is slow on the CPU: a narrower model, one subject, 8 tiles
    hp_ref = {**vars(HP), "fmaps": 2}
    jtask = JaxSegmentationTask.from_hparams(SimpleNamespace(**hp_ref))
    variables = jtask.model.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 16, 1)))
    ckpt = tmp_path / "model.ckpt"
    save_reference_checkpoint(ckpt, variables, hparams=hp_ref, step=12)
    weights, hp = load_for_inference(ckpt)
    assert hp == {k: v for k, v in hp_ref.items() if k != "bf16"}
    want = flax_to_state_dict(variables)
    assert sorted(weights) == sorted(want)
    assert all(np.array_equal(weights[k].numpy(), want[k]) for k in want)

    out = tmp_path / "out"
    shutil.copytree(run, out, ignore=shutil.ignore_patterns("model", "logs", "pred_*"))
    (out / "test.txt").write_text("s3\n")
    assert predict.main(_predict_argv(out, "device", ckpt,
                                      "prediction.patch_overlap=[0, 0, 0]")) == 0
    with JaxZarrReader(out / "pred_device.zarr") as r:
        (mask,) = r.read(["s3"], "prediction", np.uint8)
    assert mask.shape == (1, *SHAPES["s3"]) and set(np.unique(mask)) <= {0, 1, 2}


@pytest.mark.parametrize("extra,match", [
    (["prediction.stitch=gaussian"], None),
    (["prediction.tta=true"], None),
    (["prediction.gpus=2"], "Multi-GPU"),
    (["prediction.landmarks=/tmp/l.json"], "landmarks"),
], ids=["extra0-None", "extra1-None", "extra2-Multi-GPU", "extra3-landmarks"])
def test_predict_refuses_what_waits(run, tmp_path, capsys, extra, match):
    if match == "Multi-GPU":  # ported: clamped to the one CPU device, with a line
        out = tmp_path / "pred.zarr"
        capsys.readouterr()
        assert predict.main(_predict_argv(run, "crop", None, *extra,
                                          f"prediction.data={out}")) == 0
        assert "prediction.gpus 2 clamped to 1" in capsys.readouterr().out
        with JaxZarrReader(out) as r, JaxZarrReader(run / "pred_crop.zarr") as ref:
            for key in ("s3", "s4"):
                (got,), (want,) = (x.read([key], "prediction", np.uint8) for x in (r, ref))
                assert np.array_equal(np.asarray(got), np.asarray(want)), key
        return
    if match is None:  # the Gaussian stitch and TTA are ported: held against JAX
        out = tmp_path / "pred.zarr"
        assert predict.main(_predict_argv(run, "crop", None, *extra,
                                          f"prediction.data={out}")) == 0
        stitch, flips = ("gaussian", ()) if "gaussian" in extra[0] else ("crop", (0, 1, 2))
        want, act = _jax_reference(run, stitch, flips)
        with JaxZarrReader(out) as r:
            masks = dict(zip(["s3", "s4"], r.read(["s3", "s4"], "prediction", np.uint8)))
        for key, mask in masks.items():
            assert_prediction_matches(np.asarray(mask), want[key], act[key],
                                      what=f"{extra[0]} {key}")
        return
    # landmarks are ported: a segmentation checkpoint has no heatmaps to
    # read them from, which is a configuration error
    with pytest.raises(ValueError, match="no heatmap channels"):
        predict.main(_predict_argv(run, "crop", None, *extra))


def test_predict_refuses_the_wrong_task(run, tmp_path):
    with pytest.raises(ValueError, match="trained as 'SegmentationNet'"):
        predict.main(_predict_argv(run, "crop", None, "prediction.model=LandmarkNet"))
    ldmk = tmp_path / "ldmk"
    shutil.copytree(run / "model" / "best", ldmk)
    side_car = next(ldmk.glob("*/hparams.json"))
    hp = json.loads(side_car.read_text())
    side_car.write_text(json.dumps({**hp, "loss_regression_weight": [0.1]}))
    with pytest.raises(ValueError, match="trained as 'LandmarkNet'"):
        predict.main(_predict_argv(run, "crop", ldmk, "prediction.model=SegmentationNet"))
    # detected from the side-car, the same weights predict as a LandmarkNet
    # of one heatmap and two classes: the heatmap channel, then the class map
    out = tmp_path / "ldmk_pred.zarr"
    assert predict.main(_predict_argv(run, "crop", ldmk, "prediction.model=null",
                                      "base.sigma=[4.0]", f"prediction.data={out}")) == 0
    with JaxZarrReader(out) as r:
        (pred,) = r.read(["s3"], "prediction", np.uint8)
    assert pred.shape == (2, *SHAPES["s3"]) and set(np.unique(pred[1])) <= {0, 1}
    with pytest.raises(ValueError, match="integer step"):
        predict.main(_predict_argv(run, "crop", None, "prediction.checkpoint_step=best"))


@pytest.mark.parametrize("extra,error,match", [
    (["--gpus", "3"], SystemExit, "data-parallel size 3"),
    (["--spatial_shards", "2"], SystemExit, "must divide the device count"),
    (["--native_loader"], RuntimeError, "native loader requested but unavailable"),
    (["--neptune_project", "p"], None, "not installed"),
], ids=["extra0-Multi-GPU", "extra1-Multi-GPU", "extra2-native loader", "extra3-Neptune"])
def test_train_refuses_what_waits(run, tmp_path, monkeypatch, caplog, extra, error, match):
    """``--spatial_shards`` (ported) must divide the device count, with
    the JAX CLI's words; ``--gpus`` (ported) needs a
    batch that splits evenly over the ranks, as JAX's does;
    ``--native_loader`` (ported) requires the native pipeline and raises
    where its library is unavailable; ``--neptune_project`` (ported) warns
    and trains where the client is missing, as JAX's does."""
    monkeypatch.setenv("TPU_MEDNET_NO_NATIVE", "1")
    argv = _train_argv(run, "--max_epochs", "1", "--model_dir", str(tmp_path / "m"),
                       "--log_dir", str(tmp_path / "l"), *extra)
    if error is None:
        monkeypatch.setenv("NEPTUNE_API_TOKEN", "fake-token")
        monkeypatch.setitem(__import__("sys").modules, "neptune", None)
        with caplog.at_level("WARNING"):
            assert train_seg.main(argv) == 0
        assert match in caplog.text
        return
    with pytest.raises(error, match=match):
        train_seg.main(argv)


SPATIAL_FLAGS = ("--aug_elastic_sigma", "2", "--aug_rotate_deg", "15", "--aug_scale", "0.85",
                 "1.15", "--aug_elastic_grid", "3", "--aug_spatial_prob", "0.75")


def test_train_takes_the_spatial_and_remat_flags(run, tmp_path, monkeypatch):
    """The spatial flags build the JAX CLI's ``AugmentConfig``, ``--remat 1``
    recomputes the full-resolution stages, and the run trains."""
    from tpu_mednet import config as jax_config
    from tpu_mednet.cli import train_seg as jax_train_seg
    from tpu_mednet_torch.train import Trainer

    seen = {}
    orig = Trainer.__init__

    def init(self, task, *args, **kw):
        orig(self, task, *args, **kw)
        seen.update(augment=self.augment, remat=task.model.config.remat)

    monkeypatch.setattr(Trainer, "__init__", init)
    argv = _train_argv(run, "--max_epochs", "1", "--limit_train_batches", "1",
                       "--model_dir", str(tmp_path / "m"), "--log_dir", str(tmp_path / "logs"),
                       "--remat", "1", *SPATIAL_FLAGS)
    assert train_seg.main(argv) == 0
    jax_hp = jax_config.parse_with_config(jax_train_seg.build_parser(), argv[2:])
    assert dataclasses.asdict(seen["augment"]) == dataclasses.asdict(
        jax_config.augment_config_from_hparams(jax_hp))
    assert seen["augment"].wants_spatial() and seen["remat"] == 1
    assert CheckpointManager(tmp_path / "m").available_steps == [1]
    records = [json.loads(line) for line in (tmp_path / "logs" / "metrics.jsonl")
               .read_text().splitlines()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert losses and all(np.isfinite(losses))


def test_train_exits_3_when_it_stops_on_non_finite_values(tmp_path):
    _write_store(tmp_path, nan=True)
    argv = _train_argv(tmp_path, "--max_epochs", "1", "--nonfinite", "terminate")
    assert train_seg.main(argv) == 3
    assert CheckpointManager(tmp_path / "model").available_steps == [0]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable here")


def test_both_clis_refuse_to_run_without_cuda_unless_told(run, no_cuda, capsys):
    train = [a for a in _train_argv(run, "--max_epochs", "1") if a not in ("--device", "cpu")]
    assert train_seg.main(train) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    pred = [a for a in _predict_argv(run, "crop") if a not in ("--device", "cpu")]
    assert predict.main(pred) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def _write_nifti_dir(root: Path, run: Path) -> None:
    """The test subjects of the zarr fixture as a NIfTI directory."""
    with JaxZarrReader(run / "data.zarr") as r:
        images = dict(zip(["s3", "s4"], r.read(["s3", "s4"], "images", np.float32)))
        affines = r.get_data_attribute(["s3", "s4"], "images", "affine")
    (root / "images").mkdir(parents=True)
    for key, img in images.items():
        save_nifti(root / "images" / f"{key}.nii", img[0], np.asarray(affines[key]))


def _jax_reference(run, stitch, flips):
    """JAX's masks of the test subjects through the ``stitch`` pipeline
    (``crop``: ``predict_volumes``; ``gaussian``:
    ``predict_volumes_weighted_on_device``) with ``tta_flips=flips`` on
    ``best/``'s carried weights, and per subject the averaged activations
    whose class margin sets the tie band."""
    weights, _ = load_for_inference(run / "model" / "best")
    variables = convert_state_dict({k: v.numpy() for k, v in weights.items()})
    jtask = JaxSegmentationTask.from_hparams(HP)
    keys, patch, overlap = ["s3", "s4"], [16] * 3, [4] * 3
    with JaxZarrReader(run / "data.zarr") as r:
        store = {"images": {k: np.asarray(v) for k, v in
                            zip(keys, r.read(keys, "images", np.float32))}}
    kw = dict(patch_size=patch, patch_overlap=overlap, batch_size=4, tta_flips=flips)
    if stitch == "gaussian":
        ref = jax_weighted.predict_volumes_weighted_on_device(
            jtask, variables, None, keys, reader=JaxMemoryReader(store), **kw)
    else:
        ref = jax_predict_volumes(jtask, variables, None, keys, reader=JaxMemoryReader(store),
                                  pad_mode="constant", **kw)
    average = weighted_average if stitch == "gaussian" else core_stitch
    act = {}
    for key in keys:
        tiles, corners, padded = jax_tile_activations(jtask, variables, store["images"][key],
                                                      flips, patch, overlap)
        act[key] = average(tiles, corners, padded, SHAPES[key], patch, overlap)
    return {k: np.asarray(ref[k]) for k in keys}, act


@pytest.mark.parametrize("stitch", ["gaussian"])
def test_predict_nifti_directory_with_tta_and_the_guard(run, tmp_path, monkeypatch, stitch):
    """``predict`` from a NIfTI directory into ``*.nii`` with ``tta: true``,
    held against JAX's pipeline of the same stitch with the same flips,
    with the affine carried; a budget of a few KiB spills every volume to
    the host stitch under ``hbm_guard: warn`` (held against JAX the same
    way) and raises under ``error``."""
    _write_nifti_dir(tmp_path / "nii", run)
    out = tmp_path / "pred.nii"
    argv = _predict_argv(run, stitch, None, f"base.data={tmp_path / 'nii'}",
                         f"prediction.data={out}", "prediction.tta=true")
    assert predict.main(argv) == 0
    want, act = _jax_reference(run, stitch, (0, 1, 2))  # before the budget (JAX reads it too)
    monkeypatch.setenv("TPU_MEDNET_HBM_GB", "1e-5")
    spilled = tmp_path / "spilled.nii"
    assert predict.main([*argv, f"prediction.data={spilled}"]) == 0
    for path in (out, spilled):
        got = NiftiReader(path)
        for key in ("s3", "s4"):
            (mask,) = got.read([key], "prediction", dtype=None)
            assert_prediction_matches(np.asarray(mask), want[key], act[key],
                                      what=f"{path.name} {key}")
            np.testing.assert_allclose(
                got.get_data_attribute([key], "prediction", "affine")[key],
                np.diag([1.5, 1.5, 2.0, 1.0]))
    with pytest.raises(HBMBudgetError, match=f"'{stitch}' stitch path"):
        predict.main([*argv, "prediction.hbm_guard=error"])
