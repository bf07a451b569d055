"""``--spatial_shards`` through the training CLI and the Trainer, against the JAX package's.

``train_seg --device cpu --gpus 4 --spatial_shards 2`` starts four gloo
ranks on the CPU (a 2 x 2 (data, space) mesh, the counterpart of the JAX
CLI's ``make_mesh(n_data=2, n_space=2)`` over 4 of its 8 virtual CPU
devices), killed after ``RANK_TIMEOUT``; the logged losses and
validation means agree with the JAX CLI's at atol 1e-5 (the Trainer's
bound), from the same initial weights.  Rank 0 runs the MIP visualizer
alone, on the whole first row, and nothing hangs.  JAX's refusals are
held with their words: a space axis that does not divide the devices,
one that crosses nodes, the device sampler, a patch X extent the axis does
not divide.
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import REPO, run_launch
from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data import PatchSampler as JaxPatchSampler
from tpu_mednet.data.device_sampler import DevicePatchSampler as JaxDevicePatchSampler
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.parallel.mesh import make_mesh as jax_make_mesh
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.train import Trainer as JaxTrainer
from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader, PatchSampler, zarrlite
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.parallel.mesh import DataMesh
from tpu_mednet_torch.tasks import SegmentationTask
from tpu_mednet_torch.train import Trainer

SUBJECTS = {"a": (40, 20, 20), "b": (36, 22, 18), "c": (34, 18, 22), "d": (38, 20, 20)}


def _write_store(root: Path) -> None:
    rng = np.random.default_rng(3)
    z = zarrlite.open(str(root / "data.zarr"), mode="w")
    for key, shape in SUBJECTS.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 6:20, 4:12, 3:11] = 1
        lbl[0, 22:30, 10:16, 9:17] = 2
        img = (rng.normal(0, 0.5, size=(1, *shape)) + lbl).astype(np.float32)
        z.require_group("images").create_dataset(key, data=img)
        z.require_group("labels").create_dataset(key, data=lbl)
    (root / "train.txt").write_text("a\nb\nc\n")
    (root / "val.txt").write_text("d\n")


def _argv(root: Path, tag: str, *extra):
    """seg_organ.yaml at a small size, without its augmentation (the
    packages draw it from other generators), on a 32 x 16 x 16 patch: X
    splits into two slabs of whole 16-voxel pooling windows.  SGD with
    momentum: Adam's first steps move a parameter by ±lr where its
    gradient is noise, which summation order alone decides."""
    config = root / "seg_organ.yaml"
    if not config.exists():
        config.write_text("".join(line for line in (REPO / "configs" / "seg_organ.yaml")
                                  .read_text().splitlines(keepends=True)
                                  if not line.startswith("data_augmentation")))
    return ["-c", str(config), "--data_path", str(root / "data.zarr"),
            "--train_set", str(root / "train.txt"), "--val_set", str(root / "val.txt"),
            "--model_dir", str(root / f"{tag}_model"), "--log_dir", str(root / f"{tag}_logs"),
            "--patch_size", "32", "16", "16", "--fmaps", "4", "--out_channels", "3",
            "--class_probabilities", "0.4", "0.3", "0.3", "--patches_per_subject", "2",
            "--batch_size", "2", "--no_bf16", "--max_epochs", "2", "--gpus", "4",
            "--spatial_shards", "2", "--optimizer", "sgd", "--learning_rate", "0.05", *extra]


def test_train_seg_spatial_shards_equals_jax_cli(tmp_path):
    from tpu_mednet.cli import train_seg as jax_train_seg
    from tpu_mednet.config import parse_with_config as jax_parse
    from tpu_mednet.train import create_train_state as jax_create_train_state
    from tpu_mednet_torch.cli import train_seg
    from tpu_mednet_torch.config import parse_with_config
    from tpu_mednet_torch.train import CheckpointManager, OptimizerConfig, create_train_state
    from tpu_mednet_torch.utils.weights import load_jax_params

    _write_store(tmp_path)
    jax_argv = _argv(tmp_path, "jax")
    assert jax_train_seg.main(jax_argv) == 0
    jhp = jax_parse(jax_train_seg.build_parser(), jax_argv)
    jtask = JaxSegmentationTask.from_hparams(jhp)
    init = jax_create_train_state(jtask.model, (jhp.batch_size, *jhp.patch_size, 1),
                                  jhp.learning_rate, seed=jhp.seed).params
    argv = ["--device", "cpu", *_argv(tmp_path, "port", "--resume", str(tmp_path / "init"),
                                      "--log_vis_mip", "mean", "--log_interval", "1")]
    hp = parse_with_config(train_seg.build_parser(), argv)
    task = SegmentationTask.from_hparams(hp, device="cpu")
    load_jax_params(task.model, {"params": jax.tree.map(np.asarray, init)})
    state = create_train_state(task.model, hp.learning_rate, seed=hp.seed,
                               optimizer=OptimizerConfig.from_hparams(hp))
    CheckpointManager(tmp_path / "init").save(0, state, vars(hp))

    rc, out = run_launch([sys.executable, "-m", "tpu_mednet_torch.cli.train_seg", *argv],
                         env={**os.environ, "TPU_MEDNET_NO_NATIVE": "1", "OMP_NUM_THREADS": "1"})
    assert rc == 0, out[-4000:]

    def records(log_dir):
        return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text()
                .splitlines()]

    got, want = records(tmp_path / "port_logs"), records(tmp_path / "jax_logs")
    for name in ("train_loss", "val_loss", "val_dice0", "val_dice1", "val_dice2"):
        g = {r["step"]: r[name] for r in got if name in r}
        w = {r["step"]: r[name] for r in want if name in r}
        assert sorted(g) == sorted(w) and g, name
        for s in w:
            assert abs(g[s] - w[s]) <= 1e-5, (name, s, g[s], w[s])
    assert len(got) == len(want)
    assert CheckpointManager(tmp_path / "port_model").available_steps == [3, 6]
    # the visualizer ran on rank 0 alone, on the whole first row of each
    # validation batch, and logged its figures once
    logs = tmp_path / "port_logs"
    figures = list((logs / "figures").glob("*.png")) if (logs / "figures").exists() else []
    assert figures or list(logs.glob("events.out.tfevents*"))


def test_spatial_shards_that_do_not_divide_the_devices_are_refused_as_jax(tmp_path):
    from tpu_mednet.cli import train_seg as jax_train_seg
    from tpu_mednet_torch.cli import train_seg

    _write_store(tmp_path)
    argv = _argv(tmp_path, "x", "--spatial_shards", "3")
    with pytest.raises(SystemExit) as want:
        jax_train_seg.main(argv)
    with pytest.raises(SystemExit) as got:
        train_seg.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value) == \
        "--spatial_shards 3 must divide the device count (4)"


def _samplers(patch, device_sampler=False):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(1, 24, 24, 24)).astype(np.float32)
    store = {"images": {"s": img}, "labels": {"s": (img > 0.5).astype(np.uint8)}}
    if device_sampler:
        return (JaxDevicePatchSampler(None, ["s"], 4, patch, reader=JaxMemoryReader(store)),
                DevicePatchSampler(None, ["s"], 4, patch, reader=MemoryReader(store),
                                   device="cpu"))
    return (JaxPatchSampler(None, ["s"], samples_per_subject=4, patch_size=patch,
                            reader=JaxMemoryReader(store), seed=0),
            PatchSampler(None, ["s"], samples_per_subject=4, patch_size=patch,
                         reader=MemoryReader(store), seed=0))


@pytest.mark.parametrize("case", ["device_sampler", "across_nodes", "patch_x"])
def test_trainer_refusals_equal_jax(case, monkeypatch):
    jtask = JaxSegmentationTask(model=UNet3DBase(config=UNetConfig(
        in_channels=1, out_channels=2, f_maps=4, num_levels=2, num_groups=2,
        dtype=jnp.float32)))
    task = SegmentationTask(model=ResidualUNet3D(1, 2, f_maps=4, num_levels=2, num_groups=2,
                                                 dtype=torch.float32, device="cpu"))
    cpu = torch.device("cpu")
    jmesh = jax_make_mesh(n_data=2, n_space=4)
    mesh = DataMesh(rank=0, world_size=8, devices=(cpu,) * 8, n_space=4)
    patch = [9, 8, 8] if case == "patch_x" else [8, 8, 8]
    jsampler, sampler = _samplers(patch, device_sampler=case == "device_sampler")
    if case == "across_nodes":
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "local_device_count", lambda: 2)
        mesh = DataMesh(rank=0, world_size=8, devices=(cpu,) * 2, node_count=4, n_space=4)
    with pytest.raises(ValueError) as want:
        JaxTrainer(jtask, jsampler, batch_size=2, mesh=jmesh)
    with pytest.raises(ValueError) as got:
        Trainer(task, sampler, batch_size=2, mesh=mesh)
    assert str(got.value) == str(want.value)
