"""The port's reference-checkpoint interop against the JAX package's:
``utils/torch_import.py``, ``cli/import_torch.py``, ``utils/torch_export.py``
and ``cli/export_torch.py``.

The same reference-style files (seeded weights of the port's model, whose
state dict carries the reference's names, wrapped as a PL ``.ckpt`` with an
``hparams`` Namespace or a ``hyper_parameters`` dict, or saved bare; and a
``double``-family state dict) go through both packages:

- ``load_torch_checkpoint`` and ``infer_architecture`` return the same
  weights (bit-equal), hparams, step and architecture;
- every refusal of ``import_torch`` carries the JAX package's message;
- the port's imported ``model.pt`` is bit-equal to the source state dict
  and to ``state_dict_from_jax`` of the JAX package's imported params, its
  side-car equal to the JAX package's; the imported model's fp32 forward
  matches JAX's within atol 1e-4 (the serving tolerance on record);
- the port's export of its import equals the JAX package's export of its
  import: ``state_dict`` bit-equal, the ``hparams`` Namespace, ``global_step``
  and ``epoch`` equal; the JAX package's import reads the port's ``.ckpt``
  into the same params; ``--no_ema`` and ``--step`` pick what they name;
- an imported directory resumes training through ``train_seg --resume``.
"""

import argparse
import json
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.cli import export_torch as jax_export_torch
from tpu_mednet.cli import import_torch as jax_import_torch
from tpu_mednet.cli.predict import _coerce
from tpu_mednet.utils import torch_import as jax_torch_import
from tpu_mednet_torch.cli import export_torch, import_torch, train_seg
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
from tpu_mednet_torch.train import CheckpointManager, OptimizerConfig, create_train_state
from tpu_mednet_torch.utils import torch_import
from tpu_mednet_torch.utils.torch_export import PORT_ONLY_HPARAMS, save_reference_checkpoint
from tpu_mednet_torch.utils.weights import state_dict_from_jax

F_MAPS = (4, 8)
SEG_HP = dict(in_channels=1, out_channels=3, fmaps=4, learning_rate=0.002, loss="DICE",
              loss_weight=[0.2, 1.0, 1.0], batch_size=2)
LDMK_HP = dict(SEG_HP, out_channels=5, loss_regression_weight=[0.01, 0.02, 0.03])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_state_dict(out_channels=3, f_maps=F_MAPS, seed=3):
    model = ResidualUNet3D(1, out_channels, f_maps=f_maps, num_levels=len(f_maps),
                           dtype=torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    return model.state_dict()


def double_state_dict():
    """The keys ``infer_architecture`` reads of a 2-level DoubleConv UNet3D
    (``SingleConv1..2`` blocks), at its shapes."""
    rng = np.random.default_rng(4)
    shapes = {"encoders.0.basic_module.SingleConv1.conv.weight": (4, 2, 3, 3, 3),
              "encoders.0.basic_module.SingleConv2.conv.weight": (8, 4, 3, 3, 3),
              "encoders.1.basic_module.SingleConv1.conv.weight": (8, 8, 3, 3, 3),
              "encoders.1.basic_module.SingleConv2.conv.weight": (16, 8, 3, 3, 3),
              "final_conv.weight": (3, 8, 1, 1, 1), "final_conv.bias": (3,)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}


def write_ckpt(path: Path, sd, style: str, hparams=None, step=12) -> Path:
    if style == "hparams":
        obj = {"state_dict": sd, "hparams": argparse.Namespace(**hparams),
               "global_step": step, "epoch": 3}
    elif style == "hyper_parameters":
        obj = {"state_dict": {f"model.{k}": v for k, v in sd.items()},
               "hyper_parameters": dict(hparams), "global_step": step}
    else:
        obj = dict(sd)
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("family", ["residual", "double"])
@pytest.mark.parametrize("style", ["hparams", "hyper_parameters", "bare"])
def test_load_and_infer_equal_jax(tmp_path, family, style):
    sd = seeded_state_dict() if family == "residual" else double_state_dict()
    path = write_ckpt(tmp_path / "x.ckpt", sd, style, SEG_HP)
    got_sd, got_hp, got_step = torch_import.load_torch_checkpoint(path)
    ref_sd, ref_hp, ref_step = jax_torch_import.load_torch_checkpoint(path)
    assert sorted(got_sd) == sorted(ref_sd) == sorted(sd)
    for k, v in got_sd.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), ref_sd[k]), k
    assert got_hp == ref_hp and got_step == ref_step
    assert (got_hp, got_step) == ((None, 0) if style == "bare" else (SEG_HP, 12))
    assert torch_import.infer_architecture(got_sd) == jax_torch_import.infer_architecture(ref_sd)
    # numpy values infer alike
    assert (torch_import.infer_architecture(ref_sd)
            == jax_torch_import.infer_architecture(ref_sd))
    with pytest.raises(ValueError) as ours:
        torch_import.infer_architecture({"final_conv.weight": sd["final_conv.weight"]})
    with pytest.raises(ValueError) as theirs:
        jax_torch_import.infer_architecture({"final_conv.weight": ref_sd["final_conv.weight"]})
    assert str(ours.value) == str(theirs.value)


REFUSALS = {
    "double": (double_state_dict, "bare", None, []),
    "in_channels": (seeded_state_dict, "hparams", SEG_HP, ["--set", "in_channels=2"]),
    "out_channels": (seeded_state_dict, "hparams", dict(SEG_HP, out_channels=4), []),
    "fmaps": (seeded_state_dict, "hparams", dict(SEG_HP, fmaps=8), []),
    "fmaps_list": (seeded_state_dict, "hyper_parameters", dict(SEG_HP, fmaps=[4, 16]), []),
    "model": (seeded_state_dict, "hparams", SEG_HP, ["--model", "LandmarkNet"]),
    "model_ldmk": (lambda: seeded_state_dict(5), "hparams", LDMK_HP,
                   ["--model", "SegmentationNet"]),
    # a weight that reads as set in the side-car but coerces to nothing
    "regression_weight": (lambda: seeded_state_dict(5), "hparams",
                          dict(SEG_HP, out_channels=5, loss_regression_weight="None"), []),
    "set_syntax": (seeded_state_dict, "bare", None, ["--set", "bf16"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_import_refusals_equal_jax(tmp_path, case):
    make, style, hp, extra = REFUSALS[case]
    path = write_ckpt(tmp_path / "x.ckpt", make(), style, hp)
    messages = []
    for name, mod in (("jax", jax_import_torch), ("port", import_torch)):
        with pytest.raises(SystemExit) as exc:
            mod.main(["--checkpoint", str(path), "--output", str(tmp_path / name), *extra])
        messages.append(str(exc.value.code))
    assert messages[1] == messages[0]
    assert not (tmp_path / "port").exists() or not any((tmp_path / "port").iterdir())


def jax_imported(out_dir: Path):
    """(variables, hparams, task) of the JAX package's import at ``out_dir``."""
    from tpu_mednet.inference.serving import detect_task_name
    from tpu_mednet.tasks import LandmarkTask as JaxLandmarkTask
    from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
    from tpu_mednet.train import create_train_state as jax_create_train_state
    from tpu_mednet.train.checkpoint import CheckpointManager as JaxCheckpointManager
    from tpu_mednet.train.checkpoint import load_for_inference

    mgr = JaxCheckpointManager(out_dir)
    try:
        hp = mgr.restore_hparams()
    finally:
        mgr.close()
    ns = SimpleNamespace(**{k: _coerce(v) for k, v in hp.items()})
    task = (JaxLandmarkTask if detect_task_name(hp) == "LandmarkNet"
            else JaxSegmentationTask).from_hparams(ns)
    div = 2 ** (len(task.model.config.feature_maps) - 1)
    template = jax_create_train_state(task.model, (1, div, div, div, ns.in_channels),
                                      learning_rate=float(ns.learning_rate))
    variables, hp = load_for_inference(out_dir, template)
    return variables, hp, task


@pytest.mark.parametrize("landmarks", [False, True])
def test_import_equals_jax(tmp_path, landmarks):
    hp = LDMK_HP if landmarks else SEG_HP
    sd = seeded_state_dict(hp["out_channels"])
    path = write_ckpt(tmp_path / "x.ckpt", sd, "hparams", hp)
    argv = ["--checkpoint", str(path), "--set", "bf16=False", "loss_class_weight=0.1,1.0"]
    assert jax_import_torch.main([*argv, "--output", str(tmp_path / "jax")]) == 0
    assert import_torch.main([*argv, "--output", str(tmp_path / "port")]) == 0

    mgr = CheckpointManager(tmp_path / "port")
    assert mgr.available_steps == [12]
    weights, port_hp = mgr.restore_weights(), mgr.restore_hparams()
    assert weights["ema"] is None
    assert sorted(weights["params"]) == sorted(sd)
    assert all(torch.equal(weights["params"][k], sd[k]) for k in sd)
    train = torch.load(tmp_path / "port" / "12" / "train_state.pt", weights_only=True)
    assert (train["step"], train["updates"]) == (12, 0)

    variables, jax_hp, jax_task = jax_imported(tmp_path / "jax")
    from_jax = state_dict_from_jax(variables)
    assert all(torch.equal(weights["params"][k], from_jax[k]) for k in sd)
    assert port_hp == jax_hp
    assert port_hp["fmaps"] == list(F_MAPS) and port_hp["loss_class_weight"] == [0.1, 1.0]

    # the imported model's fp32 forward against the JAX package's
    ns = SimpleNamespace(**{k: _coerce(v) for k, v in port_hp.items()})
    task = (LandmarkTask if landmarks else SegmentationTask).from_hparams(ns, device="cpu")
    task.model.load_state_dict(weights["params"])
    x = np.random.default_rng(5).normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    ref = np.asarray(jax_task.model.apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        y = task.model(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-4)


def test_bare_state_dict_with_overrides_equals_jax(tmp_path):
    """A bare state dict, the task and its heatmap count from ``--set``."""
    path = write_ckpt(tmp_path / "w.pt", seeded_state_dict(5), "bare")
    argv = ["--checkpoint", str(path), "--model", "LandmarkNet", "--set",
            "loss_regression_weight=0.001,0.015,0.015", "learning_rate=0.0005"]
    assert jax_import_torch.main([*argv, "--output", str(tmp_path / "jax")]) == 0
    assert import_torch.main([*argv, "--output", str(tmp_path / "port")]) == 0
    port_hp = CheckpointManager(tmp_path / "port").restore_hparams(step=0)
    _, jax_hp, _ = jax_imported(tmp_path / "jax")
    assert port_hp == jax_hp
    assert port_hp["loss_regression_weight"] == [0.001, 0.015, 0.015]
    assert port_hp["in_channels"] == 1 and port_hp["out_channels"] == 5


def load_ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_export_of_the_import_equals_jax(tmp_path):
    sd = seeded_state_dict()
    hp = dict(SEG_HP, remat=1, packed=True, bf16=False, device_sampler=True)
    path = write_ckpt(tmp_path / "x.ckpt", sd, "hparams", hp, step=7)
    for name, imp, exp in (("jax", jax_import_torch, jax_export_torch),
                           ("port", import_torch, export_torch)):
        assert imp.main(["--checkpoint", str(path), "--output", str(tmp_path / name)]) == 0
        assert exp.main(["--checkpoint", str(tmp_path / name),
                         "--output", str(tmp_path / f"{name}.ckpt")]) == 0
    ref, got = load_ckpt(tmp_path / "jax.ckpt"), load_ckpt(tmp_path / "port.ckpt")
    assert sorted(got) == sorted(ref) == ["epoch", "global_step", "hparams", "state_dict"]
    assert sorted(got["state_dict"]) == sorted(ref["state_dict"]) == sorted(sd)
    for k, v in got["state_dict"].items():
        assert v.dtype == ref["state_dict"][k].dtype == torch.float32
        assert torch.equal(v, ref["state_dict"][k]) and torch.equal(v, sd[k]), k
    assert isinstance(got["hparams"], argparse.Namespace)
    assert got["hparams"] == ref["hparams"]
    assert not PORT_ONLY_HPARAMS & set(vars(got["hparams"]))
    assert (got["global_step"], got["epoch"]) == (ref["global_step"], ref["epoch"]) == (7, 0)

    # the JAX package's import reads the port's .ckpt into the same params
    assert jax_import_torch.main(["--checkpoint", str(tmp_path / "port.ckpt"),
                                  "--output", str(tmp_path / "jax_of_port")]) == 0
    variables, _, _ = jax_imported(tmp_path / "jax_of_port")
    back = state_dict_from_jax(variables)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_export_no_ema_and_step(tmp_path):
    """An EMA run's checkpoint: EMA weights by default, the raw ones with
    ``--no_ema``; ``--step`` exports a retained earlier step."""
    model = ResidualUNet3D(1, 3, f_maps=F_MAPS, num_levels=2, dtype=torch.float32,
                           device="cpu", generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, optimizer=OptimizerConfig(ema_decay=0.9))
    hp = dict(SEG_HP, ema_decay=0.9)
    mgr = CheckpointManager(tmp_path / "run")
    snapshots = {}
    for step, scale in ((4, 0.5), (9, 0.25)):
        with torch.no_grad():
            for k, p in model.named_parameters():
                state.ema[k].copy_(p * scale)
        mgr.save(step, state, hparams=hp)
        snapshots[step] = ({k: v.clone() for k, v in model.state_dict().items()},
                           {k: v.clone() for k, v in state.ema.items()})
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    for argv, step, use_ema in (([], 9, True), (["--no_ema"], 9, False),
                                (["--step", "4"], 4, True), (["--step", "4", "--no_ema"], 4, False)):
        out = tmp_path / "x.ckpt"
        assert export_torch.main(["--checkpoint", str(tmp_path / "run"), "--output", str(out),
                                  *argv]) == 0
        ckpt = load_ckpt(out)
        want = snapshots[step][1 if use_ema else 0]
        assert ckpt["global_step"] == step
        assert all(torch.equal(ckpt["state_dict"][k], want[k]) for k in want), argv
        assert vars(ckpt["hparams"])["ema_decay"] == 0.9
    # a directory without a side-car is refused, as in the JAX package
    CheckpointManager(tmp_path / "bare").save(1, state)
    with pytest.raises(SystemExit, match="no hparams side-car"):
        export_torch.main(["--checkpoint", str(tmp_path / "bare"), "--output", str(out)])
    # and the writer alone, on tensors of any device and dtype
    save_reference_checkpoint(out, {"a": torch.ones(2, dtype=torch.float64)})
    assert load_ckpt(out)["state_dict"]["a"].dtype == torch.float32


def test_check_against_template_names_every_mismatch():
    sd = seeded_state_dict()
    meta = ResidualUNet3D(1, 3, f_maps=F_MAPS, num_levels=2, device="meta")
    torch_import.check_against_template(sd, meta.state_dict())
    wrong = ResidualUNet3D(1, 4, f_maps=F_MAPS, num_levels=2, device="meta")
    with pytest.raises(ValueError, match="shape mismatch.*final_conv.weight"):
        torch_import.check_against_template(sd, wrong.state_dict())
    partial = {k: v for k, v in sd.items() if k != "final_conv.bias"}
    with pytest.raises(ValueError, match=r"missing from checkpoint: \['final_conv.bias'\]"):
        torch_import.check_against_template(partial, meta.state_dict())


def test_imported_checkpoint_resumes_training(tmp_path):
    """``train_seg --resume`` continues from an imported directory: its
    epoch accounting starts at the ``.ckpt``'s global step."""
    f_maps = (4, 8, 16, 32, 64)
    sd = seeded_state_dict(2, f_maps)
    path = write_ckpt(tmp_path / "x.ckpt", sd, "hparams",
                      dict(SEG_HP, out_channels=2, loss_weight=None), step=4)
    assert import_torch.main(["--checkpoint", str(path), "--output", str(tmp_path / "run"),
                              "--set", "bf16=False"]) == 0
    rng = np.random.default_rng(0)
    images, labels = VolumeGroup(), VolumeGroup()
    for key in ("s0", "s1"):
        lbl = np.zeros((1, 16, 16, 16), np.uint8)
        lbl[0, 4:12, 4:12, 4:12] = 1
        images.require_dataset(key, lbl.shape, np.float32)[:] = rng.normal(size=lbl.shape) + lbl
        labels.require_dataset(key, lbl.shape, np.uint8)[:] = lbl
    images.save(tmp_path / "data.zarr", group="images")
    labels.save(tmp_path / "data.zarr", group="labels")
    (tmp_path / "keys.txt").write_text("s0\ns1\n")
    assert train_seg.main([
        "--data_path", str(tmp_path / "data.zarr"), "--train_set", str(tmp_path / "keys.txt"),
        "--val_set", str(tmp_path / "keys.txt"), "--model_dir", str(tmp_path / "run"),
        "--log_dir", str(tmp_path / "logs"), "--resume", str(tmp_path / "run"),
        "--patch_size", "16", "16", "16", "--patches_per_subject", "2", "--batch_size", "2",
        "--fmaps", "4", "--out_channels", "2", "--no_bf16", "--max_epochs", "3",
        "--learning_rate", "0.002", "--device", "cpu", "--log_level", "WARNING"]) == 0
    # 2 steps an epoch: the import's step 4 is epoch 2, so one epoch runs
    assert CheckpointManager(tmp_path / "run").available_steps == [4, 6]
    metrics = [json.loads(line) for line in
               (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert metrics and all(m.get("epoch", 2) == 2 for m in metrics)
