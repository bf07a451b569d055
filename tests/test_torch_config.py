"""The port's config layer against the JAX package's, on the CPU.

- ``load_yaml_config`` gives the JAX package's values on every
  ``configs/*.yaml`` and every kind of dotted override value;
- the port's argument groups parse every argv to the JAX parser's
  namespace (``--device`` aside), with and without ``-c``;
- ``validate_task_config`` refuses the same inputs;
- in a fresh interpreter where h5py, zarr, tensorboardX, matplotlib and
  tqdm cannot be imported, every module of the port imports and both CLIs
  answer ``--help`` and load ``configs/seg_organ.yaml``.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import yaml

from tpu_mednet import config as jax_config
from tpu_mednet.cli import predict as jax_predict
from tpu_mednet.cli import train_seg as jax_train_seg
from tpu_mednet_torch import config
from tpu_mednet_torch.cli import predict, train_seg

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_yaml_config_equals_jax_on_every_config(path):
    assert config.load_yaml_config(path) == jax_config.load_yaml_config(path)


@pytest.mark.parametrize("value", [
    "16", "[96, 96, 96]", "[16,16,16]", "device", "crop", "", "null", "~", "None",
    "true", "False", "off", "yes", "1e-3", "0.001", "1.0e-3", "-2", "+3", ".5", "3.",
    "1_000", ".inf", "-.inf", "'quoted # not a comment'", '"double"', "$MODEL/p.zarr",
    "[]", "[a, 'b c', 1.5, null]", "x  # a comment", "two words",
])
def test_load_yaml_config_override_values_equal_jax(value):
    path = REPO / "configs" / "predict.yaml"
    overrides = [f"prediction.value={value}"]
    assert config.load_yaml_config(path, overrides) == \
        jax_config.load_yaml_config(path, overrides)


def test_load_yaml_config_with_overrides_equals_jax(tmp_path):
    overrides = ["prediction.batch_size=16", "prediction.stitch=device",
                 "prediction.patch_size=[64, 64, 64]", "prediction.checkpoint_step=null",
                 "base.extra.deep=1.5", "prediction.use_ema=false"]
    path = REPO / "configs" / "predict.yaml"
    assert config.load_yaml_config(path, overrides) == \
        jax_config.load_yaml_config(path, overrides)


def _parsers():
    jax_parser, port_parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_config.add_common_train_args(jax_parser)
    jax_config.add_seg_model_args(jax_parser)
    config.add_common_train_args(port_parser)
    config.add_seg_model_args(port_parser)
    return jax_parser, port_parser


ARGVS = [
    [],
    ["-c", "configs/seg_organ.yaml"],
    ["-c", "configs/seg_organ.yaml", "--batch_size", "2", "--patch_size", "64", "64", "64",
     "--no_bf16", "--optimizer", "adamw", "--weight_decay", "0.01", "--nonfinite", "skip"],
    ["-c", "configs/seg_brats_bf16.yaml", "--lr_schedule", "cosine", "--warmup_steps", "5",
     "--aug_mirror", "--ema_decay", "0.99", "--accumulate_grad_batches", "2"],
    ["-c", "configs/seg_tiny.yaml", "--device_sampler", "--no_native_loader",
     "--class_probabilities", "0.5", "0.5", "--loss", "CE", "--loss_weight", "1", "2"],
    ["--data_path", "$DATA/x.h5", "--train_set", "${DATA}/t.txt", "--resume", "/m",
     "--track_grad_norm", "--grad_clip_norm", "1.0", "--adam_eps", "1e-6"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:2]) or "defaults")
def test_parse_equals_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("DATA", "/data")
    monkeypatch.setenv("MODEL", "/models")
    jax_parser, port_parser = _parsers()
    want = vars(jax_config.parse_with_config(jax_parser, argv))
    assert vars(config.parse_with_config(port_parser, argv)) == want
    cli = vars(config.parse_with_config(train_seg.build_parser(), argv))
    assert cli.pop("device") == "cuda"
    assert cli == vars(config.parse_with_config(jax_train_seg.build_parser(), argv))


def test_predict_parser_equals_jax():
    argv = ["-c", "configs/predict.yaml", "prediction.batch_size=4", "--log_level", "DEBUG"]
    got = vars(predict.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jax_predict.build_parser().parse_args(argv))


@pytest.mark.parametrize("hp", [
    dict(out_channels=3, loss_weight=[1.0, 2.0], class_probabilities=None, batch_size=4),
    dict(out_channels=2, loss_weight=None, class_probabilities=[0.2, 0.4, 0.4], batch_size=4),
    dict(out_channels=3, loss_weight=[1, 1, 1], class_probabilities=[0.5, 0.5], batch_size=4),
    dict(out_channels=5, loss_weight=None, class_probabilities=[0.2] * 5, batch_size=3),
])
@pytest.mark.parametrize("n_data", [1, 2])
def test_validate_task_config_refuses_what_jax_refuses(hp, n_data):
    def outcome(fn):
        try:
            fn(SimpleNamespace(**hp), "seg", n_data=n_data)
        except SystemExit:
            return True
        return False

    assert outcome(config.validate_task_config) == outcome(jax_config.validate_task_config)


def test_augment_config_from_hparams():
    parser = argparse.ArgumentParser()
    config.add_common_train_args(parser)
    assert config.augment_config_from_hparams(parser.parse_args([])) is None
    aug = config.augment_config_from_hparams(parser.parse_args(["--aug_mirror"]))
    assert aug.mirror_axes == (1, 2, 3) and aug.gamma_range == (0.7, 1.3)
    # the spatial flags build the JAX package's AugmentConfig, field for field
    jax_parser = argparse.ArgumentParser()
    jax_config.add_common_train_args(jax_parser)
    for argv in (["--aug_rotate_deg", "10"],
                 ["--aug_elastic_sigma", "3", "--aug_elastic_grid", "6", "--aug_rotate_deg",
                  "15", "--aug_scale", "0.85", "1.25", "--aug_spatial_prob", "0.5",
                  "--aug_mirror"]):
        aug = config.augment_config_from_hparams(parser.parse_args(argv))
        ref = jax_config.augment_config_from_hparams(jax_parser.parse_args(argv))
        assert aug.wants_spatial() and ref.wants_spatial()
        assert dataclasses.asdict(aug) == dataclasses.asdict(ref)
    for value, want in (("0", False), ("false", False), ("all", True), ("true", True),
                        ("1", 1), ("3", 3), (True, True)):
        assert config.parse_remat(value) == jax_config.parse_remat(value) == want


def test_env_expansion_and_keyfile(tmp_path, monkeypatch):
    monkeypatch.setenv("DATA", str(tmp_path))
    (tmp_path / "keys.txt").write_text("a\n\n b \nc\n")
    assert config.read_keyfile("$DATA/keys.txt") == ["a", "b", "c"]
    assert config.replace_env("${DATA}/x/$NOPE") == f"{tmp_path}/x/$NOPE"
    (tmp_path / ".env").write_text("# c\nFOO_FROM_ENV='bar'\n")
    monkeypatch.setenv("FOO_FROM_ENV", "")
    monkeypatch.delenv("FOO_FROM_ENV")  # restored (removed) after the test
    config.load_dotenv(str(tmp_path / ".env"))
    assert __import__("os").environ["FOO_FROM_ENV"] == "bar"


def test_port_runs_without_the_packages_the_card_lacks():
    """What the card's machine lacks is blocked; the port must not need it."""
    want = yaml.safe_load((REPO / "configs" / "seg_organ.yaml").read_text())
    code = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        BLOCKED = ("h5py", "zarr", "tensorboardX", "matplotlib", "tqdm")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, Block())
        import tpu_mednet_torch
        names = [m.name for m in pkgutil.walk_packages(tpu_mednet_torch.__path__,
                                                       "tpu_mednet_torch.")]
        for name in names:
            importlib.import_module(name)
        from tpu_mednet_torch import config
        from tpu_mednet_torch.cli import predict, train_seg
        for main in (train_seg.main, predict.main):
            try:
                main(["--help"])
            except SystemExit as exc:
                assert exc.code == 0, exc.code
        assert config.load_yaml_file("configs/seg_organ.yaml") == json.loads({json.dumps(json.dumps(want))})
        ns = config.parse_with_config(train_seg.build_parser(),
                                      ["-c", "configs/seg_organ.yaml"])
        assert ns.patch_size == [128, 128, 128] and ns.out_channels == 5, ns
        assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        print("ok", len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].split()[0] == "ok"
