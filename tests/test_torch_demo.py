"""The port's ``demo`` against the JAX package's, and the quick start on the CPU.

Given the same ``--seed`` the two demos write the same stores, byte for
byte (zarr and HDF5 files as written, NIfTI volumes after gunzip, whose
header holds the time of writing), for ``--modalities 4``, ``--heatmaps 6``
and ``--classes 2``, and the same key files and YAML configs once the output
directory is substituted.  A re-run removes the previous run's checkpoints
and predictions.  Then the quick start as the port runs it on the CPU:
``demo`` -> ``train_seg`` (1 epoch) and ``train_ldmks`` (1 epoch) ->
``predict`` of each -> ``evaluate``, whose JSON equals the JAX package's
``evaluate`` on the same stores (NaN equal to NaN).
"""

import gzip
import json
from pathlib import Path

import pytest
import torch

from tests.test_torch_evaluate import same
from tpu_mednet.cli import demo as jax_demo
from tpu_mednet.cli import evaluate as jax_evaluate
from tpu_mednet_torch.cli import demo, evaluate, inspect_ckpt, predict, train_ldmks, train_seg

SMALL = ["--train", "2", "--val", "1", "--test", "1", "--size", "32", "--seed", "5"]


def tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): (gzip.decompress(p.read_bytes()) if p.suffix == ".gz"
                                       else p.read_bytes())
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small models run fastest on one thread beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fmt,extra", [
    ("zarr", ["--modalities", "4"]),
    ("zarr", ["--heatmaps", "6", "--sigma", "3"]),
    ("nii", ["--classes", "2", "--spacing", "1.5"]),
    ("h5", ["--modalities", "2", "--heatmaps", "3", "--classes", "2"]),
])
def test_demo_writes_what_jax_writes(tmp_path, capsys, fmt, extra):
    if fmt == "h5":
        pytest.importorskip("h5py")
    for name, mod in (("jax", jax_demo), ("port", demo)):
        assert mod.main(["--out", str(tmp_path / name), "--format", fmt, *SMALL, *extra]) == 0
    capsys.readouterr()
    ref, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(ref)
    for name in ref:
        if name.endswith(".yaml"):
            text = ref[name].decode().replace(str(tmp_path / "jax"), str(tmp_path / "port"))
            assert got[name].decode() == text, name
        else:
            assert got[name] == ref[name], name
    assert any(name.startswith("data.") for name in got)
    assert "pred_seg.h5" in got["predict_seg.yaml"].decode()


def test_rerun_removes_stale_outputs(tmp_path, caplog):
    out = tmp_path / "d"
    assert demo.main(["--out", str(out), "--format", "zarr", *SMALL]) == 0
    stale = [out / "model_seg" / "3", out / "model_ldmks", out / "pred_seg.h5",
             out / "pred_seg.zarr" / "prediction", out / "pred_ldmks.nii" / "prediction"]
    for p in stale:
        p.mkdir(parents=True) if p.suffix != ".h5" else p.write_bytes(b"x")
    (out / "notes.txt").write_text("mine")
    with caplog.at_level("WARNING"):
        assert demo.main(["--out", str(out), "--format", "zarr", *SMALL]) == 0
    for p in (out / "model_seg", out / "model_ldmks", out / "pred_seg.h5",
              out / "pred_seg.zarr", out / "pred_ldmks.nii"):
        assert not p.exists(), p
    assert (out / "notes.txt").exists() and (out / "data.zarr").is_dir()
    assert "removed stale outputs" in caplog.text
    with pytest.raises(SystemExit, match="--size must be >= 32"):
        demo.main(["--out", str(out), "--size", "16"])


def _evaluate_both(tmp_path, capsys, argv):
    results = []
    for name, mod in (("jax", jax_evaluate), ("port", evaluate)):
        path = tmp_path / f"eval_{name}.json"
        assert mod.main([*argv, "--json", str(path), "--log_level", "WARNING"]) == 0
        results.append(json.loads(path.read_text()))
        capsys.readouterr()
    assert same(results[1], results[0])
    return results[1]


def test_quick_start_on_the_cpu(tmp_path, capsys):
    """demo -> train_seg / train_ldmks -> predict -> evaluate, each through
    ``main(argv)`` as a user runs them, at the demo's configs with the
    sizes cut (f_maps 4, 16^3 patches, fp32)."""
    d = tmp_path / "demo"
    assert demo.main(["--out", str(d), "--format", "zarr", "--train", "3", "--val", "1",
                      "--test", "2", "--size", "32"]) == 0
    small = ["--device", "cpu", "--max_epochs", "1", "--fmaps", "4",
             "--patch_size", "16", "16", "16", "--no_bf16", "--log_level", "WARNING"]
    assert train_seg.main(["-c", str(d / "seg.yaml"), *small]) == 0
    # the demo's landmarks.yaml (as the JAX demo writes it) leaves the class
    # weights at the 2-entry default, one short of its 3 classes
    assert train_ldmks.main(["-c", str(d / "landmarks.yaml"), *small,
                             "--loss_class_weight", "0.05", "1.0", "1.0"]) == 0
    for short in ("seg", "ldmks"):
        assert predict.main(["-c", str(d / f"predict_{short}.yaml"), "--device", "cpu",
                             "--log_level", "WARNING",
                             f"prediction.data={d / f'pred_{short}.zarr'}",
                             "prediction.patch_size=[16, 16, 16]"]) == 0
    truth = ["--truth", str(d / "data.zarr"), "--subjects", str(d / "test.txt")]
    seg = _evaluate_both(tmp_path, capsys,
                         ["--pred", str(d / "pred_seg.zarr"), *truth, "--surface"])
    assert seg["n_subjects"] == 2 and seg["n_classes"] == 3
    assert 0.0 <= seg["mean"]["segmentation"][0]["dice"] <= 1.0
    ldmk = _evaluate_both(tmp_path, capsys, ["--pred", str(d / "pred_ldmks.zarr"), *truth])
    assert len(ldmk["mean"]["landmarks"]) == 2
    # inspect reports the best-val checkpoint the Trainer wrote
    assert inspect_ckpt.main(["--checkpoint", str(d / "model_seg"), "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    best_hp = next((d / "model_seg" / "best").glob("*/hparams.json"))
    assert info["best"] == json.loads(best_hp.read_text())["_best_monitor"]
    assert info["model"]["params"] == sum(
        v.numel() for v in torch.load(next((d / "model_seg").glob("[0-9]*/model.pt")),
                                      weights_only=True)["params"].values())
