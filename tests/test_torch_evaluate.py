"""The port's evaluation metrics and ``evaluate`` CLI against the JAX package's.

Both packages run the same numpy and scipy operations, so every number is
held exactly: the same seeded inputs go through ``tpu_mednet.utils.evaluation``
and ``tpu_mednet_torch.utils.evaluation``, and the two ``evaluate`` CLIs write
JSON that parses to the same dict (NaN equal to NaN, infinities equal).
Cases: an empty class, the class count growing across subjects (rows
padded with NaN), anisotropic and rotated affines, ``--surface``, landmark
scoring with the heatmap group detected, explicit ``--classes`` and
``--heatmap_group``, and a NIfTI prediction directory.
"""

import json
import math

import numpy as np
import pytest

from tpu_mednet.cli import evaluate as jax_evaluate
from tpu_mednet.utils import evaluation as jax_ev
from tpu_mednet_torch.cli import evaluate
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.utils import evaluation as ev

SHAPE = (14, 12, 10)
AFFINES = {
    "s0": np.diag([1.5, 0.8, 2.5, 1.0]),
    # a rotation about z with anisotropic spacing: the spacing is the
    # column norms, not the diagonal
    "s1": np.array([[0.0, -1.2, 0.0, 10.0], [0.9, 0.0, 0.0, -4.0],
                    [0.0, 0.0, 3.0, 2.0], [0.0, 0.0, 0.0, 1.0]]),
    "s2": np.diag([-1.0, -1.0, 1.25, 1.0]),
}


def same(a, b) -> bool:
    """Equality of JSON-like trees with NaN equal to NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def _masks(rng, n_classes):
    true = np.zeros(SHAPE, np.uint8)
    true[2:9, 3:9, 1:7] = 1
    if n_classes > 2:
        true[9:13, 1:5, 5:9] = 2
    pred = true.copy()
    flip = rng.random(SHAPE) < 0.08
    pred[flip] = rng.integers(0, n_classes, size=int(flip.sum()))
    return pred, true


def test_metric_functions_equal_jax():
    rng = np.random.default_rng(0)
    pred, true = _masks(rng, 3)
    # class 3 is absent from both (nan), class 4 predicted only (inf/0)
    pred[0, 0, :2] = 4
    for c in (3, 5, 6):
        spacing = ev.spacing_from_affine(AFFINES["s1"])
        np.testing.assert_array_equal(spacing, jax_ev.spacing_from_affine(AFFINES["s1"]))
        assert same(ev.overlap_metrics(pred, true, c), jax_ev.overlap_metrics(pred, true, c))
        assert same(ev.surface_distances(pred, true, c, spacing=spacing),
                    jax_ev.surface_distances(pred, true, c, spacing=spacing))
    assert same(ev.surface_distances(pred, true, 5), jax_ev.surface_distances(pred, true, 5))
    np.testing.assert_array_equal(ev.spacing_from_affine(None), jax_ev.spacing_from_affine(None))
    b = pred == 1
    np.testing.assert_array_equal(ev._boundary(b), jax_ev._boundary(b))

    hm_true = rng.random((3, *SHAPE)).astype(np.float32)
    hm_true[2] = 0  # a missing landmark scores nan
    hm_pred = rng.random((3, *SHAPE)).astype(np.float32)
    for spacing in (None, [1.5, 0.8, 2.5]):
        assert same(ev.landmark_errors(hm_pred, hm_true, spacing=spacing),
                    jax_ev.landmark_errors(hm_pred, hm_true, spacing=spacing))
    with pytest.raises(ValueError) as theirs:
        jax_ev.landmark_errors(hm_pred, hm_true[:2])
    with pytest.raises(ValueError) as ours:
        ev.landmark_errors(hm_pred, hm_true[:2])
    assert str(ours.value) == str(theirs.value)

    rows = [ev.overlap_metrics(*_masks(rng, 3), 4) for _ in range(4)]
    rows[1][2]["dice"] = float("inf")
    assert same(ev.aggregate(rows), jax_ev.aggregate(rows))
    assert ev.aggregate([]) == jax_ev.aggregate([]) == []
    all_inf = [[{"hd95": float("inf")}], [{"hd95": float("inf")}]]
    assert same(ev.aggregate(all_inf), jax_ev.aggregate(all_inf))


def _write_stores(tmp_path, pred_format="zarr", heatmaps=0, grow=True):
    """Truth and prediction stores of three subjects; with ``grow`` the
    first subject has 2 classes and a later one 3, so the class count grows
    across subjects."""
    rng = np.random.default_rng(1)
    truth = {g: VolumeGroup() for g in ("labels", "heatmaps")}
    preds = VolumeGroup()
    for i, key in enumerate(AFFINES):
        pred, true = _masks(rng, 2 if grow and i == 0 else 3)
        ds = truth["labels"].require_dataset(key, (1, *SHAPE), np.uint8)
        ds[:] = true[None]
        ds.attrs["affine"] = AFFINES[key]
        out = np.zeros((heatmaps + 1, *SHAPE), np.uint8)
        out[-1] = pred
        if heatmaps:
            hm = (rng.random((heatmaps, *SHAPE)) * 255).astype(np.uint8)
            truth["heatmaps"].require_dataset(key, hm.shape, np.uint8)[:] = hm
            out[:heatmaps] = np.roll(hm, shift=i + 1, axis=1)
        preds.require_dataset(key, out.shape, np.uint8)[:] = out
    truth_path = tmp_path / "truth.zarr"
    truth["labels"].save(truth_path, group="labels")
    if heatmaps:
        truth["heatmaps"].save(truth_path, group="heatmaps")
    pred_path = tmp_path / f"pred.{pred_format}"
    preds.save(pred_path, group="prediction")
    (tmp_path / "keys.txt").write_text("".join(f"{k}\n" for k in AFFINES))
    return pred_path, truth_path


def _run_both(tmp_path, argv, capsys):
    results = []
    for name, mod in (("jax", jax_evaluate), ("port", evaluate)):
        out = tmp_path / f"{name}.json"
        assert mod.main([*argv, "--json", str(out)]) == 0
        text = capsys.readouterr().out
        results.append((json.loads(out.read_text()), text))
    return results


@pytest.mark.parametrize("case", ["grow_surface", "landmarks_auto", "explicit", "nifti"])
def test_cli_json_equals_jax(tmp_path, capsys, case):
    heatmaps = 2 if case in ("landmarks_auto", "explicit") else 0
    pred_path, truth_path = _write_stores(
        tmp_path, pred_format="nii" if case == "nifti" else "zarr", heatmaps=heatmaps,
        grow=case != "explicit")
    argv = ["--pred", str(pred_path), "--truth", str(truth_path), "--log_level", "WARNING"]
    if case in ("grow_surface", "nifti"):
        argv.append("--surface")
    if case == "explicit":
        argv += ["--classes", "5", "--heatmap_group", "heatmaps", "--subjects",
                 str(tmp_path / "keys.txt")]
    (ref, ref_text), (got, got_text) = _run_both(tmp_path, argv, capsys)
    assert same(got, ref)
    assert got_text == ref_text
    if case == "grow_surface":
        first = got["subjects"]["s0"]["segmentation"]
        assert len(first) == got["n_classes"] == 3 and math.isnan(first[2]["dice"])
        assert got["subjects"]["s1"]["spacing"] == [0.9, 1.2, 3.0]
    if heatmaps:
        assert len(got["mean"]["landmarks"]) == heatmaps


def test_cli_refusals_equal_jax(tmp_path, capsys):
    pred_path, truth_path = _write_stores(tmp_path)
    for argv in (["--pred_group", "nothing"],):
        messages = []
        for mod in (jax_evaluate, evaluate):
            with pytest.raises(SystemExit) as exc:
                mod.main(["--pred", str(pred_path), "--truth", str(truth_path), *argv])
            messages.append(str(exc.value.code))
        assert messages[0] == messages[1]
        assert "no group 'nothing'" in messages[1]
