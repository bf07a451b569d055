"""The port's serving export against the JAX package's ``jax.export`` artifacts.

The same parameters (a 2-level f_maps-4 residual U-Net in fp32, drawn by
flax and carried with ``utils/weights.py``; the landmark model with 2
heatmaps and 2 classes) and the same seeded 16³ tiles go through JAX's
``export_predictor`` -> ``save_exported`` -> ``load_exported(...).call`` and
the port's ``export_predictor`` -> ``save_exported`` -> ``load_exported``
(``torch.export``, ``.pt2``), on the CPU.  At the serving tolerance on
record: class maps equal outside the 1e-4 top-2 band of JAX's logits (of
its averaged probabilities with TTA), heatmaps within 1, TTA probabilities
atol 1e-4; the port's artifact equals its own eager ``make_serving_fn``
exactly (the same CPU kernels).  Also: the symbolic batch at N = 1 and 3,
a pinned batch refusing another N, ``--platforms tpu`` refused,
``detect_task_name``, ``torch.library.opcheck`` of both K1 ops, and the
CLI end to end on a port checkpoint, its artifact loaded in a fresh
process that imports ``torch`` and ``tpu_mednet_torch.ops`` only.
"""

import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_tta import assert_prediction_matches, make_pair
from tpu_mednet.inference import common as jax_common
from tpu_mednet.inference import serving as jax_serving
from tpu_mednet_torch.cli import export_serving
from tpu_mednet_torch.inference import common, serving
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops import groupnorm as gn
from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
from tpu_mednet_torch.train import CheckpointManager, create_train_state
from tpu_mednet_torch.train.optim import OptimizerConfig

REPO = Path(__file__).resolve().parent.parent
PATCH = (16, 16, 16)
HEATMAPS = 2
PROB_ATOL = 1e-4
CL3D = torch.channels_last_3d


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiles(n, seed):
    return np.random.default_rng(seed).normal(size=(n, *PATCH, 1)).astype(np.float32)


def _jax_artifact(tmp_path, jtask, variables, **kw):
    exported = jax_serving.export_predictor(jtask, variables, PATCH, **kw)
    jax_serving.save_exported(exported, tmp_path / "jax.jaxep")
    return jax_serving.load_exported(tmp_path / "jax.jaxep")


def _port_artifact(tmp_path, task, **kw):
    exported = serving.export_predictor(task, PATCH, **kw)
    serving.save_exported(exported, tmp_path / "port.pt2")
    assert (tmp_path / "port.pt2").stat().st_size > 0
    return serving.load_exported(tmp_path / "port.pt2").module()


def _call(fn, x):
    with torch.no_grad():
        return fn(torch.from_numpy(x)).numpy()


def _assert_serving_matches(got, want, act, num_heatmaps=0):
    """(N, X, Y, Z, C') uint8 against JAX's, per tile, at the tolerance above."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    for n in range(got.shape[0]):
        assert_prediction_matches(np.moveaxis(got[n], -1, 0), np.moveaxis(want[n], -1, 0),
                                  act[n], num_heatmaps, what=f"tile {n}")


def test_export_symbolic_batch_roundtrip(tmp_path):
    jtask, variables, task = make_pair("segmentation")
    loaded_jax = _jax_artifact(tmp_path, jtask, variables)
    loaded = _port_artifact(tmp_path, task)
    serve = serving.make_serving_fn(task)
    # symbolic batch: one artifact serves N = 1 (no 0/1 specialization) and 3
    for n, seed in ((1, 0), (3, 1)):
        x = _tiles(n, seed)
        got = _call(loaded, x)
        assert got.dtype == np.uint8 and got.shape == (n, *PATCH, 1)
        np.testing.assert_array_equal(got, _call(serve, x))
        logits = np.asarray(jtask.model.apply(variables, jnp.asarray(x), train=False))
        _assert_serving_matches(got, np.asarray(loaded_jax.call(jnp.asarray(x))), logits)


def test_export_with_tta_baked_in(tmp_path):
    """``tta_flips`` bakes the mirror-TTA ensemble into the artifact: the
    call equals postprocess(tta_split_activations) on the same input, and
    JAX's artifact outside the band of its averaged probabilities."""
    jtask, variables, task = make_pair("segmentation")
    flips = (0, 2)
    loaded_jax = _jax_artifact(tmp_path, jtask, variables, tta_flips=flips)
    loaded = _port_artifact(tmp_path, task, tta_flips=flips)
    x = _tiles(2, 4)
    got = _call(loaded, x)
    with torch.no_grad():
        act = common.tta_split_activations(task, torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                           flips)
        want_port = common.postprocess_activations(task, act).permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_array_equal(got, want_port)
    jax_act = np.asarray(jax_common.tta_split_activations(jtask, variables, jnp.asarray(x),
                                                          flips))
    np.testing.assert_allclose(act.permute(0, 2, 3, 4, 1).numpy(), jax_act, rtol=0,
                               atol=PROB_ATOL)
    _assert_serving_matches(got, np.asarray(loaded_jax.call(jnp.asarray(x))), jax_act)


def test_export_pinned_batch(tmp_path):
    _, _, task = make_pair("segmentation")
    loaded = _port_artifact(tmp_path, task, batch_size=2)
    assert _call(loaded, np.zeros((2, *PATCH, 1), np.float32)).shape == (2, *PATCH, 1)
    with pytest.raises(Exception):
        _call(loaded, np.zeros((3, *PATCH, 1), np.float32))


def test_export_landmark_postprocess(tmp_path):
    jtask, variables, task = make_pair("landmark")
    loaded_jax = _jax_artifact(tmp_path, jtask, variables)
    loaded = _port_artifact(tmp_path, task)
    x = _tiles(2, 1)
    got = _call(loaded, x)
    np.testing.assert_array_equal(got, _call(serving.make_serving_fn(task), x))
    # heatmaps first (uint8-clipped), class map last channel
    assert got.shape[-1] == task.num_heatmaps + 1 == HEATMAPS + 1
    logits = np.asarray(jtask.model.apply(variables, jnp.asarray(x), train=False))
    _assert_serving_matches(got, np.asarray(loaded_jax.call(jnp.asarray(x))), logits,
                            HEATMAPS)


@pytest.mark.parametrize("platforms,match", [
    (("tpu", "cpu"), "--platforms tpu"),
    (("cuda", "cpu"), "one platform"),
    (("rocm",), "unknown platform"),
])
def test_export_platforms(platforms, match):
    """The JAX package lowers for ``tpu`` and ``cpu`` at once; the port
    traces on the one device it serves from: ``tpu`` is refused by name,
    and so are two platforms.  ``cpu`` exports here."""
    _, _, task = make_pair("segmentation")
    with pytest.raises(ValueError, match=match):
        serving.export_predictor(task, PATCH, platforms=platforms)
    exported = serving.export_predictor(task, PATCH, platforms=("cpu",))
    assert _call(exported.module(), np.zeros((1, *PATCH, 1), np.float32)).shape == (
        1, *PATCH, 1)


def test_detect_task_name():
    cases = [{"fmaps": 32}, {"loss_regression_weight": None},
             {"loss_regression_weight": [0.01, 0.01]},
             types.SimpleNamespace(loss_regression_weight=[0.5], fmaps=8)]
    for hp in cases:
        assert serving.detect_task_name(hp) == jax_serving.detect_task_name(hp)
    assert [serving.detect_task_name(hp) for hp in cases] == [
        "SegmentationNet", "SegmentationNet", "LandmarkNet", "LandmarkNet"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_k1_ops(dtype):
    """The CPU implementations against the fake ones (shapes, dtypes,
    strides), the schemas, and tracing: ``torch.library.opcheck``."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 8, 4, 6, 5)).astype(np.float32)).to(dtype)
    x = x.contiguous(memory_format=CL3D)
    r = torch.from_numpy(rng.normal(size=(2, 8, 4, 6, 5)).astype(np.float32)).to(dtype)
    r = r.contiguous(memory_format=CL3D)
    w, b = torch.linspace(0.5, 1.5, 8), torch.linspace(-0.1, 0.1, 8)
    torch.library.opcheck(torch.ops.tpu_mednet_torch.gn_moments.default, (x, 4, w, 1e-5))
    mean, mul, _ = gn.group_norm_moments(x, 4, w, 1e-5)
    for residual, act in ((None, None), (r, "e"), (None, "r")):
        torch.library.opcheck(torch.ops.tpu_mednet_torch.gn_apply.default,
                              (x, mean, mul, b, residual, act))
    # the fake apply output is channels-last like the real one
    y = gn.group_norm_apply(x, mean, mul, b, act="e")
    assert y.is_contiguous(memory_format=CL3D) and y.dtype == dtype


def _write_checkpoint(root: Path, kind: str):
    """A port checkpoint of a 2-level model (per-level fmaps 4, 8) with EMA
    weights that differ from the raw ones, and its hparams side-car."""
    hp = dict(in_channels=1, fmaps=[4, 8], bf16=False, loss="DICE", loss_weight=None,
              ema_decay=0.9)
    if kind == "landmark":
        hp.update(out_channels=HEATMAPS + 2, loss_regression_weight=[0.01] * HEATMAPS)
        task = LandmarkTask.from_hparams(types.SimpleNamespace(**hp), device="cpu")
    else:
        hp.update(out_channels=3)
        task = SegmentationTask.from_hparams(types.SimpleNamespace(**hp), device="cpu")
    state = create_train_state(task.model, seed=0, optimizer=OptimizerConfig(ema_decay=0.9))
    with torch.no_grad():
        for k, p in task.model.named_parameters():
            if k.endswith("weight") and p.dim() == 1:
                p.normal_(1.0, 0.3, generator=torch.Generator().manual_seed(len(k)))
        state.ema = {k: v * 0.5 for k, v in state.ema.items()}
    CheckpointManager(root / kind).save(1, state, hp)
    return root / kind, state


def _load_in_fresh_process(tmp_path, artifact, x):
    """Run the artifact in a fresh interpreter that imports only torch and
    tpu_mednet_torch.ops; return its output and the port modules loaded."""
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        import torch
        import tpu_mednet_torch.ops
        prog = torch.export.load({str(artifact)!r})
        with torch.no_grad():
            out = prog.module()(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))
        np.save({str(tmp_path / 'out.npy')!r}, out.numpy())
        print(json.dumps(sorted(m for m in sys.modules
                                if m.startswith("tpu_mednet") or m.split(".")[0] == "jax")))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(tmp_path / "out.npy"), json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("kind,extra", [("segmentation", ()),
                                        ("landmark", ("--tta", "0", "2"))])
def test_cli_end_to_end_on_a_port_checkpoint(tmp_path, kind, extra):
    """``export_serving.main(argv)`` on a port checkpoint (EMA weights by
    default, the raw ones with ``--no_ema``); the ``.pt2`` loads and runs in
    a fresh process without the port's model, task, train or inference
    modules, equal to the eager serving function of the same weights."""
    ckpt, state = _write_checkpoint(tmp_path, kind)
    out = tmp_path / f"{kind}.pt2"
    base = ["--checkpoint", str(ckpt), "--out", str(out), "--patch_size", *map(str, PATCH),
            "--platforms", "cpu", "--log_level", "WARNING", *extra]
    assert export_serving.main(base) == 0
    x = _tiles(2, 5)
    got, modules = _load_in_fresh_process(tmp_path, out, x)
    assert not [m for m in modules if m.split(".")[0] in ("jax", "tpu_mednet")]
    assert not [m for m in modules if m.split(".")[1:2] and m.split(".")[1] in (
        "models", "tasks", "train", "inference")], modules
    assert "tpu_mednet_torch.ops.groupnorm" in modules

    flips = (0, 2) if extra else ()
    state.model.load_state_dict(state.ema)
    task = (LandmarkTask(model=state.model, loss_regression_weight=[0.01] * HEATMAPS)
            if kind == "landmark" else SegmentationTask(model=state.model))
    want = _call(serving.make_serving_fn(task, flips), x)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, *PATCH, HEATMAPS + 1 if kind == "landmark" else 1)

    if kind == "landmark":
        return
    # --no_ema bakes the raw weights: another artifact, other predictions
    raw = tmp_path / "raw.pt2"
    assert export_serving.main([*base[:3], str(raw), *base[4:], "--no_ema"]) == 0
    raw_out = _call(serving.load_exported(raw).module(), x)
    ema_out = _call(serving.load_exported(out).module(), x)
    np.testing.assert_array_equal(ema_out, got)
    assert not np.array_equal(raw_out, got)


def test_cli_refusals(tmp_path):
    ckpt, _ = _write_checkpoint(tmp_path, "segmentation")
    base = ["--checkpoint", str(ckpt), "--out", str(tmp_path / "a.pt2"),
            "--patch_size", *map(str, PATCH), "--log_level", "WARNING"]
    with pytest.raises(ValueError, match="--platforms tpu"):
        export_serving.main([*base, "--platforms", "tpu", "cpu"])
    with pytest.raises(ValueError, match="one platform"):
        export_serving.main([*base, "--platforms", "cuda", "cpu"])
    with pytest.raises(ValueError, match="trained as SegmentationNet"):
        export_serving.main([*base, "--platforms", "cpu", "--model", "LandmarkNet"])
    if not torch.cuda.is_available():  # the default platform is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export_serving.main(base)
    bare = tmp_path / "bare"
    model = ResidualUNet3D(1, 3, f_maps=4, dtype=torch.float32, device="cpu")
    CheckpointManager(bare).save(1, create_train_state(model), None)
    with pytest.raises(ValueError, match="no hparams side-car"):
        export_serving.main(["--checkpoint", str(bare), "--out", str(tmp_path / "b.pt2"),
                             "--platforms", "cpu"])
    with pytest.raises(SystemExit):
        export_serving.main(["--out", "x.pt2"])  # --checkpoint is required
    assert not (tmp_path / "a.pt2").exists()
