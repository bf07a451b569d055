"""The port's landmark task, samplers, flags and Trainer against the JAX package's.

A ``ResidualUNet3D(1, 5, f_maps=8, num_levels=3)`` in fp32 (3 heatmaps and
2 classes, the ``configs/landmarks.yaml`` head at a small width): the JAX
package draws the parameters and ``load_jax_params`` carries them over.
Inputs are seeded numpy arrays.  Tolerances:

- ``LandmarkTask.loss_fn`` and one train step against ``jax.grad``: loss
  and its two parts rtol 1e-5, every gradient within 1e-4 * max |g|;
- ``val_metrics`` on the same outputs: atol 1e-5, relative above 1, and
  the predicted and true peaks behind ``val_landmark_error`` exact;
- ``predict_postprocess``: on the same logits, equal; through each
  package's forward, heatmap bytes equal except by 1 where JAX's pre-cast
  value lies within 1e-3 of an integer, and class maps equal outside the
  1e-4 top-2 band of JAX's class logits;
- the host and device samplers with ``heatmap_group``: byte-equal batches;
  the device sampler with ``landmark_group``: data and class map byte-equal,
  heatmap bytes under the ±1 rule against JAX's pre-cast Gaussians;
- ``add_landmark_model_args`` and ``configs/landmarks.yaml``: the same
  namespace; ``validate_task_config(..., "ldmk")`` refuses what JAX refuses;
- ``Trainer.fit`` of a ``LandmarkTask``: per-step losses and validation
  means atol 1e-5, as in ``test_torch_trainer.py``, relative above 1 (the
  regression loss reaches ~50 on the 0..255 scale, where one fp32 ulp is
  4e-6).

Sizes are 2 x 12^3 patches: XLA's CPU sum of the squared heatmap errors in
fp32 drifts from the float64 value by ~1e-5 relative at 2 x 16^3 (the
port's stays within 1e-7), which would exceed the bounds above.
"""

import argparse
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet import config as jax_config
from tpu_mednet.cli import train_ldmks as jax_train_ldmks
from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.data import PatchSampler as JaxPatchSampler
from tpu_mednet.data.device_sampler import DevicePatchSampler as JaxDeviceSampler
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.ops.heatmap import batched_gaussian_heatmaps as jax_heatmaps
from tpu_mednet.ops.heatmap import heatmap_argmax_coords as jax_argmax_coords
from tpu_mednet.tasks import LandmarkTask as JaxLandmarkTask
from tpu_mednet.train import OptimizerConfig as JaxOptimizerConfig
from tpu_mednet.train import Trainer as JaxTrainer
from tpu_mednet.train import create_train_state as jax_create_train_state
from tpu_mednet.train import make_predict_step as jax_make_predict_step
from tpu_mednet.train import make_train_step as jax_make_train_step
from tpu_mednet_torch import config
from tpu_mednet_torch.cli import train_ldmks
from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader, PatchSampler
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.ops import losses as L
from tpu_mednet_torch.ops.heatmap import batched_gaussian_heatmaps, heatmap_argmax_coords
from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
from tpu_mednet_torch.train import (OptimizerConfig, Trainer, create_train_state,
                                    make_predict_step, make_train_step)
from tpu_mednet_torch.utils.weights import load_jax_params, state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
REG_WEIGHTS = [0.015, 0.015, 0.015]
CLASS_WEIGHTS = [0.05, 1.0]
BATCH_SHAPE = (2, 12, 12, 12)
SHAPES = {"s0": (20, 18, 22), "s1": (18, 20, 16), "s2": (22, 16, 18)}
VAL_SHAPES = {"v0": (18, 18, 20)}
PATCH = (12, 12, 12)
SIGMA = 3.0


def _to_cl(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _port_batch(data, label):
    """Channels-last numpy -> the port's channels-first views."""
    to = lambda a: torch.from_numpy(a).permute(0, 4, 1, 2, 3)
    return {"data": to(data), "label": to(label)}


def _gaussians(coords, shape, sigma=SIGMA):
    """(L, 3) -> (L, X, Y, Z) uint8 heatmaps, rendered in numpy."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    d2 = ((grid[None] - coords[:, None, None, None]) ** 2).sum(-1)
    return (255.0 * np.exp(-d2 / (2 * sigma**2))).astype(np.uint8)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    label = np.zeros((*BATCH_SHAPE, 4), np.uint8)
    label[:, 3:9, 2:8, 4:10, 3] = 1
    for n in range(BATCH_SHAPE[0]):
        coords = rng.uniform(2, 10, size=(3, 3))
        label[n, ..., :3] = np.moveaxis(_gaussians(coords, BATCH_SHAPE[1:]), 0, -1)
    data = (rng.normal(size=(*BATCH_SHAPE, 1)) + 1.5 * label[..., 3:]).astype(np.float32)
    return data, label


def _setup(loss_class="DICE", loss_regression="L2", f_maps=8):
    """(JAX task, JAX state, port task, port state) from the same parameters."""
    cfg = UNetConfig(in_channels=1, out_channels=5, f_maps=f_maps, num_levels=3,
                     dtype=jnp.float32)
    kw = dict(loss_regression_weight=REG_WEIGHTS, loss_class=loss_class,
              loss_class_weight=CLASS_WEIGHTS, loss_regression=loss_regression)
    jtask = JaxLandmarkTask(model=UNet3DBase(config=cfg), **kw)
    jstate = jax_create_train_state(jtask.model, (*BATCH_SHAPE, 1), learning_rate=1e-3, seed=0)
    model = ResidualUNet3D(1, 5, f_maps=f_maps, num_levels=3, dtype=torch.float32,
                           device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, jstate.params)})
    task = LandmarkTask(model=model, **kw)
    return jtask, jstate, task, create_train_state(model, learning_rate=1e-3, seed=0)


def test_from_hparams_builds_the_jax_model():
    hp = SimpleNamespace(in_channels=1, out_channels=5, fmaps=4, bf16=False,
                         loss_regression_weight=REG_WEIGHTS, loss_class="CE",
                         loss_class_weight=CLASS_WEIGHTS, loss_regression="L1")
    task = LandmarkTask.from_hparams(hp, device="cpu")
    jtask = JaxLandmarkTask.from_hparams(hp)
    assert (task.num_heatmaps, task.num_classes, task.out_channels) == \
        (jtask.num_heatmaps, jtask.num_classes, jtask.out_channels) == (3, 2, 5)
    assert (task.loss_class, task.loss_regression) == ("CE", "L1")
    shapes = jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 16, 1)))["params"]
    want = state_dict_from_jax({"params": jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), shapes)})
    got = dict(task.model.named_parameters())
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    assert task.model.config.dtype == torch.float32
    hp.bf16 = True
    assert LandmarkTask.from_hparams(hp, device="cpu").model.config.dtype == torch.bfloat16


@pytest.mark.parametrize("loss_class,loss_regression", [("DICE", "L2"), ("CE", "L1")])
def test_loss_fn_and_train_step_match_jax(loss_class, loss_regression):
    jtask, jstate, task, state = _setup(loss_class, loss_regression)
    data, label = _batch()
    jbatch = {"data": jnp.asarray(data), "label": jnp.asarray(label)}

    def loss_of(params):
        out = jtask.model.apply({"params": params}, jbatch["data"], train=True)
        return jtask.loss_fn(out, jbatch)[0]

    grads = state_dict_from_jax({"params": jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_of))(jstate.params))})
    _, ref = jax_make_train_step(jtask, augment=None)(jstate, jbatch)

    state, got = make_train_step(task)(state, _port_batch(data, label))
    assert sorted(got) == sorted(ref) == ["class_loss", "regression_loss", "train_loss"]
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    named = dict(task.model.named_parameters())
    assert sorted(named) == sorted(grads)
    for k, g_ref in grads.items():
        scale = float(g_ref.abs().max())
        assert scale > 0, k
        assert float((named[k].grad - g_ref).abs().max()) <= 1e-4 * scale, k


def test_val_metrics_match_jax():
    jtask, _, task, _ = _setup()
    data, label = _batch(1)
    rng = np.random.default_rng(5)
    outputs = rng.normal(0, 30, size=(*BATCH_SHAPE, 5)).astype(np.float32)
    # the second sample's first landmark lies outside its patch: left out
    label[1, ..., 0] = 0
    ref = jtask.val_metrics(jnp.asarray(outputs), {"label": jnp.asarray(label)})
    got = task.val_metrics(torch.from_numpy(np.moveaxis(outputs, -1, 1)),
                           _port_batch(data, label))
    assert sorted(got) == sorted(ref) == ["val_class_loss", "val_dice0", "val_dice1",
                                          "val_landmark_error", "val_loss",
                                          "val_regression_loss"]
    # the peaks the error is measured between are exact; the mean of their
    # distances sums in another fp32 order
    for i in (slice(0, 3), slice(None, None)):
        src = outputs[..., :3] if i.stop == 3 else label[..., :3]
        np.testing.assert_array_equal(
            heatmap_argmax_coords(torch.from_numpy(np.moveaxis(src, -1, 1))).numpy(),
            np.asarray(jax_argmax_coords(jnp.asarray(src))))
    assert float(ref["val_landmark_error"]) > 0
    for k in ref:
        assert abs(float(got[k]) - float(ref[k])) <= 1e-5 * max(1.0, abs(float(ref[k]))), k


def _assert_heatmaps_close(got: np.ndarray, want: np.ndarray, pre_cast: np.ndarray):
    """Bytes equal except by 1 where JAX's pre-cast value is within 1e-3 of
    an integer."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    near = np.abs(pre_cast - np.round(pre_cast)) <= 1e-3
    assert not (diff.astype(bool) & ~near).any()


def test_predict_postprocess_matches_jax():
    jtask, jstate, task, _ = _setup()
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 100, size=(*BATCH_SHAPE, 5)).astype(np.float32)
    logits[0, 0, 0, 0, :3] = [-3.0, 255.0, 300.5]
    want = np.asarray(jtask.predict_postprocess(jnp.asarray(logits)))
    got = task.predict_postprocess(torch.from_numpy(np.moveaxis(logits, -1, 1)))
    assert got.dtype == torch.uint8 and got.shape == (2, 4, *BATCH_SHAPE[1:])
    np.testing.assert_array_equal(_to_cl(got.numpy()), want)
    assert list(got[0, :3, 0, 0, 0]) == [0, 255, 255]

    # through each package's forward
    data, _ = _batch(2)
    variables = {"params": jstate.params}
    want = np.asarray(jax_make_predict_step(jtask)(variables, jnp.asarray(data)))
    got = make_predict_step(task)(torch.from_numpy(data).permute(0, 4, 1, 2, 3))
    got = _to_cl(got.numpy())
    ref_logits = np.asarray(jtask.model.apply(variables, jnp.asarray(data), train=False))
    _assert_heatmaps_close(got[..., :3], want[..., :3],
                           np.clip(ref_logits[..., :3], 0.0, 255.0))
    cls = ref_logits[..., 3:]
    clear = np.abs(cls[..., 0] - cls[..., 1]) > 1e-4
    np.testing.assert_array_equal(got[..., 3][clear], want[..., 3][clear])


def _store(shapes, seed=0):
    rng = np.random.default_rng(seed)
    store = {"images": {}, "labels": {}, "heatmaps": {}, "landmarks": {}}
    for key, shape in shapes.items():
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 3:11, 4:12, 2:10] = 1
        coords = rng.uniform(1, np.asarray(shape) - 1, size=(3, 3)).astype(np.float32)
        coords[1, 0] += 0.37  # fractional: the Gaussian straddles voxels
        store["images"][key] = (rng.normal(size=(1, *shape)) + 2 * lbl).astype(np.float32)
        store["labels"][key] = lbl
        store["heatmaps"][key] = _gaussians(coords, shape)
        store["landmarks"][key] = coords
    return store


@pytest.mark.parametrize("sampler", ["host", "device"])
def test_samplers_with_a_heatmap_group_match_jax(sampler):
    store = _store(SHAPES)
    kw = dict(patch_size=PATCH, class_probabilities=[0.5, 0.5], seed=3,
              heatmap_group="heatmaps")
    keys = list(SHAPES)
    if sampler == "host":
        ref = JaxPatchSampler(None, keys, 3, reader=JaxMemoryReader(store), **kw)
        port = PatchSampler(None, keys, 3, reader=MemoryReader(store), **kw)
    else:
        ref = JaxDeviceSampler(None, keys, 3, reader=JaxMemoryReader(store), **kw)
        port = DevicePatchSampler(None, keys, 3, reader=MemoryReader(store), device="cpu",
                                  **kw)
        assert port.labels.shape[-1] == 4
    assert port.num_heatmap_channels == 3
    n = 0
    for a, b in zip(ref.batches(2), port.batches(2)):
        label = b["label"].permute(0, 2, 3, 4, 1).numpy()
        assert label.shape == (2, *PATCH, 4)
        np.testing.assert_array_equal(label, np.asarray(a["label"]))
        data = b["data"].permute(0, 2, 3, 4, 1).contiguous()
        if sampler == "device":
            data, want = data.view(torch.int16).numpy(), np.asarray(a["data"]).view(np.int16)
        else:
            data, want = data.numpy(), a["data"]
        np.testing.assert_array_equal(data, want)
        n += 1
    assert n == 4
    assert label[..., :3].any()


def test_device_sampler_with_a_landmark_group_matches_jax():
    store = _store(SHAPES, seed=4)
    kw = dict(patch_size=PATCH, class_probabilities=[0.5, 0.5], seed=5,
              landmark_group="landmarks", heatmap_sigma=SIGMA)
    keys = list(SHAPES)
    ref = JaxDeviceSampler(None, keys, 2, reader=JaxMemoryReader(store), **kw)
    port = DevicePatchSampler(None, keys, 2, reader=MemoryReader(store), device="cpu", **kw)
    assert port.num_heatmap_channels == 3 and port.labels.shape[-1] == 1
    coords = np.stack([store["landmarks"][k] for k in keys])
    for _ in range(3):
        subj, corners = port.sample_indices(4)
        s_ref, c_ref = ref.sample_indices(4)
        np.testing.assert_array_equal(subj, np.asarray(s_ref))
        np.testing.assert_array_equal(corners, np.asarray(c_ref))
        want = ref._gather(ref.images, ref.labels, ref.landmarks_dev, s_ref, c_ref)
        got = port.gather(subj, corners)
        label = got["label"].permute(0, 2, 3, 4, 1).numpy()
        want_label = np.asarray(want["label"])
        assert label.shape == want_label.shape == (4, *PATCH, 4)
        np.testing.assert_array_equal(label[..., 3], want_label[..., 3])
        np.testing.assert_array_equal(
            got["data"].permute(0, 2, 3, 4, 1).contiguous().view(torch.int16).numpy(),
            np.asarray(want["data"]).view(np.int16))
        local = coords[subj] - corners[:, None, :].astype(np.float32)
        pre_cast = np.asarray(jax_heatmaps(jnp.asarray(local), PATCH, SIGMA))
        _assert_heatmaps_close(label[..., :3], want_label[..., :3], pre_cast)
    assert label[..., :3].max() > 0


@pytest.mark.parametrize("sigma", [SIGMA, [2.0, 3.0, 4.5]])
def test_device_sampler_renders_with_its_held_sigma(sigma):
    """The sampler's σ, a tensor made once on its device, renders the
    windows' heatmaps of the float or the list, bit for bit."""
    store = _store(SHAPES, seed=4)
    keys = list(SHAPES)
    port = DevicePatchSampler(None, keys, 2, PATCH, reader=MemoryReader(store), device="cpu",
                              landmark_group="landmarks", heatmap_sigma=sigma, seed=5)
    assert port.heatmap_sigma == sigma
    subj, corners = port.sample_indices(4)
    local = port.landmarks[torch.from_numpy(subj).long()] - torch.from_numpy(corners)[:, None]
    want = batched_gaussian_heatmaps(local, PATCH, sigma).to(torch.uint8)
    got = port.gather(subj, corners)["label"][:, :3]
    assert want.any()
    assert torch.equal(got, want)


def _weighted(kind, loss):
    """(task, outputs, batch, the loss from list weights): a 5-channel head
    (landmarks: 3 heatmaps and 2 classes) and a batch for it."""
    rng = np.random.default_rng(9)
    model = ResidualUNet3D(1, 5, f_maps=4, num_levels=2, dtype=torch.float32, device="cpu")
    outputs = torch.from_numpy(rng.normal(0, 3, size=(2, 5, 6, 5, 4)).astype(np.float32))
    if kind == "landmarks":
        task = LandmarkTask(model=model, loss_regression_weight=REG_WEIGHTS, loss_class=loss,
                            loss_class_weight=CLASS_WEIGHTS)
        hm = rng.integers(0, 256, size=(2, 3, 6, 5, 4))
        label = np.concatenate([hm, rng.integers(0, 2, size=(2, 1, 6, 5, 4))], axis=1)

        def by_lists(out, batch):
            hm, labels = task.split_labels(batch)
            return L.multitask_landmark_loss(
                out[:, 3:], out[:, :3], labels, hm, regression_weights=list(REG_WEIGHTS),
                class_loss=loss, class_weight=list(CLASS_WEIGHTS))[0]
    else:
        weight = [0.2, 1.0, 0.5, 0.7, 1.3]
        task = SegmentationTask(model=model, loss=loss, loss_weight=weight)
        label = rng.integers(0, 5, size=(2, 1, 6, 5, 4))
        fn = L.dice_loss if loss == "DICE" else L.ce_loss

        def by_lists(out, batch):
            return fn(out, batch["label"][:, -1].long(), weight=list(weight))
    batch = {"data": torch.zeros(2, 1, 6, 5, 4), "label": torch.from_numpy(label.astype(np.uint8))}
    return task, outputs, batch, by_lists


def _loss_and_grad(fn, outputs, batch):
    out = outputs.clone().requires_grad_()
    loss = fn(out, batch)
    loss.backward()
    return loss.detach(), out.grad


@pytest.mark.parametrize("kind,loss", [("landmarks", "DICE"), ("landmarks", "CE"),
                                       ("segmentation", "DICE"), ("segmentation", "CE")])
def test_held_weights_give_the_list_weights_loss(kind, loss):
    """A task's weights, held on the device from its first loss on, give
    the loss and gradients of the same weights handed over as lists, bit for
    bit; the second call takes the tensors the first made."""
    task, outputs, batch, by_lists = _weighted(kind, loss)
    want = _loss_and_grad(by_lists, outputs, batch)
    got = _loss_and_grad(lambda out, b: task.loss_fn(out, b)[0], outputs, batch)
    held = task._weights.on(outputs.device)
    again = _loss_and_grad(lambda out, b: task.loss_fn(out, b)[0], outputs, batch)
    assert task._weights.on(outputs.device)["cls"] is held["cls"]
    assert held["cls"].dtype == torch.float32 and held["cls"].device == outputs.device
    for a, b, c in zip(want, got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(b.view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("kind", ["landmarks", "segmentation"])
def test_weights_first_held_in_inference_mode_serve_a_backward(kind):
    """Weights first made under an eval step's inference mode are ordinary
    tensors: a train step's backward can save them."""
    task, outputs, batch, by_lists = _weighted(kind, "DICE")
    with torch.inference_mode():
        task.val_metrics(outputs, batch)
    got = _loss_and_grad(lambda out, b: task.loss_fn(out, b)[0], outputs, batch)
    want = _loss_and_grad(by_lists, outputs, batch)
    for a, b in zip(want, got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind", ["landmarks", "segmentation"])
def test_a_wrong_length_class_weight_raises_at_the_first_loss(kind):
    model = ResidualUNet3D(1, 5, f_maps=4, num_levels=2, dtype=torch.float32, device="cpu")
    if kind == "landmarks":  # 2 classes
        task = LandmarkTask(model=model, loss_regression_weight=REG_WEIGHTS,
                            loss_class_weight=[0.05, 1.0, 1.0])
        label = torch.zeros(2, 4, 6, 5, 4, dtype=torch.uint8)
    else:  # 5 classes
        task = SegmentationTask(model=model, loss_weight=[0.05, 1.0])
        label = torch.zeros(2, 1, 6, 5, 4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="per-class weight has (3|2) entries.*loss_class_weight"):
        task.loss_fn(torch.zeros(2, 5, 6, 5, 4), {"label": label})


def test_samplers_refuse_mismatched_heatmaps():
    store = _store(SHAPES)
    store["heatmaps"]["s0"] = store["heatmaps"]["s0"][:, :-1]
    for cls, kw in ((PatchSampler, {}), (DevicePatchSampler, {"device": "cpu"})):
        with pytest.raises(ValueError, match="heatmap volume extent"):
            cls(None, ["s0"], 1, PATCH, heatmap_group="heatmaps",
                reader=MemoryReader(store), **kw)


def _parsers():
    jax_parser, port_parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_config.add_common_train_args(jax_parser)
    jax_config.add_landmark_model_args(jax_parser)
    config.add_common_train_args(port_parser)
    config.add_landmark_model_args(port_parser)
    return jax_parser, port_parser


@pytest.mark.parametrize("argv", [
    [],
    ["-c", "configs/landmarks.yaml"],
    ["-c", "configs/landmarks.yaml", "--landmark_group", "lm", "--heatmap_sigma", "2.5",
     "--device_sampler", "--loss_class", "CE", "--loss_regression", "L1",
     "--loss_class_weight", "0.2", "0.8", "--loss_regression_weight", "0.1", "0.2"],
], ids=["defaults", "landmarks.yaml", "overrides"])
def test_landmark_args_parse_equals_jax(argv, monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("DATA", "/data")
    monkeypatch.setenv("MODEL", "/models")
    jax_parser, port_parser = _parsers()
    want = vars(jax_config.parse_with_config(jax_parser, argv))
    assert vars(config.parse_with_config(port_parser, argv)) == want
    cli = vars(config.parse_with_config(train_ldmks.build_parser(), argv))
    assert cli.pop("device") == "cuda"
    assert cli == vars(config.parse_with_config(jax_train_ldmks.build_parser(), argv))


@pytest.mark.parametrize("hp", [
    dict(out_channels=5, loss_regression_weight=[0.1] * 3, loss_class_weight=[0.05, 1.0]),
    dict(out_channels=3, loss_regression_weight=[0.1] * 3, loss_class_weight=None),
    dict(out_channels=5, loss_regression_weight=[0.1] * 3, loss_class_weight=[1.0] * 3),
    dict(out_channels=5, loss_regression_weight=[0.1] * 3, loss_class_weight=None,
         class_probabilities=[0.2, 0.3, 0.5]),
])
def test_validate_ldmk_config_refuses_what_jax_refuses(hp):
    def outcome(fn):
        try:
            fn(SimpleNamespace(**{"batch_size": 4, "class_probabilities": None, **hp}), "ldmk")
        except SystemExit:
            return True
        return False

    assert outcome(config.validate_task_config) == outcome(jax_config.validate_task_config)


def _records(log_dir):
    return [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]


def _by_key(records, key):
    return {r["step"]: r[key] for r in records if key in r}


def test_fit_matches_jax_trainer(tmp_path):
    train, val = _store(SHAPES), _store(VAL_SHAPES, seed=1)
    store = {g: {**train[g], **val[g]} for g in train}
    keys, val_keys = list(SHAPES), list(VAL_SHAPES)
    opt = dict(name="sgd", learning_rate=0.05, momentum=0.9, grad_clip_norm=0.5)
    common = dict(batch_size=2, max_epochs=2, learning_rate=0.05, seed=0, log_every=1,
                  hparams={"fmaps": 4, "loss_regression_weight": REG_WEIGHTS})
    skw = dict(patch_size=PATCH, heatmap_group="heatmaps")
    task_kw = dict(loss_regression_weight=REG_WEIGHTS, loss_class_weight=CLASS_WEIGHTS)

    cfg = UNetConfig(in_channels=1, out_channels=5, f_maps=4, num_levels=3,
                     dtype=jnp.float32)
    jtask = JaxLandmarkTask(model=UNet3DBase(config=cfg), **task_kw)
    jtrainer = JaxTrainer(
        jtask, JaxPatchSampler(None, keys, 2, reader=JaxMemoryReader(store), seed=0, **skw),
        val_sampler=JaxPatchSampler(None, val_keys, 2, reader=JaxMemoryReader(store),
                                    seed=1, **skw),
        model_dir=str(tmp_path / "jax"), log_dir=str(tmp_path / "jax_logs"),
        native_loader=False, optim=JaxOptimizerConfig(**opt), **common)
    jtrainer.fit()
    init = jax_create_train_state(jtask.model, (2, *PATCH, 1), 0.05, seed=0).params

    model = ResidualUNet3D(1, 5, f_maps=4, num_levels=3, dtype=torch.float32, device="cpu")
    load_jax_params(model, {"params": jax.tree.map(np.asarray, init)})
    trainer = Trainer(
        LandmarkTask(model=model, **task_kw),
        PatchSampler(None, keys, 2, reader=MemoryReader(store), seed=0, **skw),
        val_sampler=PatchSampler(None, val_keys, 2, reader=MemoryReader(store), seed=1,
                                 **skw),
        model_dir=str(tmp_path / "port"), log_dir=str(tmp_path / "port_logs"),
        optim=OptimizerConfig(**opt), **common)
    state = trainer.fit()
    assert state.step == jtrainer.state.step == 6

    got, want = _records(tmp_path / "port_logs"), _records(tmp_path / "jax_logs")
    for name in ("train_loss", "class_loss", "regression_loss"):
        ref = _by_key(want, name)
        assert sorted(_by_key(got, name)) == sorted(ref) == list(range(1, 7)), name
        for step, v in _by_key(got, name).items():
            assert abs(v - ref[step]) <= 1e-5 * max(1.0, abs(ref[step])), (name, step)
    names = ("val_loss", "val_class_loss", "val_regression_loss", "val_landmark_error",
             "val_dice0", "val_dice1")
    for name in names:
        ref = _by_key(want, name)
        assert sorted(_by_key(got, name)) == sorted(ref) == [3, 6], name
        for step, v in _by_key(got, name).items():
            assert abs(v - ref[step]) <= 1e-5 * max(1.0, abs(ref[step])), (name, step)
    hp = json.loads(next((tmp_path / "port" / "best").glob("*/hparams.json")).read_text())
    assert hp["_best_monitor"]["metric"] == "val_loss"
    assert hp["loss_regression_weight"] == REG_WEIGHTS
