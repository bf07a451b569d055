"""Mirror TTA of the port, and the crop and device stitches with TTA,
against the JAX package.

The same parameters (a 2-level f_maps-4 residual U-Net in fp32, drawn by
flax and carried to the port with ``utils/weights.py``), the same seeded
volumes of 16^3 and 16x18x17, patch 8, overlap 2, batch 4 (64 and 100
tiles, so tail batches repeat a corner), on the CPU.  Activations agree to
atol 1e-5 x max(1, max |JAX activation|) (another fp32 summation order in
the convolutions: 1e-5 on probabilities, relative to the largest value on
the landmark model's heatmaps, which reach the hundreds).  Class maps
must be equal on every voxel where the top-2 margin of JAX's averaged
class probabilities exceeds 1e-4: inside that band a last-bit difference
may pick the other class.  Heatmap channels may differ by 1: the uint8
cast truncates, so a value an ulp from an integer may land on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.inference import common as jax_common
from tpu_mednet.inference.device_sliding import _grid_corners as jax_grid_corners
from tpu_mednet.inference.device_sliding import (
    predict_volumes_on_device as jax_predict_volumes_on_device,
)
from tpu_mednet.inference.sliding_window import predict_volumes as jax_predict_volumes
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.tasks import LandmarkTask as JaxLandmarkTask
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet_torch.data import MemoryReader
from tpu_mednet_torch.inference import common, predict_volumes, predict_volumes_on_device
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
from tpu_mednet_torch.train import make_predict_step
from tpu_mednet_torch.utils.weights import load_jax_params

SHAPES = {"s0": (16, 16, 16), "s1": (16, 18, 17)}
PATCH, OVERLAP = [8, 8, 8], [2, 2, 2]
KW = dict(patch_size=PATCH, patch_overlap=OVERLAP, batch_size=4)
ACT_ATOL = 1e-5
TIE_BAND = 1e-4
HEATMAPS = 2
FLIPS = (2,)
AFFINE = np.diag([1.5, 1.5, 2.0, 1.0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The small models' many small ops run fastest on one thread; with
    several test workers on the host, more threads oversubscribe its cores
    (a spill test took 456 s instead of 25 s, six copies at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(kind, in_channels=1):
    """(JAX task, JAX variables, port task) with the same parameters; the
    landmark model has 2 heatmaps (their head biased to 0..255) and 2
    classes."""
    out = HEATMAPS + 2 if kind == "landmark" else 2
    model = UNet3DBase(config=UNetConfig(in_channels=in_channels, out_channels=out, f_maps=4,
                                         num_levels=2, num_groups=2, dtype=jnp.float32))
    variables = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, in_channels))))
    port = ResidualUNet3D(in_channels, out, f_maps=4, num_levels=2, num_groups=2,
                          dtype=torch.float32, device="cpu")
    if kind == "landmark":
        variables["params"]["final_conv"]["bias"][:HEATMAPS] = [60.0, 130.0]
        variables["params"]["final_conv"]["kernel"][..., :HEATMAPS] *= 200.0
        load_jax_params(port, variables)
        kw = dict(loss_regression_weight=[0.01] * HEATMAPS)
        return JaxLandmarkTask(model=model, **kw), variables, LandmarkTask(model=port, **kw)
    load_jax_params(port, variables)
    return JaxSegmentationTask(model=model, loss="DICE"), variables, SegmentationTask(model=port)


def make_store(shapes=SHAPES, in_channels=1):
    """Seeded fp32 volumes with a bright cube, and their affines."""
    rng = np.random.default_rng(0)
    images = {}
    for key, shape in shapes.items():
        img = rng.normal(0, 0.5, size=(in_channels, *shape)).astype(np.float32)
        img[:, 3:10, 4:11, 2:9] += 2.0
        images[key] = img
    return {"images": images}, {"images": {k: {"affine": AFFINE} for k in shapes}}


def jax_tile_activations(jtask, variables, vol, flips, patch=PATCH, overlap=OVERLAP):
    """JAX's TTA-averaged activations (N, px, py, pz, C) of every grid tile
    of ``vol`` (C, X, Y, Z) read as f16, with the corners and padded extent."""
    img = np.asarray(vol.shape[1:])
    corners, padded = jax_grid_corners(img, patch, overlap)
    pads = [(o, int(p - s - o)) for o, p, s in zip(overlap, padded, img)]
    v = np.pad(np.moveaxis(vol.astype(np.float16), 0, -1), pads + [(0, 0)])
    tiles = np.stack([v[x:x + patch[0], y:y + patch[1], z:z + patch[2]]
                      for x, y, z in corners]).astype(np.float32)
    act = jax_common.tta_split_activations(jtask, variables, jnp.asarray(tiles), flips)
    return np.asarray(act), corners, padded


def core_stitch(act, corners, padded, img, patch=PATCH, overlap=OVERLAP):
    """(X, Y, Z, C) activations of the tile whose core covers each voxel."""
    out = np.zeros((*padded, act.shape[-1]), np.float32)
    core = tuple(slice(o, p - o) for o, p in zip(overlap, patch))
    for (x, y, z), a in zip(corners, act):
        out[x + overlap[0]:x + patch[0] - overlap[0], y + overlap[1]:y + patch[1] - overlap[1],
            z + overlap[2]:z + patch[2] - overlap[2]] = a[core]
    return out[tuple(slice(o, o + s) for o, s in zip(overlap, img))]


def assert_prediction_matches(got, want, act, num_heatmaps=0, what=""):
    """uint8 (L + 1, X, Y, Z) ``got`` against JAX's ``want``: the class map
    equal outside the tie band of ``act``'s class probabilities, heatmaps
    within 1."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8, what
    top2 = np.sort(act[..., num_heatmaps:], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TIE_BAND
    assert clear.mean() > 0.99, what
    np.testing.assert_array_equal(got[-1][clear], want[-1][clear], err_msg=what)
    if num_heatmaps:
        diff = np.abs(got[:-1].astype(np.int16) - want[:-1].astype(np.int16))
        assert diff.max() <= 1, what
        assert want[:-1].max() > 10, what  # the heatmaps are not all clipped to 0


@pytest.mark.parametrize("value", [True, False, None, (), [], 0, 2, [2, 0, 0], (1,), 1.0,
                                   "true", [3], [-1, 0]])
def test_normalize_tta_matches_jax(value):
    try:
        want = jax_common.normalize_tta(value)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            common.normalize_tta(value)
        assert str(got.value) == str(exc)
    else:
        assert common.normalize_tta(value) == want


@pytest.mark.parametrize("flips", [(), (0,), (0, 2)], ids=["none", "x", "xz"])
@pytest.mark.parametrize("kind", ["segmentation", "landmark"])
def test_tta_split_activations_matches_jax(kind, flips):
    jtask, variables, task = make_pair(kind)
    x = np.random.default_rng(1).normal(size=(3, 8, 8, 8, 1)).astype(np.float32)
    want = np.asarray(jax_common.tta_split_activations(jtask, variables, jnp.asarray(x), flips))
    with torch.inference_mode():
        got = common.tta_split_activations(
            task, torch.from_numpy(x).permute(0, 4, 1, 2, 3), flips)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, rtol=0,
                               atol=ACT_ATOL * max(1.0, float(np.abs(want).max())))
    # the uint8 postprocess of the same activations is exact
    post = common.postprocess_activations(task, torch.tensor(want).permute(0, 4, 1, 2, 3))
    want_post = np.asarray(jax_common.postprocess_activations(jtask, jnp.asarray(want)))
    np.testing.assert_array_equal(post.permute(0, 2, 3, 4, 1).numpy(), want_post)
    # make_predict_step with TTA is that postprocess of those activations
    if flips:
        step = make_predict_step(task, tta_flips=flips)(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        assert_prediction_matches(step.numpy().swapaxes(0, 1), np.moveaxis(want_post, -1, 0),
                                  want, HEATMAPS if kind == "landmark" else 0,
                                  f"predict step {kind} {flips}")


@pytest.mark.parametrize("stitch,kind", [("crop", "segmentation"), ("device", "segmentation"),
                                         ("device", "landmark")])
def test_stitches_with_tta_match_jax(stitch, kind):
    jtask, variables, task = make_pair(kind)
    store, attrs = make_store()
    keys = list(SHAPES)
    nh = HEATMAPS if kind == "landmark" else 0
    if stitch == "crop":
        ref = jax_predict_volumes(jtask, variables, None, keys, reader=JaxMemoryReader(store),
                                  pad_mode="constant", tta_flips=FLIPS, **KW)
        got = predict_volumes(task, None, keys, reader=MemoryReader(store, attrs),
                              device="cpu", tta_flips=FLIPS, **KW)
    else:
        ref = jax_predict_volumes_on_device(jtask, variables, None, keys,
                                            reader=JaxMemoryReader(store, attrs),
                                            tta_flips=FLIPS, **KW)
        got = predict_volumes_on_device(task, None, keys, reader=MemoryReader(store, attrs),
                                        device="cpu", tta_flips=FLIPS, **KW)
    for key in keys:
        act, corners, padded = jax_tile_activations(jtask, variables, store["images"][key], FLIPS)
        assert_prediction_matches(np.asarray(got[key]), np.asarray(ref[key]),
                                  core_stitch(act, corners, padded, SHAPES[key]), nh,
                                  f"{stitch} {kind} {key}")
        np.testing.assert_array_equal(np.asarray(got[key].attrs["affine"]), AFFINE)
