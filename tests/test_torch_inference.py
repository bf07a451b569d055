"""The port's on-device sliding-window inference against the JAX package's.

Same weights (seeded in the port, carried to the JAX tree), same volumes,
same geometry: patch 8, overlap 2, batch 4 (27 and 36 tiles, so tail
batches repeat a corner), a 2-level f_maps-4 residual U-Net in fp32 on the
CPU.  The masks must be equal on every voxel where the JAX logits' top-2
margin exceeds 1e-4: inside that band a last-bit difference between the
frameworks' sums may pick the other class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.inference.device_sliding import _grid_corners as jax_grid_corners
from tpu_mednet.inference.device_sliding import (
    predict_volumes_on_device as jax_predict_volumes_on_device,
)
from tpu_mednet.models import UNet3DBase, UNetConfig
from tpu_mednet.tasks import SegmentationTask as JaxSegmentationTask
from tpu_mednet.utils.torch_import import convert_state_dict
from tpu_mednet_torch.data import MemoryReader
from tpu_mednet_torch.inference import device_sliding
from tpu_mednet_torch.inference.common import run_pipelined
from tpu_mednet_torch.models import ResidualUNet3D
from tpu_mednet_torch.tasks import SegmentationTask

SHAPES = ((24, 24, 24), (17, 19, 23))
KW = dict(patch_size=[8, 8, 8], patch_overlap=[2, 2, 2], batch_size=4)
TIE_BAND = 1e-4


def _store(shapes=SHAPES):
    rng = np.random.default_rng(0)
    store, attrs = {"images": {}}, {"images": {}}
    for i, shape in enumerate(shapes):
        img = rng.normal(0, 0.1, size=(1, *shape)).astype(np.float32)
        img[0, 4:12, 4:12, 4:12] += 2.0
        store["images"][f"s{i}"] = img
        attrs["images"][f"s{i}"] = {"affine": np.diag([2.0, 2.0, 2.0, 1.0])}
    return store, attrs


def _jax_margin(model, variables, vol_f16, patch, overlap):
    """Top-2 logit margin of the JAX model, stitched with the same cores."""
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
    for (x, y, z), m in zip(corners, margin):
        out[x + ov[0]:x + patch[0] - ov[0], y + ov[1]:y + patch[1] - ov[1],
            z + ov[2]:z + patch[2] - ov[2]] = m[ov[0]:patch[0] - ov[0],
                                                ov[1]:patch[1] - ov[1],
                                                ov[2]:patch[2] - ov[2]]
    return out[ov[0]:ov[0] + img[0], ov[1]:ov[1] + img[1], ov[2]:ov[2] + img[2]]


def test_predict_volumes_on_device_matches_jax():
    port = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, num_groups=2,
                          dtype=torch.float32, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    variables = convert_state_dict(port.state_dict())
    model = UNet3DBase(config=UNetConfig(in_channels=1, out_channels=2, f_maps=4,
                                         num_levels=2, num_groups=2, dtype=jnp.float32))
    keys = ["s0", "s1"]
    ref = jax_predict_volumes_on_device(
        JaxSegmentationTask(model=model, loss="DICE"), variables, None, keys,
        reader=JaxMemoryReader(*_store()), **KW)
    got = device_sliding.predict_volumes_on_device(
        SegmentationTask(model=port), None, keys, reader=MemoryReader(*_store()),
        device="cpu", **KW)

    store, _ = _store()
    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape == (1, *store["images"][k].shape[1:])
        assert a.dtype == b.dtype == np.uint8
        margin = _jax_margin(model, variables, store["images"][k].astype(np.float16),
                             KW["patch_size"], KW["patch_overlap"])
        clear = margin > TIE_BAND
        assert clear.mean() > 0.99
        np.testing.assert_array_equal(a[0][clear], b[0][clear])
        assert set(np.unique(a)) <= {0, 1}
        np.testing.assert_array_equal(np.asarray(got[k].attrs["affine"]),
                                      np.diag([2.0, 2.0, 2.0, 1.0]))


def test_grid_corners_is_the_jax_geometry():
    for img in ((24, 24, 24), (17, 19, 23), (160, 160, 160), (192, 176, 144)):
        for patch, ov in (((8, 8, 8), (2, 2, 2)), ((96, 96, 96), (16, 16, 16))):
            c_port, p_port = device_sliding._grid_corners(img, patch, ov)
            c_jax, p_jax = jax_grid_corners(img, patch, ov)
            np.testing.assert_array_equal(c_port, c_jax)
            np.testing.assert_array_equal(p_port, p_jax)
    corners, _ = device_sliding._grid_corners((160, 160, 160), (96,) * 3, (16,) * 3)
    assert len(corners) == 27  # 4 batches of 8 with a tail, on the chip slice


def test_predict_rejects_model_on_other_device_and_other_pad_modes(tmp_path):
    port = ResidualUNet3D(1, 2, f_maps=4, num_levels=2, device="cpu")
    task = SegmentationTask(model=port)
    with pytest.raises(ValueError, match="live on"):
        device_sliding.predict_volumes_on_device(
            task, None, ["s0"], reader=MemoryReader(*_store()), device="meta", **KW)
    # only zero padding is ported, so the option is not accepted at all
    with pytest.raises(TypeError, match="pad_mode"):
        device_sliding.predict_volumes_on_device(
            task, None, ["s0"], reader=MemoryReader(*_store()), device="cpu",
            pad_mode="reflect", **KW)
    # a directory of NIfTI volumes is read (NiftiReader) and predicts as
    # the same volumes from memory do
    from tpu_mednet_torch.utils.nifti import save_nifti

    store, attrs = _store()
    (tmp_path / "images").mkdir()
    save_nifti(tmp_path / "images" / "s1.nii", store["images"]["s1"][0],
               attrs["images"]["s1"]["affine"])
    got = device_sliding.predict_volumes_on_device(task, tmp_path, ["s1"], device="cpu", **KW)
    want = device_sliding.predict_volumes_on_device(
        task, None, ["s1"], reader=MemoryReader(store, attrs), device="cpu", **KW)
    np.testing.assert_array_equal(got["s1"].array, want["s1"].array)
    np.testing.assert_array_equal(got["s1"].attrs["affine"], want["s1"].attrs["affine"])


def test_run_pipelined_keeps_one_item_in_flight():
    events = []
    run_pipelined(((i,) for i in range(3)),
                  lambda i: (events.append(f"d{i}"), i)[1:],
                  lambda i: events.append(f"f{i}"))
    assert events == ["d0", "d1", "f0", "d2", "f1", "f2"]


@pytest.mark.parametrize("stitch", ["device", "gaussian"])
def test_predict_call_leaves_its_task_collectable(stitch):
    """No predict call keeps its task (and so its model's parameters) alive
    once the caller drops it: a long-lived process that predicts with one
    checkpoint after another holds one model at a time."""
    import gc
    import weakref

    from tpu_mednet_torch.inference import weighted

    predict = dict(device=device_sliding.predict_volumes_on_device,
                   gaussian=weighted.predict_volumes_weighted_on_device)[stitch]
    task = SegmentationTask(model=ResidualUNet3D(1, 2, f_maps=4, num_levels=2, num_groups=2,
                                                 dtype=torch.float32, device="cpu"))
    out = predict(task, None, ["s0", "s1"], reader=MemoryReader(*_store()), device="cpu",
                  tta_flips=(0,), **KW)
    assert out["s0"].array.shape == (1, *SHAPES[0])
    task_ref, model_ref = weakref.ref(task), weakref.ref(task.model)
    del task
    gc.collect()
    assert task_ref() is None and model_ref() is None


def test_from_hparams_and_postprocess():
    from types import SimpleNamespace

    hp = SimpleNamespace(in_channels=1, out_channels=3, fmaps=4, bf16=False, packed=True)
    task = SegmentationTask.from_hparams(hp, device="cpu")
    assert task.out_channels == 3 and task.model.config.dtype == torch.float32
    logits = torch.tensor([[0.1, 2.0, -1.0], [3.0, 3.0, 0.0]]).T.reshape(1, 3, 2, 1, 1)
    pred = task.predict_postprocess(logits)
    assert pred.dtype == torch.uint8 and pred.shape == (1, 1, 2, 1, 1)
    assert pred.flatten().tolist() == [1, 0]  # ties go to the first class
