"""The port's Gaussian stitch against the JAX package's, with mirror TTA.

Both pipelines — the on-device accumulate (``predict_volumes_weighted_on_device``,
tiles cut by K2's plain version on the CPU) and the host accumulate
(``predict_volumes_weighted``, the spill target) — against JAX's of the
same name, on the models, volumes and geometry of ``test_torch_tta.py``
(patch 8, overlap 2, batch 4, TTA over axis 2).  Class maps must be
equal on every voxel where the top-2 margin of JAX's Gaussian-weighted
average of its TTA-averaged class probabilities exceeds 1e-4; heatmaps
within 1 (the uint8 cast of a value an ulp from an integer).  The window
itself is equal to JAX's bit for bit.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_tta import (FLIPS, HEATMAPS, KW, OVERLAP, PATCH, SHAPES,  # noqa: F401
                                  assert_prediction_matches, jax_tile_activations,
                                  make_pair, make_store, one_torch_thread)
from tpu_mednet.data import MemoryReader as JaxMemoryReader
from tpu_mednet.inference import weighted as jax_weighted
from tpu_mednet_torch.data import MemoryReader
from tpu_mednet_torch.inference import weighted


def weighted_average(act, corners, padded, img, patch=PATCH, overlap=OVERLAP):
    """JAX's tile activations (N, px, py, pz, C) averaged with the Gaussian
    window over the padded domain, cropped to ``img``."""
    window = jax_weighted.gaussian_window(patch)
    acc = np.zeros((*padded, act.shape[-1]), np.float32)
    wacc = np.zeros(tuple(padded), np.float32)
    for (x, y, z), a in zip(corners, act):
        sl = (slice(x, x + patch[0]), slice(y, y + patch[1]), slice(z, z + patch[2]))
        acc[sl] += a * window[..., None]
        wacc[sl] += window
    core = tuple(slice(o, o + s) for o, s in zip(overlap, img))
    return acc[core] / np.maximum(wacc[core], 1e-8)[..., None]


@pytest.mark.parametrize("patch,sigma", [((8, 8, 8), 0.125), ((96, 96, 96), 0.125),
                                         ((5, 7, 9), 0.125), ((16, 12, 8), 0.3)])
def test_gaussian_window_matches_jax(patch, sigma):
    got = weighted.gaussian_window(patch, sigma)
    want = jax_weighted.gaussian_window(patch, sigma)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pipeline,kind", [("device", "segmentation"), ("host", "segmentation"),
                                           ("device", "landmark"), ("host", "landmark")])
def test_weighted_pipelines_match_jax(pipeline, kind):
    jtask, variables, task = make_pair(kind)
    store, attrs = make_store()
    keys = list(SHAPES)
    nh = HEATMAPS if kind == "landmark" else 0
    if pipeline == "device":
        ref = jax_weighted.predict_volumes_weighted_on_device(
            jtask, variables, None, keys, reader=JaxMemoryReader(store, attrs),
            tta_flips=FLIPS, **KW)
        got = weighted.predict_volumes_weighted_on_device(
            task, None, keys, reader=MemoryReader(store, attrs), device="cpu",
            tta_flips=FLIPS, **KW)
    else:
        ref = jax_weighted.predict_volumes_weighted(
            jtask, variables, None, keys, reader=JaxMemoryReader(store, attrs),
            tta_flips=FLIPS, **KW)
        with torch.inference_mode():
            got = weighted.predict_volumes_weighted(
                task, None, keys, reader=MemoryReader(store, attrs), device="cpu",
                tta_flips=FLIPS, **KW)
    for key in keys:
        act, corners, padded = jax_tile_activations(jtask, variables, store["images"][key], FLIPS)
        avg = weighted_average(act, corners, padded, SHAPES[key])
        assert_prediction_matches(np.asarray(got[key]), np.asarray(ref[key]), avg, nh,
                                  f"gaussian {pipeline} {kind} {key}")
        assert got[key].attrs["affine"] == ref[key].attrs["affine"]
