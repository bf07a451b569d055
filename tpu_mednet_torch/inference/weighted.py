"""Gaussian-weighted sliding-window stitching (``prediction.stitch: gaussian``).

Counterpart of ``tpu_mednet/inference/weighted.py``.  Every voxel of every
overlapping tile contributes to the result, weighted by a separable
Gaussian centred on the tile, so predictions near tile borders count less
and overlaps average instead of seaming.  Two pipelines:

- ``predict_volumes_weighted_on_device``: the volume is uploaded once in
  f16 and zero-padded on the card; each batch of tiles is cut by K2
  (``ops/patches.py``, the cast fused in), runs through the model (mirror
  TTA where asked), and each tile's ``w * activation`` and ``w`` are added
  into two fp32 accumulators over the padded domain.  Then the divide,
  the heatmap clip, the argmax of the class channels, the uint8 cast and
  the crop run on the card, and one device-to-host copy per volume brings
  the result back.  The HBM guard (``utils/memory.py``) spills a volume
  too large for the card to the host pipeline.
- ``predict_volumes_weighted``: the same weighting accumulated on the host
  over ``GridPatchSampler``'s tiles; the spill target and the oracle.

Zero padding, uint8 results and the window's default width only (the
predict CLI sets neither), as in the device stitch.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.data.grid import GridPatchSampler
from tpu_mednet_torch.data.readers import DataReader
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.inference.common import (check_model_device, grid_corners,
                                               predict_on_device, tta_split_activations)
from tpu_mednet_torch.inference.sliding_window import pad_batch
from tpu_mednet_torch.ops import patches

logger = logging.getLogger(__name__)

# x-planes of the padded domain whose class argmax is taken at once in the
# device finalize: bounds its int64 temporary
_ARGMAX_SLAB = 16


def gaussian_window(patch_size: Sequence[int], sigma_scale: float = 0.125,
                    floor: float = 1e-3) -> np.ndarray:
    """Separable Gaussian importance window over a patch, peak 1 at the centre."""
    axes = []
    for n in patch_size:
        x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        sigma = max(n * sigma_scale, 1e-6)
        axes.append(np.exp(-(x**2) / (2 * sigma**2)))
    w = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return np.maximum(w, floor).astype(np.float32)


def make_weighted_device_predictor(task, patch_size: Sequence[int], tta_flips=()):
    """Build the (volume, corners, n_tiles, pads) -> stitched result function.

    ``volume`` is the unpadded (X, Y, Z, C) f16 volume on the device;
    ``corners`` a host (n_batches, B, 3) int32 array of tile corners in the
    padded domain whose first ``n_tiles`` are the grid's, the rest repeats
    of the last that fill the tail batch: their forwards run, but they are
    not accumulated (a weighted sum, unlike the crop stitch's writes, is
    not idempotent).  Accumulates ``w * act`` (fp32, the model's
    out_channels wide) and ``w`` (fp32), divides by ``max(wacc, 1e-8)``,
    clips heatmaps to 0..255, takes the argmax of the class channels and
    returns the (L + 1, X, Y, Z) uint8 result cropped to the input extent
    (``pads[k][0]`` is the overlap).
    """
    num_heatmaps = getattr(task, "num_heatmaps", 0)
    n_act = task.model.config.out_channels
    px, py, pz = (int(v) for v in patch_size)
    window = torch.from_numpy(gaussian_window((px, py, pz)))
    tta_flips = tuple(tta_flips)

    def run(volume: torch.Tensor, corners: np.ndarray, n_tiles: int, pads) -> torch.Tensor:
        img_shape = volume.shape[:3]
        flat = [p for axis in reversed(pads) for p in axis]  # F.pad: last dim first
        volume = F.pad(volume, (0, 0, *flat))
        padded = volume.shape[:3]
        w = window.to(volume.device)
        acc = torch.zeros((n_act, *padded), dtype=torch.float32, device=volume.device)
        wacc = torch.zeros(padded, dtype=torch.float32, device=volume.device)
        seen = 0
        for corner_batch in corners:
            tiles = patches.extract_patches(volume, corner_batch, (px, py, pz),
                                            out_dtype=task.model.config.dtype)
            act = tta_split_activations(task, tiles.permute(0, 4, 1, 2, 3), tta_flips)
            wact = act * w
            for (x0, y0, z0), tile in zip(corner_batch[:n_tiles - seen].tolist(), wact):
                acc[:, x0:x0 + px, y0:y0 + py, z0:z0 + pz] += tile
                wacc[x0:x0 + px, y0:y0 + py, z0:z0 + pz] += w
            seen += len(corner_batch)
        del volume, tiles, act, wact
        (x0, x1), (y0, y1), (z0, z1) = ((p[0], p[0] + s) for p, s in zip(pads, img_shape))
        acc = acc[:, x0:x1, y0:y1, z0:z1]
        acc /= wacc[x0:x1, y0:y1, z0:z1].clamp_min_(1e-8)
        out = torch.empty((num_heatmaps + 1, *img_shape), dtype=torch.uint8,
                          device=acc.device)
        if num_heatmaps:
            out[:num_heatmaps] = acc[:num_heatmaps].clamp_(0.0, 255.0)
        for s in range(0, img_shape[0], _ARGMAX_SLAB):
            out[num_heatmaps, s:s + _ARGMAX_SLAB] = torch.argmax(
                acc[num_heatmaps:, s:s + _ARGMAX_SLAB], dim=0)
        return out

    return run


def predict_volumes_weighted_on_device(
    task,
    data_path,
    subject_keys: Sequence[str],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int = 8,
    image_group: str = "images",
    reader_cls=None,
    reader: Optional[DataReader] = None,
    device: DeviceLike = None,
    tta_flips=(),
    hbm_guard: str = "error",
    hbm_budget: Optional[int] = None,
    devices=None,
) -> VolumeGroup:
    """On-device drop-in for ``predict_volumes_weighted``: the same tiling
    geometry and weighting, one device-to-host copy per volume.  The
    model's parameters must live on ``device`` (``None`` means ``cuda``).
    ``tta_flips`` and ``hbm_guard``/``hbm_budget`` as in
    ``device_sliding.predict_volumes_on_device``; a volume that does not
    fit under ``warn`` goes to ``predict_volumes_weighted``; ``devices``
    deals volumes round-robin, as there."""
    tta_flips = tuple(tta_flips)

    def spill(keys, reader, dev):
        return predict_volumes_weighted(task, data_path, keys, patch_size, patch_overlap,
                                        batch_size, image_group=image_group, reader=reader,
                                        device=dev, tta_flips=tta_flips)

    return predict_on_device(
        task, data_path, subject_keys, patch_size, patch_overlap, batch_size, image_group,
        reader_cls, reader, device, tta_flips, hbm_guard, hbm_budget, stitch="gaussian",
        make_predictor=lambda t: make_weighted_device_predictor(t, patch_size, tta_flips),
        spill=spill, devices=devices)


def predict_volumes_weighted(
    task,
    data_path,
    subject_keys: Sequence[str],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int = 8,
    image_group: str = "images",
    reader: Optional[DataReader] = None,
    device: DeviceLike = None,
    tta_flips=(),
) -> VolumeGroup:
    """Sliding-window inference with Gaussian-weighted overlap averaging,
    accumulated on the host: the grid's tiles run through the model on
    ``device`` in batches, and ``w * activations`` over full tiles are
    summed in fp32 numpy volumes; the result is the argmax of the weighted
    average (heatmap channels averaged, then clipped to 0..255)."""
    dev = resolve_device(device)
    check_model_device(task, dev)
    task.model.eval()  # BatchNorm on its running statistics
    num_heatmaps = getattr(task, "num_heatmaps", 0)
    sampler = GridPatchSampler(data_path, subject_keys, patch_size, patch_overlap,
                               out_channels=num_heatmaps + 1, image_group=image_group,
                               reader=reader)
    window = gaussian_window(patch_size)
    window_dev = torch.from_numpy(window).to(dev)
    ps = np.asarray(patch_size, dtype=np.int64)
    ov = np.asarray(patch_overlap, dtype=np.int64)
    acc: Dict[str, np.ndarray] = {}
    wacc: Dict[str, np.ndarray] = {}
    for batch in sampler.batches(batch_size):
        n = batch["data"].shape[0]
        data = torch.from_numpy(pad_batch(batch["data"], batch_size)).to(dev)
        with torch.inference_mode():
            act = tta_split_activations(task, data.permute(0, 4, 1, 2, 3), tuple(tta_flips))
            out = (act * window_dev)[:n].cpu().numpy()
        for i, key in enumerate(batch["subject_key"]):
            if key not in acc:
                padded = tuple(grid_corners(sampler.data_shape[key][1:], ps, ov)[1])
                acc[key] = np.zeros((out.shape[1], *padded), dtype=np.float32)
                wacc[key] = np.zeros(padded, dtype=np.float32)
            sl = tuple(slice(p, p + s) for p, s in zip(batch["pos"][i], ps))
            acc[key][(slice(None), *sl)] += out[i]
            wacc[key][sl] += window
    for key in acc:
        img_size = np.asarray(sampler.data_shape[key][1:], dtype=np.int64)
        core = tuple(slice(o, o + s) for o, s in zip(ov, img_size))
        avg = acc[key][(slice(None), *core)] / np.maximum(wacc[key][core], 1e-8)
        cls = np.argmax(avg[num_heatmaps:], axis=0)[None]
        vol = np.concatenate([np.clip(avg[:num_heatmaps], 0.0, 255.0), cls]) \
            if num_heatmaps else cls
        ds = sampler.results.require_dataset(key, vol.shape, np.uint8)
        ds[:] = vol.astype(np.uint8)
        ds.attrs["affine"] = np.asarray(sampler.data_affine[key]).tolist()
    return sampler.results
