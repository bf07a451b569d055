"""On-device sliding-window inference: tile -> forward -> stitch on the card.

Counterpart of ``tpu_mednet/inference/device_sliding.py``.  The volume is
uploaded once in f16 and padded on the device; each batch of tiles is cut
by K2 (``ops/patches.py``) with the cast to the compute dtype fused in,
runs through the model (2^k mirrored forwards of the same tiles under
``tta_flips``, averaged in activation space) and the uint8 postprocess
(heatmap channels first for a landmark task), and each tile's core is
written into the output volume by slice assignment — the cores tile the
padded volume disjointly (reference grid geometry, dataset.py:369-380).
The result is cropped to the input extent on the device, and one
device-to-host copy per volume brings it back.  Before anything is
uploaded, the HBM guard (``utils/memory.py``) sizes each volume and, under
``hbm_guard='warn'``, sends those that would not fit the card to the host
stitch (``sliding_window.predict_volumes``).  With ``devices``, volumes are
dealt round-robin across devices (``inference/common.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mednet_torch._device import DeviceLike
from tpu_mednet_torch.data.readers import DataReader
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.inference.common import (grid_corners, postprocess_activations,
                                               predict_on_device, tta_split_activations)
from tpu_mednet_torch.inference.sliding_window import predict_volumes
from tpu_mednet_torch.ops import patches

_grid_corners = grid_corners  # the reference's name (tpu_mednet/inference/device_sliding.py)


def make_device_predictor(task, patch_size: Sequence[int],
                          patch_overlap: Sequence[int], tta_flips=()):
    """Build the (volume, corners, n_tiles, pads) -> stitched result function.

    ``volume`` is the UNPADDED (X, Y, Z, C) f16 volume on the device;
    ``corners`` is a host (n_batches, batch_size, 3) int32 array of tile
    corners in the padded domain (the tail batch repeats a corner — later
    writes of identical content are harmless, so ``n_tiles``, the count
    of the grid's own corners, is not needed); ``pads`` is per-axis
    (before, after); the padding is zeros.  ``tta_flips`` (spatial axes
    0..2) averages 2^k mirrored forwards of each batch before the argmax.
    Returns the stitched (outC, X, Y, Z) uint8 volume on the device,
    cropped to the input extent.
    """
    model = task.model
    px, py, pz = (int(v) for v in patch_size)
    ov = tuple(int(v) for v in patch_overlap)
    out_c = getattr(task, "num_heatmaps", 0) + 1
    tta_flips = tuple(tta_flips)

    def run(volume: torch.Tensor, corners: np.ndarray, n_tiles: int,
            pads) -> torch.Tensor:
        img_shape = volume.shape[:3]
        flat = [p for axis in reversed(pads) for p in axis]  # F.pad: last dim first
        volume = F.pad(volume, (0, 0, *flat))
        out = torch.zeros((out_c, *volume.shape[:3]), dtype=torch.uint8,
                          device=volume.device)
        for corner_batch in corners:
            tiles = patches.extract_patches(volume, corner_batch, (px, py, pz),
                                            out_dtype=model.config.dtype)
            tiles = tiles.permute(0, 4, 1, 2, 3)  # (B, C, px, py, pz) view
            if tta_flips:
                processed = postprocess_activations(
                    task, tta_split_activations(task, tiles, tta_flips))
            else:
                processed = task.predict_postprocess(model(tiles))  # (B, outC, ...) uint8
            core = processed[:, :, ov[0]:px - ov[0], ov[1]:py - ov[1], ov[2]:pz - ov[2]]
            for (x0, y0, z0), tile in zip(corner_batch.tolist(), core):
                out[:, x0 + ov[0]:x0 + px - ov[0], y0 + ov[1]:y0 + py - ov[1],
                    z0 + ov[2]:z0 + pz - ov[2]] = tile
        return out[:, ov[0]:ov[0] + img_shape[0], ov[1]:ov[1] + img_shape[1],
                   ov[2]:ov[2] + img_shape[2]]

    return run


def predict_volumes_on_device(
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
    """Sliding-window prediction of ``subject_keys`` with on-device stitching.

    The model's own parameters are used; they must live on ``device``
    (``None`` means ``cuda``).  The volume is zero-padded at its borders.
    Results are (outC, X, Y, Z) uint8 volumes in a ``VolumeGroup``, each
    with the input's ``affine`` attr.  ``tta_flips``: mirror TTA over those
    spatial axes.  ``hbm_guard``: ``error`` raises ``HBMBudgetError`` for a
    volume whose estimate exceeds ``hbm_budget`` (default:
    ``utils/memory.hbm_budget_bytes``) before anything is uploaded; ``warn``
    stitches such volumes on the host with the same ``tta_flips``; ``off``
    skips the check.  ``devices`` (a list, or a ``RoundRobinPlacement``):
    volume ``i`` runs on ``devices[i % n]``, with the same results.
    """
    tta_flips = tuple(tta_flips)
    out_c = getattr(task, "num_heatmaps", 0) + 1

    def spill(keys, reader, dev):
        return predict_volumes(task, data_path, keys, patch_size, patch_overlap, batch_size,
                               out_channels=out_c, image_group=image_group, reader=reader,
                               device=dev, tta_flips=tta_flips)

    return predict_on_device(
        task, data_path, subject_keys, patch_size, patch_overlap, batch_size, image_group,
        reader_cls, reader, device, tta_flips, hbm_guard, hbm_budget, stitch="device",
        make_predictor=lambda t: make_device_predictor(t, patch_size, patch_overlap, tta_flips),
        spill=spill, devices=devices)
