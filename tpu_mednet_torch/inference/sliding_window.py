"""Sliding-window inference with the host stitch: tile -> forward -> crop.

Counterpart of ``tpu_mednet/inference/sliding_window.py`` (reference
``examples/predict.py:52-115``), the predict CLI's default ``stitch:
crop``: ``GridPatchSampler`` tiles each volume on the host, batches are
padded to a fixed size by repeating the last tile, each batch goes to the
device for the forward and the uint8 postprocess
(``train/step.py`` ``make_predict_step``, with mirror TTA where
``tta_flips`` asks for it), and the host crops and writes each tile's
core.  It is also where the device stitch spills a volume that does not
fit the card (``hbm_guard``).  With ``devices``, batch ``i`` runs on
``devices[i % n]`` (round-robin, ``inference/common.py``), where the JAX
package shards each batch over a mesh; the results are one device's.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.data.grid import GridPatchSampler
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.inference.common import check_model_device, round_robin_placement
from tpu_mednet_torch.train.step import make_predict_step

logger = logging.getLogger(__name__)


def pad_batch(data: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad the leading axis up to ``batch_size`` by repeating the last patch."""
    n = data.shape[0]
    if n == batch_size:
        return data
    return np.concatenate([data, np.repeat(data[-1:], batch_size - n, axis=0)], axis=0)


def predict_volumes(
    task,
    data_path,
    subject_keys: Sequence[str],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int = 8,
    out_channels: Optional[int] = None,
    channel_selection: Optional[Sequence[int]] = None,
    image_group: str = "images",
    reader=None,
    device: DeviceLike = None,
    tta_flips=(),
    devices=None,
) -> VolumeGroup:
    """Sliding-window inference over subjects with the task model's own
    weights, which must live on ``device`` (``None`` means ``cuda``);
    returns the assembled ``VolumeGroup`` (key -> (out_channels, X, Y, Z)
    volume with the input's affine).  With ``tta_flips`` (spatial axes
    0..2), mirror TTA averages 2^k flipped forwards per patch before the
    argmax.  ``devices`` (a list, or a ``RoundRobinPlacement``) deals the
    batches round-robin over them."""
    dev = resolve_device(device)
    check_model_device(task, dev)
    placement = round_robin_placement(task, devices)
    runs = ([(d, make_predict_step(t, tta_flips=tta_flips))
             for d, t in zip(placement.devices, placement.tasks)]
            if placement is not None else [(dev, make_predict_step(task, tta_flips=tta_flips))])
    if out_channels is None:
        out_channels = getattr(task, "num_heatmaps", 0) + 1
    sampler = GridPatchSampler(
        data_path, subject_keys, patch_size, patch_overlap, out_channels=out_channels,
        channel_selection=channel_selection, image_group=image_group, reader=reader)

    n_patches = 0
    for i, batch in enumerate(sampler.batches(batch_size)):
        n = batch["data"].shape[0]
        on, predict_step = runs[i % len(runs)]
        data = torch.from_numpy(pad_batch(batch["data"], batch_size)).to(on)
        out = predict_step(data.permute(0, 4, 1, 2, 3))[:n].cpu().numpy()
        sampler.add_processed_batch({**batch, "data": out})
        n_patches += n
    logger.info("processed %d patches over %d subjects", n_patches, len(list(subject_keys)))
    return sampler.get_assembled_data()
