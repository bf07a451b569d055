"""On-device sliding-window inference: tile -> forward -> stitch on the card.

Counterpart of ``tpu_mednet/inference/device_sliding.py``.  The volume is
uploaded once in f16 and padded on the device; each batch of tiles is cut
by K2 (``ops/patches.py``) with the cast to the compute dtype fused in,
runs through the model and the uint8 postprocess, and each tile's core is
written into the output volume by slice assignment — the cores tile the
padded volume disjointly (reference grid geometry, dataset.py:369-380).
The result is cropped to the input extent on the device, and one
device-to-host copy per volume brings it back.

Not ported yet: ``devices`` (round-robin multi-GPU), ``tta_flips``, the
HBM guard and the host-stitch spill.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.data.readers import DataReader, open_reader
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.inference.common import per_task_cache, run_pipelined
from tpu_mednet_torch.ops import patches


def _grid_corners(img_size, patch_size, overlap):
    """Static tile corners in the padded volume (reference stride geometry)."""
    img_size = np.asarray(img_size, dtype=np.int64)
    patch_size = np.asarray(patch_size, dtype=np.int64)
    overlap = np.asarray(overlap, dtype=np.int64)
    stride = patch_size - 2 * overlap
    if np.any(stride <= 0):
        raise ValueError("patch_overlap too large for patch_size")
    n = np.ceil(img_size / stride).astype(np.int64)
    corners = np.stack(np.meshgrid(
        *[np.arange(nk) * sk for nk, sk in zip(n, stride)], indexing="ij"
    ), axis=-1).reshape(-1, 3)
    overhead = (-img_size) % stride
    padded = img_size + 2 * overlap + overhead
    return corners.astype(np.int32), padded


def make_device_predictor(task, patch_size: Sequence[int],
                          patch_overlap: Sequence[int]):
    """Build the (volume, corners, pads) -> stitched result function.

    ``volume`` is the UNPADDED (X, Y, Z, C) f16 volume on the device;
    ``corners`` is a host (n_batches, batch_size, 3) int32 array of tile
    corners in the padded domain (the tail batch repeats a corner — later
    writes of identical content are harmless); ``pads`` is per-axis
    (before, after); the padding is zeros.  Returns the stitched
    (outC, X, Y, Z) uint8 volume on the device, already cropped to the
    input extent.
    """
    model = task.model
    px, py, pz = (int(v) for v in patch_size)
    ov = tuple(int(v) for v in patch_overlap)
    out_c = getattr(task, "num_heatmaps", 0) + 1

    def run(volume: torch.Tensor, corners: np.ndarray, pads) -> torch.Tensor:
        img_shape = volume.shape[:3]
        flat = [p for axis in reversed(pads) for p in axis]  # F.pad: last dim first
        volume = F.pad(volume, (0, 0, *flat))
        out = torch.zeros((out_c, *volume.shape[:3]), dtype=torch.uint8,
                          device=volume.device)
        for corner_batch in corners:
            tiles = patches.extract_patches(volume, corner_batch, (px, py, pz),
                                            out_dtype=model.config.dtype)
            logits = model(tiles.permute(0, 4, 1, 2, 3))  # (B, C, px, py, pz) view
            processed = task.predict_postprocess(logits)  # (B, outC, ...) uint8
            core = processed[:, :, ov[0]:px - ov[0], ov[1]:py - ov[1], ov[2]:pz - ov[2]]
            for (x0, y0, z0), tile in zip(corner_batch.tolist(), core):
                out[:, x0 + ov[0]:x0 + px - ov[0], y0 + ov[1]:y0 + py - ov[1],
                    z0 + ov[2]:z0 + pz - ov[2]] = tile
        return out[:, ov[0]:ov[0] + img_shape[0], ov[1]:ov[1] + img_shape[1],
                   ov[2]:ov[2] + img_shape[2]]

    return run


_PREDICTOR_CACHE: Dict[int, Dict] = {}


def _cached_predictor(task, patch_size, patch_overlap):
    return per_task_cache(
        _PREDICTOR_CACHE, task, (patch_size, patch_overlap),
        lambda: make_device_predictor(task, patch_size, patch_overlap),
    )


def _upload(vol: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host (C, X, Y, Z) f16 -> device (X, Y, Z, C), without blocking the
    host on the card's queue (a pageable copy would synchronize)."""
    t = torch.from_numpy(np.ascontiguousarray(vol))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.permute(1, 2, 3, 0).contiguous()


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
) -> VolumeGroup:
    """Sliding-window prediction of ``subject_keys`` with on-device stitching.

    The model's own parameters are used; they must live on ``device``
    (``None`` means ``cuda``).  The volume is zero-padded at its borders.
    Results are (outC, X, Y, Z) uint8 volumes in a ``VolumeGroup``, each
    with the input's ``affine`` attr.
    """
    dev = resolve_device(device)
    param_dev = next(task.model.parameters()).device
    if param_dev.type != dev.type or (dev.index is not None and param_dev != dev):
        raise ValueError(f"model parameters live on {param_dev}, not on {dev}")
    owns = reader is None
    r = reader if reader is not None else open_reader(data_path, reader_cls)
    try:
        affines = r.get_data_attribute(subject_keys, image_group, "affine")
        # f16 preload matches the reference/host pipeline (dataset.py:441)
        volumes = list(r.read(subject_keys, image_group, dtype=np.float16))
    finally:
        if owns:
            r.close()
    out_c = getattr(task, "num_heatmaps", 0) + 1
    predictor = _cached_predictor(task, tuple(patch_size), tuple(patch_overlap))
    ov = np.asarray(patch_overlap, dtype=np.int64)
    results = VolumeGroup()

    def dispatch(key, vol):
        img_size = np.asarray(vol.shape[1:], dtype=np.int64)
        corners, padded = _grid_corners(img_size, patch_size, patch_overlap)
        n_p = corners.shape[0]
        n_batches = -(-n_p // batch_size)
        pad_n = n_batches * batch_size - n_p
        if pad_n:
            corners = np.concatenate([corners, np.repeat(corners[-1:], pad_n, 0)])
        corners = corners.reshape(n_batches, batch_size, 3)
        pads = tuple(
            (int(o), int(p - s - o)) for o, p, s in zip(ov, padded, img_size)
        )
        return key, img_size, predictor(_upload(vol, dev), corners, pads)

    def finalize(key, img_size, out):
        ds = results.require_dataset(key, (out_c, *img_size), np.uint8)
        ds[:] = out.cpu().numpy()
        ds.attrs["affine"] = np.asarray(affines[key]).tolist()

    with torch.inference_mode():
        run_pipelined(zip(subject_keys, volumes), dispatch, finalize)
    return results
