"""Overlap-tiled grid patches and their stitch on the host.

The port's copy of ``tpu_mednet/data/grid.py`` (reference
dataset.py:349-510): a generator of the complete overlapping tiling of a
padded volume, and a sampler/assembler pair that streams grid patches
across subjects and writes processed patches back into full-size result
volumes.  Geometry: the stride is ``patch_size - 2 * patch_overlap``; the
volume is padded by ``overlap`` at the leading edge and ``overlap +
overhead`` at the trailing edge, with ``overhead = (-size) % stride``,
and each tile's symmetric core is written back.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from tpu_mednet_torch.data.readers import DataReader, open_reader
from tpu_mednet_torch.data.stores import VolumeGroup

logger = logging.getLogger(__name__)


def grid_patch_generator(img: np.ndarray, patch_size: Sequence[int],
                         patch_overlap: Sequence[int]):
    """Yield ``(patch, corner_idx, count)`` over a complete overlapping tiling.

    ``img`` is (C, X, Y, Z); patches are (C, *patch_size); ``corner_idx`` is
    the patch position in the padded volume, which equals the position of
    the patch's cropped core in the original volume.  The padding is zeros,
    as in the device stitch.
    """
    patch_size = np.asarray(patch_size, dtype=np.int64)
    patch_overlap = np.asarray(patch_overlap, dtype=np.int64)
    img_size = np.asarray(img.shape[1:], dtype=np.int64)
    stride = patch_size - 2 * patch_overlap
    if np.any(stride <= 0):
        raise ValueError(
            f"patch_overlap {patch_overlap.tolist()} too large for patch_size "
            f"{patch_size.tolist()}")
    n_patches = np.ceil(img_size / stride).astype(np.int64)
    overhead = (-img_size) % stride
    padded = np.pad(img, [[0, 0]] + [
        [int(patch_overlap[k]), int(patch_overlap[k] + overhead[k])] for k in range(3)
    ])
    count = -1
    for p0 in range(n_patches[0]):
        for p1 in range(n_patches[1]):
            for p2 in range(n_patches[2]):
                idx = np.array([p0, p1, p2]) * stride
                end = idx + patch_size
                count += 1
                yield padded[:, idx[0]:end[0], idx[1]:end[1], idx[2]:end[2]], idx, count


class GridPatchSampler:
    """Streams grid patches across subjects and stitches processed results
    (reference ``GridPatchSampler``, dataset.py:391-510).  Iterate
    ``batches``; feed processed batches back through
    ``add_processed_batch``; collect the volumes with
    ``get_assembled_data``.  Results are uint8 masks."""

    def __init__(
        self,
        data_path,
        subject_keys: Sequence[str],
        patch_size: Sequence[int],
        patch_overlap: Sequence[int],
        out_channels: int = 1,
        channel_selection: Optional[Sequence[int]] = None,
        image_group: str = "images",
        reader: Optional[DataReader] = None,
    ):
        self.subject_keys = list(subject_keys)
        self.patch_size = np.asarray(patch_size, dtype=np.int64)
        self.patch_overlap = np.asarray(patch_overlap, dtype=np.int64)
        self.out_channels = out_channels
        self.channel_selection = channel_selection
        self.results = VolumeGroup()

        owns_reader = reader is None
        r = reader if reader is not None else open_reader(data_path)
        try:
            self.data_shape = r.get_data_shape(self.subject_keys, image_group)
            self.data_affine = r.get_data_attribute(self.subject_keys, image_group, "affine")
            self.data_generator = r.read_data_to_memory(self.subject_keys, image_group,
                                                        dtype=np.float16)
        finally:
            if owns_reader:
                r.close()

    def __iter__(self) -> Iterator[Dict[str, object]]:
        for subj_idx, sample in enumerate(self.data_generator):
            subject_key = self.subject_keys[subj_idx]
            for patch, idx, count in grid_patch_generator(
                    sample, self.patch_size, self.patch_overlap):
                data = patch if self.channel_selection is None else patch[
                    list(self.channel_selection)]
                yield {"data": data, "subject_key": subject_key, "pos": idx, "count": count}

    def batches(self, batch_size: int) -> Iterator[Dict[str, object]]:
        """The patch stream in batches of ``batch_size`` (the last may be
        shorter): ``data`` (N, X, Y, Z, C) fp32, ``subject_key``, ``pos``."""
        buf: List[Dict[str, object]] = []
        for patch in self:
            buf.append(patch)
            if len(buf) == batch_size:
                yield self._stack(buf)
                buf = []
        if buf:
            yield self._stack(buf)

    @staticmethod
    def _stack(buf: List[Dict[str, object]]) -> Dict[str, object]:
        data = np.stack([np.asarray(p["data"], dtype=np.float32) for p in buf])
        return {
            "data": np.ascontiguousarray(np.moveaxis(data, 1, -1)),
            "subject_key": [p["subject_key"] for p in buf],
            "pos": np.stack([p["pos"] for p in buf]),
        }

    def add_processed_batch(self, sample: Dict[str, object]) -> None:
        """Write processed patches into the assembled result volumes.

        ``sample['data']`` is (N, C, X, Y, Z), full patch-sized outputs; the
        symmetric overlap border is cropped, edge overhang is clipped to the
        volume, and the core is written at ``sample['pos']`` (reference
        dataset.py:444-474, with its axis-0 crop fixed).
        """
        data = np.asarray(sample["data"])
        ov = self.patch_overlap
        for i, key in enumerate(sample["subject_key"]):
            patch = data[i]
            cropped = patch[:, ov[0]:patch.shape[1] - ov[0], ov[1]:patch.shape[2] - ov[1],
                            ov[2]:patch.shape[3] - ov[2]]
            pos = np.asarray(sample["pos"][i], dtype=np.int64)
            pos_end = pos + np.asarray(cropped.shape[1:], dtype=np.int64)
            img_size = np.asarray(self.data_shape[key][1:], dtype=np.int64)
            crop_pos_end = np.minimum(pos_end, img_size)
            new_size = crop_pos_end - pos
            ds_shape = np.asarray(self.data_shape[key], dtype=np.int64)
            ds_shape[0] = self.out_channels
            ds = self.results.require_dataset(key, tuple(ds_shape), np.uint8)
            ds.attrs["affine"] = np.asarray(self.data_affine[key]).tolist()
            ds[:, pos[0]:crop_pos_end[0], pos[1]:crop_pos_end[1],
               pos[2]:crop_pos_end[2]] = cropped[:, :new_size[0], :new_size[1],
                                                 :new_size[2]].astype(np.uint8)

    def get_assembled_data(self) -> VolumeGroup:
        return self.results
