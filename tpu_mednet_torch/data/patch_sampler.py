"""Host training patch sampler: class-balanced random 3D patches over subjects.

The port's copy of ``tpu_mednet/data/patch_sampler.py`` (reference
``MedDataset``, dataset.py:210-346): preloads images (f16) and labels (u8)
on the host, draws class-probability-weighted positions and random
corners, and crops patches in numpy, drawing from one
``numpy.random.Generator`` in the JAX package's order, so one seed gives
byte-equal batches in both packages.  With ``heatmap_group`` the stored
uint8 heatmaps are cropped with the labels and put before the class map
(dataset.py:322-330).

Batches are CPU tensors in the port's layout: logical (N, C, X, Y, Z) views
of contiguous (N, X, Y, Z, C) buffers (``channels_last_3d``), data fp32 and
labels uint8 with the class map last.  ``data/prefetch.py`` moves them to
the card.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tpu_mednet_torch.data.readers import DataReader, open_reader
from tpu_mednet_torch.data.sampling import get_labeled_position, get_random_patch_indices

logger = logging.getLogger(__name__)


class PatchSampler:
    """Class-balanced random patch sampler over preloaded subjects.

    Args mirror the reference ``MedDataset.__init__`` (dataset.py:212-239).
    """

    def __init__(
        self,
        data_path,
        subject_keys: Sequence[str],
        samples_per_subject: int,
        patch_size: Sequence[int],
        image_group: str = "images",
        label_group: str = "labels",
        heatmap_group: Optional[str] = None,
        reader: Optional[DataReader] = None,
        class_probabilities: Optional[Sequence[float]] = None,
        seed: int = 0,
    ):
        self.subject_keys = list(subject_keys)
        self.samples_per_subject = samples_per_subject
        self.patch_size = np.asarray(patch_size, dtype=np.int64)
        self.rng = np.random.default_rng(seed)
        self._pad_warned = False

        self.class_probabilities = None
        if class_probabilities is not None:
            p = np.asarray(class_probabilities, dtype=np.float64)
            self.class_probabilities = p / p.sum()

        owns_reader = reader is None
        r = reader if reader is not None else open_reader(data_path)
        try:
            self.images = r.read_data_to_memory(self.subject_keys, image_group,
                                                dtype=np.float16)
            self.labels = r.read_data_to_memory(self.subject_keys, label_group,
                                                dtype=np.uint8)
            self.heatmaps = None
            if heatmap_group:
                self.heatmaps = r.read_data_to_memory(self.subject_keys, heatmap_group,
                                                      dtype=np.uint8)
        finally:
            if owns_reader:
                r.close()

        if len(self.images) != len(self.labels):
            raise ValueError("number of label volumes must match image volumes")
        for i, (key, img) in enumerate(zip(self.subject_keys, self.images)):
            extent = tuple(int(e) for e in img.shape[1:])
            if np.any(np.asarray(extent) < self.patch_size):
                raise ValueError(
                    f"subject {key!r} volume extent {extent} is smaller than "
                    f"patch_size {tuple(int(p) for p in self.patch_size)}")
            lbl_extent = tuple(self.labels[i].shape[1:])
            if lbl_extent != extent:
                raise ValueError(
                    f"subject {key!r}: label volume extent {lbl_extent} "
                    f"({label_group!r}) does not match image extent {extent} "
                    f"({image_group!r})")
            if self.heatmaps is not None and tuple(self.heatmaps[i].shape[1:]) != extent:
                raise ValueError(
                    f"subject {key!r}: heatmap volume extent "
                    f"{tuple(self.heatmaps[i].shape[1:])} ({heatmap_group!r}) does not "
                    f"match image extent {extent} ({image_group!r})")
        # heatmap channels per subject, for the CLI's check against the config
        self.num_heatmap_channels = (int(self.heatmaps[0].shape[0])
                                     if self.heatmaps is not None else None)

        # per-(subject, class) any-masks over axis 2 of the class map (last
        # label channel), the reference's sampling-map trick (dataset.py:272-280)
        self._label_ax2_any: List[List[Optional[np.ndarray]]] = []
        if self.class_probabilities is not None:
            logger.info("pre-computing sampling maps ...")
            t = time.perf_counter()
            num_classes = len(self.class_probabilities)
            for lbl in self.labels:
                class_map = np.asarray(lbl[-1, ...])
                # background (0) is never position-sampled: skip its scan
                self._label_ax2_any.append(
                    [None] + [np.any(class_map == c, axis=2) for c in range(1, num_classes)])
            logger.debug("finished %.3f s", time.perf_counter() - t)

    def __len__(self) -> int:
        return len(self.images) * self.samples_per_subject

    def sample(self, idx: int) -> Dict[str, object]:
        """Draw one training patch (reference ``__getitem__``,
        dataset.py:285-346): ``data`` (C, X, Y, Z) fp32, ``label``
        (C, X, Y, Z) uint8 (heatmap channels first, class map last),
        ``subject_key``, ``patch_position``, ``selected_class``."""
        idx = idx % len(self.images)
        imgs = self.images[idx]
        lbls = self.labels[idx]

        pos = None
        selected_class = 0
        if self.class_probabilities is not None:
            selected_class = int(
                self.rng.choice(len(self.class_probabilities), p=self.class_probabilities))
            if selected_class > 0:
                pos = get_labeled_position(
                    np.asarray(lbls[-1]), selected_class,
                    label_any=self._label_ax2_any[idx][selected_class], rng=self.rng)

        ini, fin = get_random_patch_indices(self.patch_size, imgs.shape[1:], pos=pos,
                                            rng=self.rng)
        sl = (slice(None), slice(ini[0], fin[0]), slice(ini[1], fin[1]),
              slice(ini[2], fin[2]))
        label = np.asarray(lbls[sl], dtype=np.uint8)
        if self.heatmaps is not None:
            label = np.concatenate([np.asarray(self.heatmaps[idx][sl], dtype=np.uint8),
                                    label], axis=0)
        return {
            "subject_key": self.subject_keys[idx],
            "patch_position": ini,
            "selected_class": selected_class,
            "data": np.asarray(imgs[sl], dtype=np.float32),
            "label": label,
        }

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[Dict[str, object]]:
        """One epoch of stacked batches: ``data`` (N, C, X, Y, Z) fp32 and
        ``label`` (N, C, X, Y, Z) uint8, channels-last CPU tensors.  A
        trailing partial batch is dropped; an epoch shorter than one batch
        is padded by re-drawing with replacement, as in the JAX package, so
        a small validation set still yields a batch."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        if 0 < len(order) < batch_size:
            if not self._pad_warned:
                logger.warning(
                    "epoch has %d items (< batch_size %d): padding the batch by "
                    "re-drawing %d samples with replacement — epoch composition "
                    "diverges from subjects x samples_per_subject",
                    len(order), batch_size, batch_size - len(order))
                self._pad_warned = True
            extra = self.rng.choice(order, size=batch_size - len(order), replace=True)
            order = np.concatenate([order, extra])
        for start in range(0, len(order) - batch_size + 1, batch_size):
            chunk = order[start:start + batch_size]
            samples = [self.sample(int(i)) for i in chunk]
            data = np.stack([np.moveaxis(s["data"], 0, -1) for s in samples])
            label = np.stack([np.moveaxis(s["label"], 0, -1) for s in samples])
            yield {
                "data": torch.from_numpy(data).permute(0, 4, 1, 2, 3),
                "label": torch.from_numpy(label).permute(0, 4, 1, 2, 3),
                "subject_key": [s["subject_key"] for s in samples],
                "selected_class": np.asarray([s["selected_class"] for s in samples]),
            }
