"""Device-resident patch sampling: volumes live on the card, the host draws indices.

Counterpart of ``tpu_mednet/data/device_sampler.py``:

1. all subject volumes are padded to a common shape and stacked into
   device tensors once at start-up (images bf16, labels uint8, both
   channels-last (S, X, Y, Z, C));
2. per batch, the host only draws subject indices and class-balanced
   corners (``data/sampling.py``, the same numpy draws in the same order
   as the JAX package, so one seed gives the same batches);
3. K2 (``ops/patches.py``, indexed by subject) cuts the training patches
   out of the device store: no per-step host-to-device volume traffic.

Corners are drawn against each subject's true shape, so a patch never
reads padding.  Heatmap and landmark groups are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.data.readers import DataReader, open_reader
from tpu_mednet_torch.data.sampling import get_labeled_position, get_random_patch_indices
from tpu_mednet_torch.ops import patches

logger = logging.getLogger(__name__)


class DevicePatchSampler:
    """Patch sampler over a device-resident store of the subjects' volumes.

    Yields batches ``{"data": (N, C, px, py, pz), "label": (N, Cl, px, py,
    pz)}``: ``channels_last_3d`` views of the gathered (N, px, py, pz, C)
    windows, data in bf16 and labels uint8 (class map last).
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
        landmark_group: Optional[str] = None,
        reader_cls=None,
        reader: Optional[DataReader] = None,
        class_probabilities: Optional[Sequence[float]] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        if heatmap_group or landmark_group:
            raise NotImplementedError("heatmap and landmark groups are not ported yet")
        dev = resolve_device(device)
        self.subject_keys = list(subject_keys)
        self.samples_per_subject = samples_per_subject
        self.patch_size = np.asarray(patch_size, dtype=np.int64)
        self.rng = np.random.default_rng(seed)

        self.class_probabilities = None
        if class_probabilities is not None:
            p = np.asarray(class_probabilities, dtype=np.float64)
            self.class_probabilities = p / p.sum()

        owns = reader is None
        r = reader if reader is not None else open_reader(data_path, reader_cls)
        images = list(r.read(self.subject_keys, image_group, dtype=np.float32))
        labels = list(r.read(self.subject_keys, label_group, dtype=np.uint8))
        if owns:
            r.close()

        # a smaller label volume would otherwise be zero-padded into silent
        # misalignment with the image
        for key, img, lbl in zip(self.subject_keys, images, labels):
            if lbl.shape[1:] != img.shape[1:]:
                raise ValueError(
                    f"subject {key!r}: label volume extent {lbl.shape[1:]} "
                    f"({label_group!r}) does not match image extent {img.shape[1:]} "
                    f"({image_group!r})")

        self.shapes = np.asarray([img.shape[1:] for img in images], dtype=np.int64)
        if np.any(self.shapes < self.patch_size):
            raise ValueError("a subject volume is smaller than the patch size")
        pad_shape = self.shapes.max(axis=0)

        def stack(vols, dtype):
            out = np.zeros((len(vols), vols[0].shape[0], *pad_shape), dtype=dtype)
            for i, v in enumerate(vols):
                s = v.shape
                out[i, :, : s[1], : s[2], : s[3]] = v
            return np.ascontiguousarray(np.moveaxis(out, 1, -1))  # (S, X, Y, Z, C)

        self.images = torch.from_numpy(stack(images, np.float32)).to(torch.bfloat16).to(dev)
        self.labels = torch.from_numpy(stack(labels, np.uint8)).to(dev)
        logger.info("device store: %d subjects padded to %s, ~%.2f GB",
                    len(images), pad_shape.tolist(),
                    (self.images.nbytes + self.labels.nbytes) / 1e9)

        # host-side class-balanced sampling maps (reference dataset.py:272-280)
        self._class_maps: List[np.ndarray] = [lbl[-1] for lbl in labels]
        self._label_ax2_any: List[List[Optional[np.ndarray]]] = []
        if self.class_probabilities is not None:
            ncls = len(self.class_probabilities)
            for cm in self._class_maps:
                # background (0) is never position-sampled: skip its scan
                self._label_ax2_any.append(
                    [None] + [np.any(cm == c, axis=2) for c in range(1, ncls)])

    def __len__(self) -> int:
        return len(self.subject_keys) * self.samples_per_subject

    def sample_indices(self, batch_size: int, subj: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side draw of (subject index, corner) per element, as int32
        arrays.  ``subj`` fixes the subjects; corners are drawn fresh."""
        if subj is None:
            subj = self.rng.integers(0, len(self.subject_keys), size=batch_size)
        corners = np.zeros((batch_size, 3), dtype=np.int32)
        for i, s in enumerate(subj):
            pos = None
            if self.class_probabilities is not None:
                cls = int(self.rng.choice(len(self.class_probabilities),
                                          p=self.class_probabilities))
                if cls > 0:
                    pos = get_labeled_position(self._class_maps[s], cls,
                                               label_any=self._label_ax2_any[s][cls],
                                               rng=self.rng)
            ini, _ = get_random_patch_indices(self.patch_size, self.shapes[s], pos=pos,
                                              rng=self.rng)
            corners[i] = ini
        return subj.astype(np.int32), corners

    def gather(self, subj: np.ndarray, corners: np.ndarray) -> Dict[str, torch.Tensor]:
        """K2 on the device store: one launch for the images, one for the labels."""
        data = patches.extract_patches(self.images, corners, self.patch_size, subjects=subj)
        label = patches.extract_patches(self.labels, corners, self.patch_size, subjects=subj)
        return {"data": data.permute(0, 4, 1, 2, 3), "label": label.permute(0, 4, 1, 2, 3)}

    def batches(self, batch_size: int) -> Iterator[Dict[str, torch.Tensor]]:
        """One epoch = a permutation of (subject, sample) pairs, exactly
        ``samples_per_subject`` draws per subject (reference epoch semantics,
        dataset.py:282-283), in full batches: a trailing partial batch is
        dropped, and an epoch shorter than one batch raises."""
        items = np.repeat(np.arange(len(self.subject_keys), dtype=np.int64),
                          self.samples_per_subject)
        if len(items) < batch_size:
            raise ValueError(f"an epoch of {len(items)} patches is shorter than one "
                             f"batch of {batch_size}")
        items = self.rng.permutation(items)
        for start in range(0, len(items) - batch_size + 1, batch_size):
            subj = items[start:start + batch_size]
            yield self.gather(*self.sample_indices(batch_size, subj=subj))
