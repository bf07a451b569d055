"""Class-balanced position and random patch-corner sampling (numpy only).

The port's own copy of ``tpu_mednet/data/sampling.py``, with the semantics
of the reference (``midasmednet/dataset.py:18-107``):

- ``get_labeled_position``  (dataset.py:18-52): pick a random voxel of a
  requested class using a precomputed per-class 2D any-mask over axis 2.
- ``get_random_patch_indices`` (dataset.py:55-88): uniform valid patch
  corners, optionally constrained to contain a given position.

Every function takes an explicit ``numpy.random.Generator``, and draws
from it in the same order as the JAX package, so one seed gives the same
corners in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_labeled_position(
    label: np.ndarray,
    class_value: int,
    label_any: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
) -> Optional[List[int]]:
    """Sample a random voxel position whose label equals ``class_value``.

    Returns ``None`` when the class is absent from the volume.  Matches the
    two-stage scheme of the reference (dataset.py:18-52): first draw a valid
    (axis0, axis1) cell from the precomputed any-mask, then draw the axis-2
    index among matching voxels in that column.
    """
    rng = rng or np.random.default_rng()
    if label_any is None:
        label_any = np.any(label == class_value, axis=2)

    valid_idx = np.argwhere(label_any)
    if valid_idx.size == 0:
        return None
    idx = valid_idx[rng.integers(0, valid_idx.shape[0])]
    column = label[idx[0], idx[1], :]
    matches = np.flatnonzero(column == class_value)
    return [int(idx[0]), int(idx[1]), int(rng.choice(matches))]


def get_random_patch_indices(
    patch_size: Sequence[int],
    img_shape: Sequence[int],
    pos: Optional[Sequence[int]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Uniformly sample valid ``[ini, fin)`` corner indices for a patch.

    With ``pos``, the sampled patch is constrained to contain that voxel
    (dataset.py:74-79); corners are clamped so the patch stays in bounds.
    """
    rng = rng or np.random.default_rng()
    patch_size = np.asarray(patch_size, dtype=np.int64)
    img_shape = np.asarray(img_shape, dtype=np.int64)
    if pos is not None:
        pos = np.asarray(pos, dtype=np.int64)
        min_index = np.maximum(pos - patch_size + 1, 0)
        max_index = np.minimum(img_shape - patch_size + 1, pos + 1)
    else:
        min_index = np.zeros(3, dtype=np.int64)
        max_index = img_shape - patch_size + 1
    index_ini = rng.integers(low=min_index, high=max_index)
    return index_ini, index_ini + patch_size
