"""Landmark readout from stitched predictions.

The port's copy of ``heatmap_peaks`` and ``landmark_readout``
(``tpu_mednet/utils/evaluation.py:115-185``): numpy on the host, over the
predict CLI's (C, X, Y, Z) volumes with the heatmap channels first.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def heatmap_peaks(heatmaps: np.ndarray) -> np.ndarray:
    """Peak voxel coordinate per channel of an (L, X, Y, Z) heatmap stack."""
    flat = heatmaps.reshape(heatmaps.shape[0], -1)
    idx = flat.argmax(axis=1)
    return np.stack(np.unravel_index(idx, heatmaps.shape[1:]), axis=-1).astype(np.float64)


def landmark_readout(volume: np.ndarray, num_heatmaps: int,
                     affine: Optional[np.ndarray] = None) -> List[Dict[str, object]]:
    """One dict per landmark of a (C, X, Y, Z) prediction volume: ``voxel``
    (the argmax [x, y, z]), ``peak`` (the heatmap's value there, 0-255; 0
    means the landmark was found nowhere) and, with a RAS ``affine``,
    ``physical`` ([x, y, z] mapped through it)."""
    hm = np.asarray(volume[:num_heatmaps], np.float32)
    peaks = heatmap_peaks(hm)
    out: List[Dict[str, object]] = []
    for i in range(num_heatmaps):
        vox = peaks[i]
        entry: Dict[str, object] = {
            "voxel": [float(v) for v in vox],
            "peak": float(hm[i][tuple(vox.astype(int))]),
        }
        if affine is not None:
            phys = np.asarray(affine, np.float64) @ np.append(vox, 1.0)
            entry["physical"] = [float(v) for v in phys[:3]]
        out.append(entry)
    return out
