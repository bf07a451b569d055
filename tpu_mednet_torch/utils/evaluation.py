"""Evaluation metrics for segmentation masks and landmark heatmaps.

The port's copy of ``tpu_mednet/utils/evaluation.py``: Dice, IoU,
precision, recall and volume error per class (``overlap_metrics``), the
95th-percentile Hausdorff and average symmetric surface distance through
scipy's EDT (``surface_distances``), heatmap peak errors
(``landmark_errors``), the argmax readout of a predict volume
(``landmark_readout``) and nan-aware means over subjects (``aggregate``).
Host numpy and scipy only, over the predict CLI's (C, X, Y, Z) volumes
with the heatmap channels first.  Physical units come from a volume's RAS
affine (spacing = the column norms of its 3x3 block), else voxels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def spacing_from_affine(affine: Optional[np.ndarray]) -> np.ndarray:
    """Per-axis voxel spacing = column norms of the affine's 3x3 block."""
    if affine is None:
        return np.ones(3)
    affine = np.asarray(affine, dtype=np.float64)
    return np.linalg.norm(affine[:3, :3], axis=0)


def overlap_metrics(pred_mask: np.ndarray, true_mask: np.ndarray,
                    n_classes: int) -> List[Dict[str, float]]:
    """Per-class overlap metrics between integer class maps.

    Returns one dict per class with ``dice``, ``iou``, ``precision``,
    ``recall`` and ``volume_error`` (|pred−true|/true voxel counts; inf for
    a class absent from the truth but present in the prediction).  Classes
    absent from BOTH volumes score ``nan`` across the board — averaging
    with ``np.nanmean`` then skips them instead of rewarding trivial 1.0s.
    """
    out = []
    for c in range(n_classes):
        p = pred_mask == c
        g = true_mask == c
        np_, ng = int(p.sum()), int(g.sum())
        if np_ == 0 and ng == 0:
            out.append({k: float("nan") for k in
                        ("dice", "iou", "precision", "recall",
                         "volume_error")})
            continue
        tp = int(np.logical_and(p, g).sum())
        union = np_ + ng - tp
        out.append({
            "dice": 2.0 * tp / (np_ + ng),
            "iou": tp / union if union else float("nan"),
            "precision": tp / np_ if np_ else 0.0,
            "recall": tp / ng if ng else 0.0,
            "volume_error": abs(np_ - ng) / ng if ng else float("inf"),
        })
    return out


def _boundary(mask: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    struct = ndimage.generate_binary_structure(3, 1)
    return mask & ~ndimage.binary_erosion(mask, struct, border_value=0)


def surface_distances(
    pred_mask: np.ndarray,
    true_mask: np.ndarray,
    n_classes: int,
    spacing: Optional[Sequence[float]] = None,
) -> List[Dict[str, float]]:
    """Per-class boundary-distance metrics (scipy EDT).

    Returns one dict per class with ``hd95`` (symmetric 95th-percentile
    Hausdorff) and ``assd`` (average symmetric surface distance), in the
    units of ``spacing`` (voxels when None).  A class empty on exactly one
    side has no finite surface distance and scores ``inf``; empty on both
    sides scores ``nan``.
    """
    from scipy import ndimage

    spacing = np.ones(3) if spacing is None else np.asarray(spacing,
                                                            np.float64)
    out = []
    for c in range(n_classes):
        p = pred_mask == c
        g = true_mask == c
        if not p.any() and not g.any():
            out.append({"hd95": float("nan"), "assd": float("nan")})
            continue
        if not p.any() or not g.any():
            out.append({"hd95": float("inf"), "assd": float("inf")})
            continue
        pb, gb = _boundary(p), _boundary(g)
        # distance of every voxel to the NEAREST boundary voxel of the
        # other mask, sampled at this mask's boundary
        d_to_g = ndimage.distance_transform_edt(~gb, sampling=spacing)
        d_to_p = ndimage.distance_transform_edt(~pb, sampling=spacing)
        d_pg = d_to_g[pb]
        d_gp = d_to_p[gb]
        out.append({
            "hd95": float(max(np.percentile(d_pg, 95),
                              np.percentile(d_gp, 95))),
            "assd": float(np.concatenate([d_pg, d_gp]).mean()),
        })
    return out


def heatmap_peaks(heatmaps: np.ndarray) -> np.ndarray:
    """Peak voxel coordinate per channel of an (L, X, Y, Z) heatmap stack."""
    flat = heatmaps.reshape(heatmaps.shape[0], -1)
    idx = flat.argmax(axis=1)
    return np.stack(np.unravel_index(idx, heatmaps.shape[1:]), axis=-1).astype(np.float64)


def landmark_errors(
    pred_heatmaps: np.ndarray,
    true_heatmaps: np.ndarray,
    spacing: Optional[Sequence[float]] = None,
) -> List[Dict[str, float]]:
    """Per-landmark peak-to-peak distance between heatmap stacks.

    Both stacks are (L, X, Y, Z); each channel's landmark estimate is its
    argmax voxel (the readout the matched-accuracy harness uses).  Returns
    one dict per landmark with the error in ``voxels`` and, when a spacing
    is supplied, in physical ``mm``.  An all-zero truth channel (missing
    landmark) scores ``nan``.
    """
    if pred_heatmaps.shape != true_heatmaps.shape:
        raise ValueError(
            f"heatmap stacks disagree: predicted {pred_heatmaps.shape} vs "
            f"truth {true_heatmaps.shape}"
        )
    sp = np.ones(3) if spacing is None else np.asarray(spacing, np.float64)
    pk_p = heatmap_peaks(pred_heatmaps)
    pk_t = heatmap_peaks(true_heatmaps)
    out = []
    for i in range(pred_heatmaps.shape[0]):
        if not true_heatmaps[i].any():
            out.append({"voxels": float("nan"), "mm": float("nan")})
            continue
        delta = pk_p[i] - pk_t[i]
        out.append({
            "voxels": float(np.linalg.norm(delta)),
            "mm": float(np.linalg.norm(delta * sp)),
        })
    return out


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


def aggregate(per_subject: List[List[Dict[str, float]]]) -> List[Dict[str, float]]:
    """nanmean each (class/landmark, metric) cell over subjects."""
    if not per_subject:
        return []
    n_items = len(per_subject[0])
    keys = list(per_subject[0][0].keys())
    agg = []
    for i in range(n_items):
        cell = {}
        for k in keys:
            vals = np.asarray([s[i][k] for s in per_subject], np.float64)
            finite_or_nan = vals[~np.isinf(vals)]
            with np.errstate(invalid="ignore"):
                cell[k] = (float(np.nanmean(finite_or_nan))
                           if finite_or_nan.size else float("inf"))
        agg.append(cell)
    return agg
