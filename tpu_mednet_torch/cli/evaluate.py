"""Score a prediction store against ground truth:
``python -m tpu_mednet_torch.cli.evaluate``.

The port's copy of ``tpu_mednet/cli/evaluate.py`` (the reference scores
nothing after training; its only quality signal is the validation Dice,
``midasmednet/segmentation.py:104-109``).  Reads any store the port
writes or trains from (HDF5, zarr, NIfTI directories) through
``open_reader`` and reports, per subject and as means over subjects:

- segmentation: per-class Dice, IoU, precision, recall, volume error, and
  (``--surface``) the 95th-percentile Hausdorff and average symmetric
  surface distance in physical units where the stores carry affines;
- landmarks: per-landmark heatmap peak-to-peak error in voxels and mm.

Prediction volumes follow the predict CLI's layout (heatmap channels
first, class map last); ground-truth labels are the dataset's label group
(class map in the last channel).  Host numpy and scipy: it creates no
tensor and uses no card.

    python -m tpu_mednet_torch.cli.evaluate --pred out.zarr --truth data.zarr \
        --subjects test.txt
    python -m tpu_mednet_torch.cli.evaluate --pred out.nii --truth data --surface \
        --json scores.json
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import load_dotenv, replace_env

logger = logging.getLogger("evaluate")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred", required=True,
                        help="prediction store (h5/zarr/.nii directory)")
    parser.add_argument("--truth", required=True,
                        help="ground-truth store")
    parser.add_argument("--subjects", default=None,
                        help="key file (one subject per line); default: "
                             "every key in the prediction group")
    parser.add_argument("--pred_group", default="prediction",
                        help="group holding predicted volumes")
    parser.add_argument("--label_group", default="labels")
    parser.add_argument("--heatmap_group", default=None,
                        help="ground-truth heatmap group; enables landmark "
                             "scoring (default: auto when the prediction "
                             "has extra leading channels and the truth "
                             "store has a 'heatmaps' group)")
    parser.add_argument("--classes", type=int, default=None,
                        help="number of classes (default: max class value "
                             "in truth+pred labels + 1)")
    parser.add_argument("--surface", action="store_true",
                        help="also compute HD95 + ASSD (scipy)")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the full result dict as JSON here")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def _read_volume(reader, key: str, group: str) -> np.ndarray:
    from tpu_mednet_torch.data.readers import read_single_volume

    return read_single_volume(reader, key, group)


def _affine(reader, key: str, group: str) -> Optional[np.ndarray]:
    try:
        a = reader.get_data_attribute([key], group, "affine")[key]
        return None if a is None else np.asarray(a, np.float64)
    except KeyError:
        return None


def _subject_keys(args, pred_reader) -> list:
    if args.subjects:
        text = open(replace_env(args.subjects)).read()
        return [line.strip() for line in text.splitlines() if line.strip()]
    try:
        return pred_reader.list_keys(args.pred_group)
    except NotImplementedError:
        raise SystemExit(
            "--subjects is required for stores that cannot enumerate keys"
        )
    except KeyError:
        raise SystemExit(
            f"prediction store has no group {args.pred_group!r} "
            f"(set --pred_group to the group predict wrote)"
        )


def evaluate(args) -> dict:
    from tpu_mednet_torch.data.readers import open_reader
    from tpu_mednet_torch.utils.evaluation import (
        aggregate,
        landmark_errors,
        overlap_metrics,
        spacing_from_affine,
        surface_distances,
    )

    pred_reader = open_reader(replace_env(args.pred))
    truth_reader = open_reader(replace_env(args.truth))
    keys = _subject_keys(args, pred_reader)
    if not keys:
        raise SystemExit("no subjects to evaluate")

    seg_rows, surf_rows, ldmk_rows = [], [], []
    heatmap_group = args.heatmap_group
    auto_heatmaps = heatmap_group is None
    # without --classes the class count grows with observed label values;
    # rows computed before a later subject revealed a new class get padded
    # with nan entries below (identical to "absent from both volumes")
    n_classes = args.classes or 0
    per_subject: dict = {}
    for key in keys:
        pred = _read_volume(pred_reader, key, args.pred_group)
        truth = _read_volume(truth_reader, key, args.label_group)
        # class map is the LAST channel (framework convention); tolerate
        # channel-less 3D volumes from foreign stores
        pred_mask = pred[-1] if pred.ndim == 4 else pred
        true_mask = truth[-1] if truth.ndim == 4 else truth
        if pred_mask.shape != true_mask.shape:
            raise SystemExit(
                f"{key}: prediction {pred_mask.shape} vs truth "
                f"{true_mask.shape} spatial shapes disagree"
            )
        num_heatmaps = pred.shape[0] - 1 if pred.ndim == 4 else 0
        if heatmap_group is None and num_heatmaps > 0:
            heatmap_group = "heatmaps"
            logger.info("prediction has %d heatmap channels; scoring "
                        "landmarks against group 'heatmaps'", num_heatmaps)
        if not args.classes:
            n_classes = max(n_classes,
                            int(max(pred_mask.max(), true_mask.max())) + 1)

        affine = _affine(truth_reader, key, args.label_group)
        spacing = spacing_from_affine(affine)
        subject: dict = {}
        seg = overlap_metrics(pred_mask, true_mask, n_classes)
        seg_rows.append(seg)
        subject["segmentation"] = seg
        if args.surface:
            surf = surface_distances(pred_mask, true_mask, n_classes,
                                     spacing=spacing)
            surf_rows.append(surf)
            subject["surface"] = surf
        if num_heatmaps > 0 and heatmap_group:
            try:
                true_hm = _read_volume(truth_reader, key, heatmap_group)
            except KeyError:
                if not auto_heatmaps:
                    raise SystemExit(
                        f"truth store has no heatmap volume "
                        f"{heatmap_group}/{key}"
                    )
                logger.warning(
                    "truth store has no %r group; skipping landmark "
                    "scoring", heatmap_group)
                heatmap_group = ""  # disable for the remaining subjects
                true_hm = None
            if true_hm is not None:
                ldmk = landmark_errors(
                    np.asarray(pred[:num_heatmaps], np.float32),
                    np.asarray(true_hm[:num_heatmaps], np.float32),
                    spacing=spacing,
                )
                ldmk_rows.append(ldmk)
                subject["landmarks"] = ldmk
        subject["spacing"] = [float(s) for s in spacing]
        per_subject[key] = subject

    # pad rows computed before the class count grew (same lists back the
    # per-subject JSON, so those pad in place too)
    nan_seg = {k: float("nan") for k in
               ("dice", "iou", "precision", "recall", "volume_error")}
    for row in seg_rows:
        row.extend(dict(nan_seg) for _ in range(n_classes - len(row)))
    for row in surf_rows:
        row.extend({"hd95": float("nan"), "assd": float("nan")}
                   for _ in range(n_classes - len(row)))
    logger.info("evaluated %d classes over %d subjects", n_classes,
                len(keys))

    result = {
        "pred": str(args.pred),
        "truth": str(args.truth),
        "n_subjects": len(keys),
        "n_classes": n_classes,
        "subjects": per_subject,
        "mean": {"segmentation": aggregate(seg_rows)},
    }
    if surf_rows:
        result["mean"]["surface"] = aggregate(surf_rows)
    if ldmk_rows:
        result["mean"]["landmarks"] = aggregate(ldmk_rows)
    return result


def _print_table(result: dict) -> None:
    print(f"subjects   : {result['n_subjects']}")
    print(f"classes    : {result['n_classes']}")
    seg = result["mean"]["segmentation"]
    surf = result["mean"].get("surface")
    hdr = "class   dice     iou      precision recall   vol_err"
    if surf:
        hdr += "  hd95     assd"
    print(hdr + "   (means over finite per-subject values)")
    for c, row in enumerate(seg):
        line = (f"{c:<7d} {row['dice']:<8.4f} {row['iou']:<8.4f} "
                f"{row['precision']:<9.4f} {row['recall']:<8.4f} "
                f"{row['volume_error']:<7.4f}")
        if surf:
            line += f"  {surf[c]['hd95']:<8.3f} {surf[c]['assd']:<8.3f}"
        print(line)
    ldmk = result["mean"].get("landmarks")
    if ldmk:
        print("landmark  err_voxels  err_mm")
        for i, row in enumerate(ldmk):
            print(f"{i:<9d} {row['voxels']:<11.3f} {row['mm']:<7.3f}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    result = evaluate(args)
    _print_table(result)
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(result, f, indent=2, default=str)
        logger.info("wrote %s", args.json_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
