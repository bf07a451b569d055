"""Dataset statistics for training configs:
``python -m tpu_mednet_torch.cli.stats``.

The port's copy of ``tpu_mednet/cli/stats.py`` (the reference leaves
normalization constants and class weights to the user: ``--loss_weight``
has no way to be derived, ``midasmednet/segmentation.py:43-49``).  It
streams any readable store (HDF5, zarr, NIfTI directories) one volume at
a time and reports what a training config needs::

    python -m tpu_mednet_torch.cli.stats --data data.zarr
    python -m tpu_mednet_torch.cli.stats --data data/ --json stats.json

- per group: subject count, shape and dtype inventory, voxel-spacing range
  (from affines where present);
- images: per-channel mean/std and percentiles (p0.5/p99.5, the usual
  intensity-clipping bounds) from a uniform voxel subsample;
- labels: per-class voxel counts and frequencies, subjects per class, and
  inverse-frequency class weights normalized to mean 1, ready for
  ``--loss_weight``;
- heatmaps: per-channel peak amplitude and presence count.

Host numpy: it creates no tensor and uses no card.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import load_dotenv, read_keyfile, replace_env

logger = logging.getLogger("stats")

# cap on voxels kept for the percentile estimate (uniform stride subsample)
_SAMPLE_CAP = 10_000_000


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", required=True,
                        help="dataset store (h5/zarr/.zip/.nii directory)")
    parser.add_argument("--subjects", default=None,
                        help="key file (default: every key in image_group)")
    parser.add_argument("--image_group", default="images")
    parser.add_argument("--label_group", default="labels",
                        help="set empty ('') to skip label stats")
    parser.add_argument("--heatmap_group", default=None,
                        help="also report heatmap channel stats")
    parser.add_argument("--json", dest="json_path", default=None,
                        help="write the full result dict as JSON here")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def _spacing(reader, keys, group) -> Optional[dict]:
    try:
        affs = {k: reader.get_data_attribute([k], group, "affine")[k]
                for k in keys}
    except KeyError:
        return None
    sp = np.stack([np.linalg.norm(np.asarray(a, np.float64)[:3, :3], axis=0)
                   for a in affs.values() if a is not None])
    if not len(sp):
        return None
    return {"min": [float(v) for v in sp.min(0)],
            "max": [float(v) for v in sp.max(0)]}


def image_stats(reader, keys, group) -> dict:
    """Per-channel intensity statistics over a streamed uniform subsample."""
    count = 0
    total = None
    total_sq = None
    samples: list = []
    shapes = []
    dtypes = set()
    per_key_budget = max(_SAMPLE_CAP // max(len(keys), 1), 1)
    for vol in reader.read(keys, group, dtype=None):
        vol = np.asarray(vol)
        if vol.ndim == 3:
            vol = vol[None]
        shapes.append(vol.shape)
        dtypes.add(str(vol.dtype))
        flat = vol.reshape(vol.shape[0], -1).astype(np.float64)
        if total is None:
            total = flat.sum(1)
            total_sq = (flat**2).sum(1)
        else:
            total += flat.sum(1)
            total_sq += (flat**2).sum(1)
        count += flat.shape[1]
        stride = max(flat.shape[1] // per_key_budget, 1)
        samples.append(flat[:, ::stride].astype(np.float32))
    sample = np.concatenate(samples, axis=1)
    mean = total / count
    var = np.maximum(total_sq / count - mean**2, 0.0)
    pcts = np.percentile(sample, [0.5, 50.0, 99.5], axis=1)
    return {
        "subjects": len(keys),
        "channels": int(sample.shape[0]),
        "shapes": {"min": [int(v) for v in np.min(shapes, 0)],
                   "max": [int(v) for v in np.max(shapes, 0)]},
        "dtypes": sorted(dtypes),
        "mean": [float(v) for v in mean],
        "std": [float(v) for v in np.sqrt(var)],
        "p0.5": [float(v) for v in pcts[0]],
        "median": [float(v) for v in pcts[1]],
        "p99.5": [float(v) for v in pcts[2]],
        "sampled_voxels": int(sample.shape[1]),
    }


def label_stats(reader, keys, group) -> dict:
    """Exact per-class voxel counts + suggested inverse-frequency weights."""
    counts = np.zeros(0, np.int64)
    presence = np.zeros(0, np.int64)
    for vol in reader.read(keys, group, dtype=None):
        vol = np.asarray(vol)
        cls = vol[-1] if vol.ndim == 4 else vol  # class map is LAST channel
        c = np.bincount(np.asarray(cls, np.int64).ravel())
        if len(c) > len(counts):
            counts = np.pad(counts, (0, len(c) - len(counts)))
            presence = np.pad(presence, (0, len(c) - len(presence)))
        counts[: len(c)] += c
        presence[: len(c)] += (c > 0)
    freq = counts / max(counts.sum(), 1)
    # inverse-frequency weights, normalized to mean 1 over present classes
    present = counts > 0
    inv = np.zeros_like(freq)
    inv[present] = 1.0 / np.maximum(freq[present], 1e-12)
    if present.any():
        inv[present] /= inv[present].mean()
    return {
        "classes": int(len(counts)),
        "voxels": [int(v) for v in counts],
        "frequency": [float(v) for v in freq],
        "subjects_with_class": [int(v) for v in presence],
        "suggested_weights": [round(float(v), 4) for v in inv],
    }


def heatmap_stats(reader, keys, group) -> dict:
    peak = None
    present = None
    for vol in reader.read(keys, group, dtype=None):
        vol = np.asarray(vol)
        if vol.ndim == 3:
            vol = vol[None]
        m = vol.reshape(vol.shape[0], -1).max(1).astype(np.float64)
        peak = m if peak is None else np.maximum(peak, m)
        present = ((m > 0).astype(np.int64) if present is None
                   else present + (m > 0))
    return {
        "channels": int(len(peak)),
        "peak_amplitude": [float(v) for v in peak],
        "subjects_with_signal": [int(v) for v in present],
    }


def collect_stats(data, subjects=None, image_group="images",
                  label_group="labels", heatmap_group=None) -> dict:
    from tpu_mednet_torch.data.readers import open_reader

    reader = open_reader(data)
    try:
        keys = subjects or reader.list_keys(image_group)
        if not keys:
            raise SystemExit(f"no keys found in group {image_group!r}")
        result: dict = {"data": str(data), "subjects": list(keys)}
        result["images"] = image_stats(reader, keys, image_group)
        result["images"]["spacing"] = _spacing(reader, keys, image_group)
        if label_group:
            result["labels"] = label_stats(reader, keys, label_group)
        if heatmap_group:
            result["heatmaps"] = heatmap_stats(reader, keys, heatmap_group)
        return result
    finally:
        reader.close()


def _print_text(r: dict) -> None:
    im = r["images"]
    print(f"subjects   : {im['subjects']}")
    print(f"image shape: {im['shapes']['min']} .. {im['shapes']['max']} "
          f"dtype {','.join(im['dtypes'])}")
    if im.get("spacing"):
        print(f"spacing    : {im['spacing']['min']} .. {im['spacing']['max']}")
    for c in range(im["channels"]):
        print(f"channel {c}  : mean {im['mean'][c]:.4g} std {im['std'][c]:.4g}"
              f"  clip [{im['p0.5'][c]:.4g}, {im['p99.5'][c]:.4g}]"
              f" (median {im['median'][c]:.4g})")
    lb = r.get("labels")
    if lb:
        print("class  voxels        freq      subjects  weight")
        for c in range(lb["classes"]):
            print(f"{c:<6d} {lb['voxels'][c]:<13d} "
                  f"{lb['frequency'][c]:<9.5f} "
                  f"{lb['subjects_with_class'][c]:<9d}"
                  f" {lb['suggested_weights'][c]}")
        print(f"--loss_weight {' '.join(str(w) for w in lb['suggested_weights'])}")
    hm = r.get("heatmaps")
    if hm:
        for c in range(hm["channels"]):
            print(f"heatmap {c}  : peak {hm['peak_amplitude'][c]:.4g}, "
                  f"signal in {hm['subjects_with_signal'][c]} subjects")


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    subjects = read_keyfile(replace_env(args.subjects)) if args.subjects else None
    result = collect_stats(
        replace_env(args.data), subjects=subjects,
        image_group=args.image_group, label_group=args.label_group,
        heatmap_group=args.heatmap_group,
    )
    _print_text(result)
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(result, f, indent=2)
        logger.info("wrote %s", args.json_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
