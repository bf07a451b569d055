"""Write a ready-to-train synthetic dataset: ``python -m tpu_mednet_torch.cli.demo``.

The port's copy of ``tpu_mednet/cli/demo.py`` (the reference assumes a
lab-internal HDF5 file, ``midasmednet/dataset.py:513-523``).  It writes a
synthetic dataset with known labels and landmarks, key files and YAML
configs wired to them, so the whole workflow runs without a download::

    python -m tpu_mednet_torch.cli.demo --out demo/ --format zarr
    python -m tpu_mednet_torch.cli.train_seg -c demo/seg.yaml
    python -m tpu_mednet_torch.cli.train_ldmks -c demo/landmarks.yaml
    python -m tpu_mednet_torch.cli.predict -c demo/predict_seg.yaml \
        prediction.data=demo/pred_seg.zarr
    python -m tpu_mednet_torch.cli.evaluate --pred demo/pred_seg.zarr \
        --truth demo/data.zarr --subjects demo/test.txt
    python -m tpu_mednet_torch.cli.visualize --data demo/data.zarr \
        --pred demo/pred_seg.zarr --out demo/figs

Each subject is a noisy volume with a bright sphere (class 1) and a dark
box (class 2) at random positions; one Gaussian landmark heatmap sits at
each structure's center (peak 255, the reference heatmap convention).
``--modalities 4`` renders the structures at per-modality contrasts (a
BraTS-style multi-modal store), ``--heatmaps N`` adds landmarks at
structure poles and corners (up to 6), and ``--classes 2`` merges both
structures into one foreground class.  Labels hold the class map in their
last channel, heatmaps are a group of their own (the reference's
``<file>/<group>/<key>`` scheme, ``midasmednet/dataset.py:210-280``).
``--format h5|zarr|nii`` picks the store.  With the same ``--seed`` the
stores hold the same bytes as the JAX package's demo writes, and the
configs the same text; ``predict_*.yaml`` names ``pred_*.h5`` as the JAX
demo's do, so a host without h5py overrides ``prediction.data``.  Host
numpy: it creates no tensor and uses no card.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("demo")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--train", type=int, default=6,
                        help="training subjects")
    parser.add_argument("--val", type=int, default=2)
    parser.add_argument("--test", type=int, default=2)
    parser.add_argument("--size", type=int, default=64,
                        help="cubic volume extent (>= 32)")
    parser.add_argument("--modalities", type=int, default=1,
                        help="image channels per subject (e.g. 4 for a "
                             "BraTS-style multi-modal store; each modality "
                             "gets its own structure contrasts)")
    parser.add_argument("--heatmaps", type=int, default=2,
                        choices=range(1, 7),
                        help="landmark heatmap channels (1-6; landmarks sit "
                             "at structure centers/poles/corners)")
    parser.add_argument("--classes", type=int, default=3, choices=(2, 3),
                        help="label classes incl. background; 2 merges both "
                             "structures into one foreground class")
    parser.add_argument("--sigma", type=float, default=4.0,
                        help="landmark heatmap stddev in voxels")
    parser.add_argument("--spacing", type=float, default=1.0,
                        help="isotropic voxel spacing written to the affines")
    parser.add_argument("--format", default="h5", choices=("h5", "zarr", "nii"),
                        help="dataset store format")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


# per-modality (sphere, box) intensity contrasts: modality 0 is the classic
# bright-sphere/dark-box; further modalities vary magnitude and invert signs
# (a cartoon of T1/T2/FLAIR-style contrast differences between MR sequences)
_MODALITY_CONTRASTS = [(1.5, -1.5), (0.9, -2.0), (2.0, -0.8), (-1.2, 1.2),
                       (1.0, -1.0), (0.7, 1.5)]


def make_subject(rng: np.random.Generator, size: int, sigma: float,
                 modalities: int = 1, n_heatmaps: int = 2,
                 classes: int = 3):
    """One subject: bright sphere (class 1) + dark box (class 2 — or also
    class 1 when ``classes=2``) on noise; with ``modalities > 1`` each image
    channel renders the same structures at different contrasts; the
    ``n_heatmaps`` Gaussian landmarks sit at structure centers/poles/corners
    (each peak inside its structure, the reference heatmap convention)."""
    lbl = np.zeros((size, size, size), dtype=np.uint8)
    margin = max(size // 5, 8)

    c1 = rng.integers(margin, size - margin, size=3)
    r = int(rng.integers(size // 10, size // 6))
    zz, yy, xx = np.ogrid[:size, :size, :size]
    sphere = ((zz - c1[0]) ** 2 + (yy - c1[1]) ** 2
              + (xx - c1[2]) ** 2) <= r * r
    lbl[sphere] = 1

    # the box must not overwrite the sphere (each landmark's heatmap peak
    # sits inside its own structure); redraw on overlap — the sphere covers
    # a small fraction of the volume, so a handful of tries always suffices
    for _ in range(1000):
        c2 = rng.integers(margin, size - margin, size=3)
        h = max(int(rng.integers(size // 14, size // 9)), 2)
        box = (slice(c2[0] - h, c2[0] + h), slice(c2[1] - h, c2[1] + h),
               slice(c2[2] - h, c2[2] + h))
        if not lbl[box].any():
            break
    else:
        raise RuntimeError("could not place a non-overlapping box")
    lbl[box] = 2 if classes >= 3 else 1
    box_mask = np.zeros_like(lbl, dtype=bool)
    box_mask[box] = True

    img = np.empty((modalities, size, size, size), dtype=np.float32)
    for m in range(modalities):
        s_c, b_c = _MODALITY_CONTRASTS[m % len(_MODALITY_CONTRASTS)]
        chan = rng.normal(0.0, 0.1, size=(size, size, size)).astype(np.float32)
        chan[sphere] += s_c
        chan[box_mask] += b_c
        img[m] = chan

    # landmark anchors, cycled to n_heatmaps: structure centers first, then
    # sphere z-poles and box corners — every anchor inside its structure
    anchors = [
        c1, c2,
        c1 + np.array([max(r // 2, 1), 0, 0]),
        c2 + np.array([max(h // 2, 1)] * 3),
        c1 - np.array([max(r // 2, 1), 0, 0]),
        c2 - np.array([max(h // 2, 1)] * 3),
    ]
    heatmaps = np.zeros((n_heatmaps, size, size, size), dtype=np.uint8)
    grid = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"))
    for i in range(n_heatmaps):
        c = anchors[i % len(anchors)]
        d2 = ((grid - np.asarray(c)[:, None, None, None]) ** 2).sum(axis=0)
        heatmaps[i] = np.round(
            255.0 * np.exp(-d2 / (2 * sigma**2))).astype(np.uint8)
    return img, lbl[None], heatmaps


def write_dataset(out_dir: Path, fmt: str, n_train: int, n_val: int,
                  n_test: int, size: int, sigma: float, spacing: float,
                  seed: int, modalities: int = 1, n_heatmaps: int = 2,
                  classes: int = 3) -> Path:
    from tpu_mednet_torch.data.stores import VolumeGroup

    rng = np.random.default_rng(seed)
    affine = np.diag([spacing, spacing, spacing, 1.0])
    images, labels, heatmaps = VolumeGroup(), VolumeGroup(), VolumeGroup()
    splits = (["train"] * n_train + ["val"] * n_val + ["test"] * n_test)
    keys: dict = {"train": [], "val": [], "test": []}
    for i, split in enumerate(splits):
        key = f"s{i:03d}"
        keys[split].append(key)
        img, lbl, hm = make_subject(rng, size, sigma, modalities=modalities,
                                    n_heatmaps=n_heatmaps, classes=classes)
        for vg, arr, dtype in ((images, img, np.float16),
                               (labels, lbl, np.uint8),
                               (heatmaps, hm, np.uint8)):
            ds = vg.require_dataset(key, arr.shape, dtype)
            ds[...] = arr.astype(dtype)
            ds.attrs["affine"] = affine

    data_path = out_dir / {"h5": "data.h5", "zarr": "data.zarr",
                           "nii": "data.nii"}[fmt]
    # the store writers append (h5 mode="a" / zarr require_group): start
    # fresh so re-running into the same --out never leaves stale subjects
    if data_path.is_dir():
        import shutil

        shutil.rmtree(data_path)
    elif data_path.exists():
        data_path.unlink()
    images.save(data_path, group="images")
    labels.save(data_path, group="labels")
    heatmaps.save(data_path, group="heatmaps")
    for split, ks in keys.items():
        (out_dir / f"{split}.txt").write_text("".join(k + "\n" for k in ks))
    return data_path


def write_configs(out_dir: Path, data_path: Path, size: int,
                  sigma: float, modalities: int = 1, n_heatmaps: int = 2,
                  classes: int = 3) -> None:
    patch = min(size, 32)
    d = str(out_dir)
    reg_w = ", ".join(["0.02"] * n_heatmaps)
    (out_dir / "seg.yaml").write_text(f"""\
# mednet-demo segmentation config (synthetic spheres-and-boxes dataset)
data_path: {data_path}
train_set: {d}/train.txt
val_set: {d}/val.txt
model_dir: {d}/model_seg
log_dir: {d}/model_seg/logs
patch_size: [{patch}, {patch}, {patch}]
patches_per_subject: 4
max_epochs: 8
batch_size: 2
fmaps: 16
in_channels: {modalities}
out_channels: {classes}
loss: DICE
learning_rate: 0.001
""")
    (out_dir / "landmarks.yaml").write_text(f"""\
# mednet-demo landmark config ({n_heatmaps} heatmaps + {classes}-class auxiliary head)
data_path: {data_path}
train_set: {d}/train.txt
val_set: {d}/val.txt
model_dir: {d}/model_ldmks
log_dir: {d}/model_ldmks/logs
heatmap_group: heatmaps
patch_size: [{patch}, {patch}, {patch}]
patches_per_subject: 4
max_epochs: 8
batch_size: 2
fmaps: 16
in_channels: {modalities}
out_channels: {n_heatmaps + classes}          # {n_heatmaps} heatmaps + {classes} classes
loss_class: DICE
loss_regression: L2
loss_regression_weight: [{reg_w}]
learning_rate: 0.001
""")
    overlap = max(patch // 8, 2)
    sigma_list = "[" + ", ".join([str(sigma)] * n_heatmaps) + "]"
    for short, model, sigma_line in (
            ("seg", "SegmentationNet", "null"),
            ("ldmks", "LandmarkNet", sigma_list)):
        (out_dir / f"predict_{short}.yaml").write_text(f"""\
# mednet-demo prediction config ({model})
base:
  data: {data_path}
  image_group: images
  sigma: {sigma_line}
prediction:
  test_set: {d}/test.txt
  patch_size: [{patch}, {patch}, {patch}]
  patch_overlap: [{overlap}, {overlap}, {overlap}]
  batch_size: 4
  data: {d}/pred_{short}.h5
  group: prediction
  checkpoint: {d}/model_{short}
  chunk_size: 8
  model: {model}
  stitch: device
""")


def _reset_stale_outputs(out_dir: Path) -> None:
    """Re-running into an existing --out regenerates the data store; model
    checkpoints and predictions from a previous run would then be scored
    against DIFFERENT data (stale-subject confusion) — remove them too and
    say so.  Predictions go as ``pred_*.h5`` and, since the port's users
    write them where h5py is absent, as ``pred_*.zarr`` and ``pred_*.nii``."""
    import shutil

    stale = [p for p in (out_dir / "model_seg", out_dir / "model_ldmks",
                         out_dir / "figs")
             if p.is_dir()]
    stale += sorted(p for suffix in (".h5", ".zarr", ".nii")
                    for p in out_dir.glob(f"pred_*{suffix}"))
    if not stale:
        return
    for p in stale:
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()
    logger.warning(
        "removed stale outputs from a previous demo run (%s): the data "
        "store is regenerated, so old checkpoints/predictions no longer "
        "match it", ", ".join(p.name for p in stale),
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    if args.size < 32:
        raise SystemExit("--size must be >= 32 (structures need room)")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    _reset_stale_outputs(out_dir)
    data_path = write_dataset(out_dir, args.format, args.train, args.val,
                              args.test, args.size, args.sigma, args.spacing,
                              args.seed, modalities=args.modalities,
                              n_heatmaps=args.heatmaps, classes=args.classes)
    write_configs(out_dir, data_path, args.size, args.sigma,
                  modalities=args.modalities, n_heatmaps=args.heatmaps,
                  classes=args.classes)
    n = args.train + args.val + args.test
    print(f"wrote {n} subjects ({args.size}^3) to {data_path}")
    print("next steps:")
    print(f"  python -m tpu_mednet_torch.cli.train_seg   -c {out_dir}/seg.yaml")
    # landmarks.yaml leaves --loss_class_weight at its 2-entry default, which
    # train_ldmks refuses for a 3-class head: name the flag it needs
    weights = "" if args.classes == 2 else " --loss_class_weight 0.05 1.0 1.0"
    print(f"  python -m tpu_mednet_torch.cli.train_ldmks -c {out_dir}/landmarks.yaml{weights}")
    print(f"  python -m tpu_mednet_torch.cli.predict     -c {out_dir}/predict_seg.yaml")
    print(f"  python -m tpu_mednet_torch.cli.evaluate    --pred {out_dir}/pred_seg.h5 "
          f"--truth {data_path}")
    print(f"  python -m tpu_mednet_torch.cli.visualize   --data {data_path} "
          f"--pred {out_dir}/pred_seg.h5 --out {out_dir}/figs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
