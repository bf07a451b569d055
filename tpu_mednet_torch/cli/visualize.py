"""MIP figures from dataset and prediction stores: ``python -m tpu_mednet_torch.cli.visualize``.

The port's counterpart of ``tpu_mednet/cli/visualize.py``
(``mednet-visualize``): the three renderers of ``utils/plots.py``
(reference ``midasmednet/utils/plots.py:21-127``) as a CLI over any store
the port reads (zarr, loose-NIfTI directories, and HDF5 where h5py
imports), writing per-subject PNGs::

    python -m tpu_mednet_torch.cli.visualize --data data.zarr --out figs/
    python -m tpu_mednet_torch.cli.visualize --data data.zarr --pred out.zarr --out figs/

Per subject it writes whatever the inputs support:

- ``<key>_images.png`` — slice grid of every image channel;
- ``<key>_labels.png`` — tab10 MIP of the predicted class map (last
  prediction channel) vs the ground-truth class map (last label channel),
  alpha-overlaid on the projected image; with only one of the two masks
  available, a single-row MIP of that mask;
- ``<key>_heatmaps.png`` — GT (top) vs predicted (bottom) heatmap MIPs in
  inferno over the bone-projected image, when the prediction carries
  heatmap channels (landmark models: heatmaps first, class map last) or a
  ground-truth heatmap group is given.

Host-side numpy and matplotlib; it uses no card and takes no ``--device``.
Without matplotlib it exits with code 2 and a message naming it.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import load_dotenv, read_keyfile, replace_env

logger = logging.getLogger("visualize")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default=None,
                        help="dataset store with images (and labels/heatmaps)")
    parser.add_argument("--pred", default=None,
                        help="prediction store (the predict CLI's output)")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--subjects", default=None,
                        help="key file (default: every key in the prediction "
                             "group, else in the image group)")
    parser.add_argument("--image_group", default="images")
    parser.add_argument("--label_group", default="labels",
                        help="set empty ('') to skip the GT mask overlay")
    parser.add_argument("--heatmap_group", default=None,
                        help="ground-truth heatmap group (default: auto — "
                             "'heatmaps' when present and the prediction has "
                             "leading heatmap channels)")
    parser.add_argument("--pred_group", default="prediction")
    parser.add_argument("--mip_axis", type=int, default=1, choices=(0, 1, 2),
                        help="spatial axis projected out of the MIPs")
    parser.add_argument("--projection", default="mean", choices=("mean", "max"),
                        help="background projection for the overlays")
    parser.add_argument("--steps", type=int, default=5,
                        help="slices per channel in the image grid")
    parser.add_argument("--alpha", type=float, default=0.3,
                        help="mask overlay opacity")
    parser.add_argument("--dpi", type=int, default=150)
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def _read_volume(reader, key: str, group: str) -> Optional[np.ndarray]:
    from tpu_mednet_torch.data.readers import read_single_volume

    try:
        return read_single_volume(reader, key, group)
    except KeyError:
        return None


def _class_map(vol: np.ndarray) -> np.ndarray:
    """Class map is the LAST channel of a (C, X, Y, Z) volume."""
    return vol[-1] if vol.ndim == 4 else vol


def _normalized(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)


def _single_mask_figure(mask: np.ndarray, mip_axis: int,
                        background: Optional[np.ndarray], alpha: float,
                        projection: str):
    """One-tile variant of ``vis_loglabels`` for when only one of pred/GT
    exists (the two-tile renderer would duplicate or mislabel a tile)."""
    import matplotlib.pyplot as plt

    mip = np.max(np.asarray(mask), axis=mip_axis)
    fig, ax = plt.subplots()
    if background is not None:
        bg = np.asarray(background, np.float32)
        bg = bg.mean(axis=mip_axis) if projection == "mean" \
            else bg.max(axis=mip_axis)
        ax.imshow(bg, cmap="gray")
        ax.imshow(np.ma.array(mip, mask=(mip == 0)),
                  cmap="tab10", vmin=-0.1, vmax=9.9, alpha=alpha)
    else:
        ax.imshow(mip, cmap="tab10", vmin=-0.1, vmax=9.9)
    ax.axis("off")
    return fig


def render_subject(key: str, out_dir: Path, image: Optional[np.ndarray],
                   gt_label: Optional[np.ndarray],
                   gt_heatmaps: Optional[np.ndarray],
                   pred: Optional[np.ndarray], *, mip_axis: int = 1,
                   projection: str = "mean", steps: int = 5,
                   alpha: float = 0.3, dpi: int = 150) -> list:
    """Render every figure the given volumes support; returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tpu_mednet_torch.utils import plots

    written = []

    def save(fig, kind: str) -> None:
        path = out_dir / f"{key}_{kind}.png"
        fig.savefig(path, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    if image is not None and image.ndim == 3:
        image = image[None]
    bg = image[0] if image is not None else None

    if image is not None:
        fig, _ = plots.vis_logimages(image, steps=steps)
        fig.suptitle(key)
        save(fig, "images")

    pred_class = _class_map(pred) if pred is not None else None
    gt_class = _class_map(gt_label) if gt_label is not None else None
    if pred_class is not None and gt_class is not None:
        fig, _ = plots.vis_loglabels(
            gt_class, pred_class, mip_axis=mip_axis, inputs=bg,
            alpha=alpha, projection_type=projection)
        # vis_loglabels tiles [pred, truth] into one make_grid row
        fig.suptitle(f"{key} — pred (left) vs truth (right)")
        save(fig, "labels")
    elif pred_class is not None or gt_class is not None:
        mask = pred_class if pred_class is not None else gt_class
        fig = _single_mask_figure(mask, mip_axis, bg, alpha, projection)
        fig.suptitle(
            f"{key} — {'prediction' if pred_class is not None else 'truth'}")
        save(fig, "labels")

    pred_hm = pred[:-1] if pred is not None and pred.ndim == 4 \
        and pred.shape[0] > 1 else None
    if pred_hm is not None and gt_heatmaps is not None \
            and pred_hm.shape[0] != gt_heatmaps.shape[0]:
        logger.warning(
            "subject %s: prediction has %d heatmap channels but ground "
            "truth has %d — rendering the prediction only", key,
            pred_hm.shape[0], gt_heatmaps.shape[0])
        gt_heatmaps = None
    if pred_hm is not None and gt_heatmaps is not None:
        if bg is not None:
            fig, _ = plots.vis_logheatmaps(
                _normalized(bg), pred_hm, gt_heatmaps, mip_axis=mip_axis,
                projection_type=projection)
        else:
            fig, ax = plt.subplots()
            fg = np.concatenate([np.max(gt_heatmaps, axis=mip_axis + 1),
                                 np.max(pred_hm, axis=mip_axis + 1)])
            ax.imshow(plots.make_grid(fg, nrow=gt_heatmaps.shape[0]),
                      cmap="inferno", vmin=0.0, vmax=255.0)
            ax.axis("off")
        # vis_logheatmaps tight_layouts the axes over the full canvas; lift
        # the title above it (bbox_inches="tight" grows the saved figure)
        fig.suptitle(f"{key} — heatmaps: truth (top) / prediction (bottom)",
                     y=1.02)
        save(fig, "heatmaps")
    elif pred_hm is not None or gt_heatmaps is not None:
        # one-sided: a single-row grid (the two-row renderer would mirror
        # the same data into both rows — double render cost, confusing);
        # keep the anatomical context when a background image exists by
        # rendering the row over the bone-cmap projected input, like
        # vis_logheatmaps does for the two-row case
        hm = np.asarray(pred_hm if pred_hm is not None else gt_heatmaps,
                        np.float32)
        side = "prediction" if pred_hm is not None else "truth"
        fig, ax = plt.subplots()
        fg = plots.make_grid(np.max(hm, axis=mip_axis + 1), nrow=hm.shape[0])
        if bg is not None:
            mip = _normalized(bg).mean(axis=mip_axis) if projection == "mean" \
                else _normalized(bg).max(axis=mip_axis)
            grid_bg = plots.make_grid(np.stack(hm.shape[0] * [mip]),
                                      nrow=hm.shape[0])
            ax.imshow(grid_bg, cmap="bone", vmin=0.0, vmax=1.0)
            ax.imshow(fg, cmap="inferno", vmin=0.0, vmax=255.0, alpha=0.6)
        else:
            ax.imshow(fg, cmap="inferno", vmin=0.0, vmax=255.0)
        ax.axis("off")
        fig.suptitle(f"{key} — heatmaps: {side}", y=1.02)
        save(fig, "heatmaps")

    return written


def visualize(data=None, pred=None, out="figs", subjects=None,
              image_group="images", label_group="labels", heatmap_group=None,
              pred_group="prediction", mip_axis=1, projection="mean",
              steps=5, alpha=0.3, dpi=150) -> list:
    from tpu_mednet_torch.data.readers import open_reader

    if data is None and pred is None:
        raise SystemExit("at least one of --data / --pred is required")
    out_dir = Path(out)
    out_dir.mkdir(parents=True, exist_ok=True)

    data_reader = open_reader(data) if data else None
    pred_reader = open_reader(pred) if pred else None
    try:
        try:
            if subjects:
                keys = list(subjects)
            elif pred_reader is not None:
                keys = pred_reader.list_keys(pred_group)
            else:
                keys = data_reader.list_keys(image_group)
        except KeyError:
            which = (f"prediction store has no group {pred_group!r} (set "
                     f"--pred_group)") if pred_reader is not None else (
                     f"dataset has no group {image_group!r} (set "
                     f"--image_group)")
            raise SystemExit(which)
        if not keys:
            raise SystemExit("no subjects to render")

        # auto heatmap group, mirroring the evaluate CLI's detection; with a
        # prediction present it is confirmed per subject below (only a
        # landmark prediction — extra leading channels — uses it)
        hm_auto = heatmap_group is None
        if hm_auto and data_reader is not None:
            try:
                if data_reader.list_keys("heatmaps"):
                    heatmap_group = "heatmaps"
            except KeyError:
                pass

        written = []
        # per-group hit counters: _read_volume swallows KeyError per
        # subject, so a mistyped group name would otherwise silently drop
        # its figures for EVERY subject with no error
        hits = {}

        def tracked(reader, key, group, flag):
            hits.setdefault(flag, [group, 0])
            vol = _read_volume(reader, key, group)
            if vol is not None:
                hits[flag][1] += 1
            return vol

        for key in keys:
            image = (tracked(data_reader, key, image_group, "--image_group")
                     if data_reader is not None else None)
            gt_label = (tracked(data_reader, key, label_group,
                                "--label_group")
                        if data_reader is not None and label_group else None)
            gt_hm = (tracked(data_reader, key, heatmap_group,
                             "--heatmap_group")
                     if data_reader is not None and heatmap_group else None)
            pvol = (tracked(pred_reader, key, pred_group, "--pred_group")
                    if pred_reader is not None else None)
            if image is None and gt_label is None and pvol is None:
                logger.warning("subject %s: nothing to render, skipped", key)
                continue
            if gt_hm is not None and gt_hm.ndim == 3:
                gt_hm = gt_hm[None]
            if gt_hm is not None and hm_auto and pvol is not None \
                    and not (pvol.ndim == 4 and pvol.shape[0] > 1):
                # auto-detected GT heatmaps, but the prediction carries no
                # heatmap channels (segmentation run): skip the figure
                gt_hm = None
            paths = render_subject(
                key, out_dir, image, gt_label, gt_hm, pvol,
                mip_axis=mip_axis, projection=projection, steps=steps,
                alpha=alpha, dpi=dpi)
            logger.info("subject %s: %d figure(s)", key, len(paths))
            written.extend(paths)
        for flag, (group, n) in hits.items():
            if n == 0 and written and not (flag == "--heatmap_group"
                                           and hm_auto):
                logger.warning(
                    "group %r matched no subject in any store — figures "
                    "from it were skipped for all %d subject(s); check %s",
                    group, len(keys), flag)
        return written
    finally:
        if data_reader is not None:
            data_reader.close()
        if pred_reader is not None:
            pred_reader.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("visualize: matplotlib is not installed; it renders the figures",
              file=sys.stderr)
        return 2

    subjects = read_keyfile(replace_env(args.subjects)) if args.subjects \
        else None
    written = visualize(
        data=replace_env(args.data) if args.data else None,
        pred=replace_env(args.pred) if args.pred else None,
        out=replace_env(args.out), subjects=subjects,
        image_group=args.image_group, label_group=args.label_group,
        heatmap_group=args.heatmap_group, pred_group=args.pred_group,
        mip_axis=args.mip_axis, projection=args.projection,
        steps=args.steps, alpha=args.alpha, dpi=args.dpi)
    print(f"wrote {len(written)} figures to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
