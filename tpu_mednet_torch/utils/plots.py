"""MIP visualization figures, and the Trainer's sample-visualizer hooks.

Counterpart of ``tpu_mednet/utils/plots.py`` (reference
``midasmednet/utils/plots.py:21-127``): slice grids of the input channels,
max-intensity projections of predicted vs ground-truth label maps (tab10
over the projected input), and ground-truth vs predicted heatmap MIPs
(inferno over bone).  Arrays are channels-first numpy ((C, X, Y, Z)).

Each hook is split in two halves:

- *compute* (``seg_sample_arrays``, ``landmark_sample_arrays``): the
  eval-mode forward of ``trainer.state.model`` on the batch's first row,
  on the Trainer's device (through K1), then the host argmax and the
  heatmap split; it returns the very arrays the JAX hook hands its
  renderers;
- *render* (``render_seg_sample``, ``render_landmark_sample``): matplotlib
  figures from those arrays.

matplotlib is imported only inside the renderers, so this module imports
without it.  Where it is absent, ``make_seg_sample_visualizer`` and
``make_landmark_sample_visualizer`` warn once, naming matplotlib, and
return None: no hook is installed, no forward is spent on figures, and
training is what it is without ``--log_vis_mip``.  (The JAX package
imports matplotlib with this module and fails there instead.)
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)
_WARNED = False


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Tile a stack of 2D images (N, H, W) into one (H', W') grid image."""
    images = np.asarray(images, dtype=np.float32)
    n, h, w = images.shape
    ncol = min(nrow, n)
    nrows = int(np.ceil(n / ncol))
    grid = np.full((nrows * (h + padding) + padding, ncol * (w + padding) + padding),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = c * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[i]
    return grid


def label_mips(labels: np.ndarray, pred_class: np.ndarray, mip_axis: int = 1) -> np.ndarray:
    """(2, H, W): the maximum projections of the predicted and the
    ground-truth class maps, the two tiles of ``vis_loglabels``."""
    return np.stack([np.max(np.asarray(pred_class), axis=mip_axis),
                     np.max(np.asarray(labels), axis=mip_axis)])


def heatmap_mips(output_heatmaps: np.ndarray, heatmaps: np.ndarray,
                 mip_axis: int = 1) -> np.ndarray:
    """(2L, H, W): the ground-truth heatmaps' maximum projections, then the
    predicted ones, the tiles of ``vis_logheatmaps``."""
    return np.concatenate([np.asarray(heatmaps, dtype=np.float32).max(axis=mip_axis + 1),
                           np.asarray(output_heatmaps, dtype=np.float32).max(axis=mip_axis + 1)])


def _project(inputs: np.ndarray, mip_axis: int, projection_type: str) -> np.ndarray:
    return inputs.mean(axis=mip_axis) if projection_type == "mean" else inputs.max(axis=mip_axis)


def vis_logimages(inputs: np.ndarray, steps: int = 5):
    """Grid of every ``num_slices // steps``-th axis-1 slice per channel
    (reference plots.py:21-42)."""
    plt = _pyplot()
    inputs = np.asarray(inputs, dtype=np.float32)
    channels = inputs.shape[0]
    num_slices = inputs.shape[2]
    stride = max(num_slices // steps, 1)
    tiles = np.concatenate([
        np.stack([inputs[c, :, idx, :] for idx in range(0, num_slices, stride)])
        for c in range(channels)])
    grid = make_grid(tiles, nrow=steps)
    fig, ax = plt.subplots()
    ax.imshow(grid, cmap="gray")
    ax.axis("off")
    return fig, ax


def vis_loglabels(labels: np.ndarray, pred_class: np.ndarray, mip_axis: int = 1,
                  inputs: Optional[np.ndarray] = None, alpha: float = 0.3,
                  projection_type: str = "mean"):
    """MIP of predicted vs ground-truth masks, optionally alpha-overlaid on
    the projected input with the tab10 colormap (reference plots.py:45-89)."""
    if projection_type not in ("mean", "max"):
        raise ValueError("projection_type must be 'mean' or 'max'")
    plt = _pyplot()
    grid_mask = make_grid(label_mips(labels, pred_class, mip_axis))
    fig, ax = plt.subplots()
    if inputs is not None:
        mip = _project(np.asarray(inputs, dtype=np.float32), mip_axis, projection_type)
        grid_bg = make_grid(np.stack(2 * [mip]))
        ax.imshow(grid_bg, cmap="gray")
        ax.imshow(np.ma.array(grid_mask, mask=(grid_mask == 0)),
                  cmap="tab10", vmin=-0.1, vmax=9.9, alpha=alpha)
    else:
        ax.imshow(grid_mask, cmap="tab10", vmin=-0.1, vmax=9.9)
    ax.axis("off")
    return fig, ax


def vis_logheatmaps(inputs: np.ndarray, output_heatmaps: np.ndarray,
                    heatmaps: np.ndarray, mip_axis: int = 1, alpha: float = 0.6,
                    projection_type: str = "mean"):
    """GT (top row) vs predicted (bottom row) heatmap MIPs in inferno
    (vmax=255) over the bone-cmap projected input (reference
    plots.py:92-127)."""
    if projection_type not in ("mean", "max"):
        raise ValueError("projection_type must be 'mean' or 'max'")
    plt = _pyplot()
    num_heatmaps = np.shape(heatmaps)[0]
    mip = _project(np.asarray(inputs, dtype=np.float32), mip_axis, projection_type)
    grid_bg = make_grid(np.stack(2 * num_heatmaps * [mip]), nrow=num_heatmaps)
    grid_fg = make_grid(heatmap_mips(output_heatmaps, heatmaps, mip_axis), nrow=num_heatmaps)
    fig, ax = plt.subplots()
    ax.imshow(grid_bg, cmap="bone", vmin=0.0, vmax=1.0)
    ax.imshow(grid_fg, cmap="inferno", vmin=0.0, vmax=255.0, alpha=alpha)
    ax.axis("off")
    plt.tight_layout()
    return fig, ax


# -- Trainer hooks: compute ---------------------------------------------------


def first_row_logits(trainer, batch) -> np.ndarray:
    """(C, X, Y, Z) fp32 logits of the batch's first row: the eval-mode
    forward of ``trainer.state.model`` (its own parameters, BatchNorm on
    its running statistics, as the JAX hook applies ``state.params``)."""
    model = trainer.state.model
    model.eval()
    with torch.inference_mode():
        logits = model(batch["data"][:1].to(model.config.dtype))
    return logits[0].float().cpu().numpy()


def seg_sample_arrays(trainer, batch) -> Dict[str, np.ndarray]:
    """What the segmentation hook renders: ``inputs`` (C, X, Y, Z) fp32,
    the ground-truth class map ``label`` and the predicted ``pred``
    (X, Y, Z), of the batch's first row."""
    logits = first_row_logits(trainer, batch)
    return {"inputs": batch["data"][0].float().cpu().numpy(),
            "label": batch["label"][0, -1].cpu().numpy(),
            "pred": np.argmax(logits, axis=0)}


def landmark_sample_arrays(trainer, batch, num_heatmaps: int) -> Dict[str, np.ndarray]:
    """``seg_sample_arrays`` of a landmark batch (the class map from the
    class logits after the first ``num_heatmaps`` channels), plus the
    ground-truth and predicted heatmaps, (L, X, Y, Z) fp32."""
    logits = first_row_logits(trainer, batch)
    label = batch["label"][0].cpu().numpy()
    return {"inputs": batch["data"][0].float().cpu().numpy(),
            "label": label[-1],
            "pred": np.argmax(logits[num_heatmaps:], axis=0),
            "gt_heatmaps": label[:-1].astype(np.float32),
            "out_heatmaps": logits[:num_heatmaps]}


# -- Trainer hooks: render ----------------------------------------------------


def render_seg_sample(arrays: Dict[str, np.ndarray], epoch: int, batch_id: int,
                      projection_type: str = "mean") -> Iterator[Tuple[str, object]]:
    """(tag, figure) of the slice grid (``images``) and the label MIPs
    (``labels``), each titled with the epoch and batch, one at a time."""
    inputs = arrays["inputs"]
    fig, _ = vis_logimages(inputs)
    fig.suptitle(f"epoch {epoch} batch {batch_id}")
    yield "images", fig
    fig, _ = vis_loglabels(arrays["label"], arrays["pred"], inputs=inputs[0],
                           projection_type=projection_type)
    fig.suptitle(f"epoch {epoch} batch {batch_id}")
    yield "labels", fig


def render_landmark_sample(arrays: Dict[str, np.ndarray], epoch: int, batch_id: int,
                           projection_type: str = "mean") -> Iterator[Tuple[str, object]]:
    """``render_seg_sample``'s figures, then the heatmap MIPs
    (``heatmaps``)."""
    yield from render_seg_sample(arrays, epoch, batch_id, projection_type)
    fig, _ = vis_logheatmaps(arrays["inputs"][0], arrays["out_heatmaps"],
                             arrays["gt_heatmaps"], projection_type=projection_type)
    fig.suptitle(f"epoch {epoch} batch {batch_id}")
    yield "heatmaps", fig


def _matplotlib_missing() -> bool:
    """True (after one warning a process) where matplotlib does not import."""
    global _WARNED
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        if not _WARNED:
            logger.warning("matplotlib is not installed: the MIP sample visualizer "
                           "(--log_vis_mip) is off and no figures are logged; "
                           "training is unchanged")
            _WARNED = True
        return True
    return False


def _hook(compute, render, projection_type: str):
    def visualize(trainer, batch, epoch: int, batch_id: int) -> None:
        if trainer.metrics is None:
            return
        arrays = compute(trainer, batch)
        step = int(trainer.state.step)
        plt = _pyplot()
        for tag, fig in render(arrays, epoch, batch_id, projection_type):
            trainer.metrics.log_figure(tag, fig, step)
            plt.close(fig)

    return visualize


def make_seg_sample_visualizer(projection_type: str = "mean"):
    """The val-batch hook logging images and label MIPs (reference
    segmentation.py:67-92 ``log_samples``), or None without matplotlib."""
    if _matplotlib_missing():
        return None
    return _hook(seg_sample_arrays, render_seg_sample, projection_type)


def make_landmark_sample_visualizer(num_heatmaps: int, projection_type: str = "mean"):
    """The val-batch hook logging images, label MIPs and heatmap MIPs
    (reference landmarks.py:85-123 ``log_samples``), or None without
    matplotlib."""
    if _matplotlib_missing():
        return None
    return _hook(lambda trainer, batch: landmark_sample_arrays(trainer, batch, num_heatmaps),
                 render_landmark_sample, projection_type)
