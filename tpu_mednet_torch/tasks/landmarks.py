"""Landmark task: Gaussian-heatmap regression with an auxiliary segmentation head.

Counterpart of ``tpu_mednet/tasks/landmarks.py:29-138`` (reference
``LandmarkNet``, landmarks.py:22-206): one U-Net emits ``num_heatmaps +
num_classes`` channels; the first ``num_heatmaps`` regress the landmark
heatmaps and the rest are class logits (landmarks.py:74-75, 144-145).
``num_heatmaps`` is the length of ``loss_regression_weight``
(landmarks.py:57).

Outputs are (N, C, X, Y, Z) logits; the label batch holds the heatmap
channels first and the class map last, (N, L + 1, X, Y, Z)
(dataset.py:322-330).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from tpu_mednet_torch._device import DeviceLike
from tpu_mednet_torch.config import parse_remat
from tpu_mednet_torch.models.unet import ResidualUNet3D, UNet3DBase
from tpu_mednet_torch.ops import losses as L
from tpu_mednet_torch.ops.heatmap import heatmap_argmax_coords


def _peaks(heatmaps: torch.Tensor, dp) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, L, 3) peak coordinates and (N, L) peak values of (N, L, X, Y, Z)
    heatmaps; on a space axis, of the data row's whole volumes, the first
    maximum in x, y, z order as on one (slabs lie in X order)."""
    coords = heatmap_argmax_coords(heatmaps)
    peak = heatmaps.amax(dim=tuple(range(2, heatmaps.dim())))
    if dp is None or not dp.spatial:
        return coords, peak
    import torch.distributed as dist

    def gather(t):
        t = t.to(dp.collective_device()).contiguous()
        parts = [torch.empty_like(t) for _ in range(dp.n_space)]
        dist.all_gather(parts, t, group=dp.space_group)
        return torch.stack(parts).cpu()

    lengths = gather(torch.tensor([heatmaps.shape[2]]))[:, 0]
    offset = int(lengths[:dp.space_index].sum())
    coords = coords.cpu() + torch.tensor([offset, 0, 0])
    peaks = gather(peak.detach().float().cpu())                   # (S, N, L)
    best = (peaks == peaks.amax(0)).float().argmax(0)             # the first slab at the max
    coords = gather(coords).gather(0, best[None, ..., None].expand(1, *coords.shape))[0]
    return coords.to(heatmaps.device), peaks.amax(0).to(heatmaps.device)


def landmark_coordinate_error(pred_heatmaps: torch.Tensor, true_heatmaps: torch.Tensor,
                              dp=None) -> torch.Tensor:
    """Mean Euclidean distance (voxels) between predicted and true heatmap
    peaks over (N, L, X, Y, Z) stacks; a landmark whose true heatmap is all
    zero in the patch (outside the crop) is left out of the mean.  With
    ``dp``, over the global batch (on a space axis, the peaks of whole
    volumes, counted once a data row)."""
    pred, _ = _peaks(pred_heatmaps, dp)
    true, true_peak = _peaks(true_heatmaps, dp)
    dist = ((pred.float() - true.float()) ** 2).sum(dim=-1).sqrt()  # (N, L)
    present = true_peak > 0
    total, count = (dist * present).sum(), present.sum().float()
    if dp is not None:
        if dp.spatial and dp.space_index:
            total, count = total * 0, count * 0  # the row's first rank counts it
        total, count = dp.all_sum(torch.stack([total, count]))
    return total / count.clamp_min(1.0)


@dataclasses.dataclass(eq=False)
class LandmarkTask:
    """Joint heatmap regression and segmentation."""

    model: UNet3DBase
    loss_regression_weight: Sequence[float]
    loss_class: str = "DICE"  # 'DICE' | 'CE'
    loss_class_weight: Optional[Sequence[float]] = None
    loss_regression: str = "L2"  # 'L2' | 'L1'

    def __post_init__(self):
        self._weights = L.HeldWeights(
            regression=(self.loss_regression_weight, len(self.loss_regression_weight)),
            cls=(self.loss_class_weight, self.num_classes))

    @classmethod
    def from_hparams(cls, hparams, device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None) -> "LandmarkTask":
        """Build from a train_ldmks-style hparams namespace (``remat`` as
        for segmentation; ``packed`` is ignored)."""
        model = ResidualUNet3D(
            in_channels=hparams.in_channels,
            out_channels=hparams.out_channels,
            final_sigmoid=False,
            f_maps=hparams.fmaps,
            dtype=torch.bfloat16 if getattr(hparams, "bf16", True) else torch.float32,
            device=device,
            generator=generator,
            remat=parse_remat(getattr(hparams, "remat", False)),
        )
        return cls(model=model,
                   loss_regression_weight=list(hparams.loss_regression_weight),
                   loss_class=getattr(hparams, "loss_class", "DICE"),
                   loss_class_weight=getattr(hparams, "loss_class_weight", None),
                   loss_regression=getattr(hparams, "loss_regression", "L2"))

    @property
    def num_heatmaps(self) -> int:
        return len(self.loss_regression_weight)

    @property
    def out_channels(self) -> int:
        return self.model.config.out_channels

    @property
    def num_classes(self) -> int:
        return self.out_channels - self.num_heatmaps

    def split_outputs(self, outputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(heatmap channels, class logits), landmarks.py:74-75."""
        h = self.num_heatmaps
        return outputs[:, :h], outputs[:, h:]

    def split_labels(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(fp32 heatmaps, int64 class map), landmarks.py:68-70."""
        label = batch["label"]
        return label[:, :-1].float(), label[:, -1].long()

    def loss_fn(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor], dp=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss over the batch, or with ``dp`` over the global batch
        whose rows ``batch`` holds (``ops/losses.py``).  The weights are
        held on the outputs' device from the first call on
        (``HeldWeights``), where a wrong-length class weight raises."""
        heatmaps, labels = self.split_labels(batch)
        out_heatmaps, out_labels = self.split_outputs(outputs)
        w = self._weights.on(outputs.device)
        total, cls, reg = L.multitask_landmark_loss(
            out_labels, out_heatmaps, labels, heatmaps,
            regression_weights=w["regression"], class_loss=self.loss_class,
            class_weight=w["cls"], regression_loss=self.loss_regression, dp=dp)
        return total, {"class_loss": cls, "regression_loss": reg}

    def val_metrics(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor], dp=None
                    ) -> Dict[str, torch.Tensor]:
        heatmaps, labels = self.split_labels(batch)
        out_heatmaps, out_labels = self.split_outputs(outputs)
        total, aux = self.loss_fn(outputs, batch, dp=dp)
        per_channel = L.dice_metric(out_labels, labels, dp=dp)
        metrics = {
            "val_loss": total,
            "val_class_loss": aux["class_loss"],
            "val_regression_loss": aux["regression_loss"],
            "val_landmark_error": landmark_coordinate_error(out_heatmaps, heatmaps, dp=dp),
        }
        for c in range(self.num_classes):
            metrics[f"val_dice{c}"] = per_channel[c]
        return metrics

    def predict_postprocess(self, logits: torch.Tensor) -> torch.Tensor:
        """(N, C, X, Y, Z) logits -> (N, L + 1, X, Y, Z) uint8: heatmaps
        clipped to [0, 255], then the class map (argmax of the softmax)
        last (reference predict.py:88-94)."""
        out_heatmaps, out_labels = self.split_outputs(logits)
        pred = torch.argmax(torch.softmax(out_labels, dim=1), dim=1, keepdim=True)
        hm = out_heatmaps.clamp(0.0, 255.0).to(torch.uint8)
        return torch.cat([hm, pred.to(torch.uint8)], dim=1)
