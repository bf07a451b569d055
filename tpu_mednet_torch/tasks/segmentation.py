"""Segmentation task: the residual 3D U-Net, Dice/CE loss and dice metrics.

Counterpart of ``tpu_mednet/tasks/segmentation.py`` (reference
``midasmednet/segmentation.py:22-131``): a small task object bundles the
model with the loss and metric functions the train and eval steps call.

- the class-value map is the LAST label channel (segmentation.py:60,96);
- the loss is ``dice_loss(weight)`` for 'DICE' or cross-entropy for 'CE'
  (segmentation.py:43-49, without the reference's double softmax);
- validation reports ``val_loss`` and per-channel ``val_dice{c}``
  (segmentation.py:104-117);
- ``predict_postprocess`` is softmax -> argmax -> uint8 with a singleton
  channel (segmentation.py:93-96).

Outputs are (N, C, X, Y, Z) logits; batches hold ``data`` (N, C, X, Y, Z)
and ``label`` (N, Cl, X, Y, Z).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from tpu_mednet_torch._device import DeviceLike
from tpu_mednet_torch.models.unet import ResidualUNet3D, UNet3DBase
from tpu_mednet_torch.ops import losses as L


@dataclasses.dataclass(eq=False)
class SegmentationTask:
    """Bundles the model and the loss for volumetric multi-class segmentation."""

    model: UNet3DBase
    loss: str = "DICE"  # 'DICE' | 'CE'
    loss_weight: Optional[Sequence[float]] = None

    @classmethod
    def from_hparams(cls, hparams, device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None
                     ) -> "SegmentationTask":
        """Build from a train_seg-style hparams namespace (in_channels/
        out_channels/fmaps/bf16/loss/loss_weight).  ``packed`` and ``remat``
        change neither parameters nor results, so they are ignored."""
        model = ResidualUNet3D(
            in_channels=hparams.in_channels,
            out_channels=hparams.out_channels,
            final_sigmoid=False,
            f_maps=hparams.fmaps,
            dtype=torch.bfloat16 if getattr(hparams, "bf16", True) else torch.float32,
            device=device,
            generator=generator,
        )
        return cls(model=model, loss=getattr(hparams, "loss", "DICE"),
                   loss_weight=getattr(hparams, "loss_weight", None))

    @property
    def out_channels(self) -> int:
        return self.model.config.out_channels

    def labels_from_batch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Class map = last label channel (segmentation.py:60), int64."""
        return batch["label"][:, -1].long()

    def loss_fn(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        labels = self.labels_from_batch(batch)
        if self.loss == "DICE":
            loss = L.dice_loss(outputs, labels, weight=self.loss_weight)
        elif self.loss == "CE":
            loss = L.ce_loss(outputs, labels, weight=self.loss_weight)
        else:
            raise ValueError(f"loss must be 'DICE' or 'CE', got {self.loss!r}")
        return loss, {}

    def val_metrics(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        loss, _ = self.loss_fn(outputs, batch)
        per_channel = L.dice_metric(outputs, self.labels_from_batch(batch))
        metrics = {"val_loss": loss}
        for c in range(self.out_channels):
            metrics[f"val_dice{c}"] = per_channel[c]
        return metrics

    def predict_postprocess(self, logits: torch.Tensor) -> torch.Tensor:
        """(N, C, X, Y, Z) logits -> (N, 1, X, Y, Z) uint8 class map."""
        pred = torch.argmax(torch.softmax(logits, dim=1), dim=1, keepdim=True)
        return pred.to(torch.uint8)
