"""Segmentation task: the residual 3D U-Net or Swin UNETR, Dice/CE loss and dice metrics.

Counterpart of ``tpu_mednet/tasks/segmentation.py`` (reference
``midasmednet/segmentation.py:22-131``): a small task object bundles the
model with the loss and metric functions the train and eval steps call.

- the class-value map is the LAST label channel (segmentation.py:60,96);
- the loss is ``dice_loss(weight)`` for 'DICE' or cross-entropy for 'CE'
  (segmentation.py:43-49, without the reference's double softmax), or
  their sum for 'DICE_CE' (MONAI's ``DiceCELoss`` at its default weights
  of 1 each, the Swin UNETR BTCV recipe's loss);
- ``from_hparams`` builds ``ResidualUNet3D``, or with ``arch``
  'SwinUNETR' ``models.SwinUNETR`` at ``feature_size`` (default 48);
- validation reports ``val_loss`` and per-channel ``val_dice{c}``
  (segmentation.py:104-117);
- ``predict_postprocess`` is softmax -> argmax -> uint8 with a singleton
  channel (segmentation.py:93-96).

Outputs are (N, C, X, Y, Z) logits; batches hold ``data`` (N, C, X, Y, Z)
and ``label`` (N, Cl, X, Y, Z).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from tpu_mednet_torch._device import DeviceLike
from tpu_mednet_torch.config import parse_remat
from tpu_mednet_torch.models.swin_unetr import SwinUNETR, SwinUNETRConfig
from tpu_mednet_torch.models.unet import ResidualUNet3D, UNet3DBase
from tpu_mednet_torch.ops import losses as L

ARCHS = ("ResidualUNet3D", "SwinUNETR")
LOSSES = ("DICE", "CE", "DICE_CE")


@dataclasses.dataclass(eq=False)
class SegmentationTask:
    """Bundles the model and the loss for volumetric multi-class segmentation."""

    model: Union[UNet3DBase, SwinUNETR]
    loss: str = "DICE"  # 'DICE' | 'CE' | 'DICE_CE'
    loss_weight: Optional[Sequence[float]] = None

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {self.loss!r}")
        self._weights = L.HeldWeights(cls=(self.loss_weight, self.out_channels))

    @classmethod
    def from_hparams(cls, hparams, device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None
                     ) -> "SegmentationTask":
        """Build from a train_seg-style hparams namespace (in_channels/
        out_channels/fmaps/bf16/remat/loss/loss_weight, and ``arch`` and
        ``feature_size`` where given).  ``packed`` changes neither
        parameters nor results and has no layout here, so it is ignored.
        Swin UNETR takes no ``remat``: it trains whole on one card."""
        arch = getattr(hparams, "arch", "ResidualUNet3D")
        dtype = torch.bfloat16 if getattr(hparams, "bf16", True) else torch.float32
        if arch not in ARCHS:
            raise ValueError(f"arch must be one of {ARCHS}, got {arch!r}")
        if arch == "SwinUNETR":
            if parse_remat(getattr(hparams, "remat", False)):
                raise ValueError("--remat is not implemented for SwinUNETR")
            if int(getattr(hparams, "spatial_shards", 1) or 1) > 1:
                raise ValueError("--spatial_shards is not implemented for SwinUNETR "
                                 "(its windows and merges have no halo exchange)")
            config = SwinUNETRConfig(in_channels=hparams.in_channels,
                                     out_channels=hparams.out_channels,
                                     feature_size=int(getattr(hparams, "feature_size", 48)),
                                     dtype=dtype)
            return cls(model=SwinUNETR(config, device=device, generator=generator),
                       loss=getattr(hparams, "loss", "DICE"),
                       loss_weight=getattr(hparams, "loss_weight", None))
        model = ResidualUNet3D(
            in_channels=hparams.in_channels,
            out_channels=hparams.out_channels,
            final_sigmoid=False,
            f_maps=hparams.fmaps,
            dtype=dtype,
            device=device,
            generator=generator,
            remat=parse_remat(getattr(hparams, "remat", False)),
        )
        return cls(model=model, loss=getattr(hparams, "loss", "DICE"),
                   loss_weight=getattr(hparams, "loss_weight", None))

    @property
    def out_channels(self) -> int:
        return self.model.config.out_channels

    def labels_from_batch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Class map = last label channel (segmentation.py:60), int64."""
        return batch["label"][:, -1].long()

    def loss_fn(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor], dp=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss over the batch, or with ``dp`` over the global batch
        whose rows ``batch`` holds (``ops/losses.py``).  The weight is held
        on the outputs' device from the first call on (``HeldWeights``),
        where a wrong-length weight raises."""
        labels = self.labels_from_batch(batch)
        weight = self._weights.on(outputs.device)["cls"]
        if self.loss == "DICE":
            loss = L.dice_loss(outputs, labels, weight=weight, dp=dp)
        elif self.loss == "CE":
            loss = L.ce_loss(outputs, labels, weight=weight, dp=dp)
        else:
            loss = (L.dice_loss(outputs, labels, weight=weight, dp=dp)
                    + L.ce_loss(outputs, labels, weight=weight, dp=dp))
        return loss, {}

    def val_metrics(self, outputs: torch.Tensor, batch: Dict[str, torch.Tensor], dp=None
                    ) -> Dict[str, torch.Tensor]:
        loss, _ = self.loss_fn(outputs, batch, dp=dp)
        per_channel = L.dice_metric(outputs, self.labels_from_batch(batch), dp=dp)
        metrics = {"val_loss": loss}
        for c in range(self.out_channels):
            metrics[f"val_dice{c}"] = per_channel[c]
        return metrics

    def predict_postprocess(self, logits: torch.Tensor) -> torch.Tensor:
        """(N, C, X, Y, Z) logits -> (N, 1, X, Y, Z) uint8 class map."""
        pred = torch.argmax(torch.softmax(logits, dim=1), dim=1, keepdim=True)
        return pred.to(torch.uint8)
