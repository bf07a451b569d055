"""Segmentation task: the residual 3D U-Net and its predict postprocess.

Counterpart of ``tpu_mednet/tasks/segmentation.py`` for inference: the
task bundles the model; ``predict_postprocess`` is softmax -> argmax ->
uint8 with a singleton channel (segmentation.py:93-96).  Losses, labels
and validation metrics wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_mednet_torch._device import DeviceLike
from tpu_mednet_torch.models.unet import ResidualUNet3D, UNet3DBase


@dataclasses.dataclass(eq=False)
class SegmentationTask:
    """Bundles the model for volumetric multi-class segmentation."""

    model: UNet3DBase

    @classmethod
    def from_hparams(cls, hparams, device: DeviceLike = None,
                     generator: Optional[torch.Generator] = None
                     ) -> "SegmentationTask":
        """Build from a train_seg-style hparams namespace
        (in_channels/out_channels/fmaps/bf16).  ``packed`` and ``remat``
        change neither parameters nor results, so inference ignores them."""
        model = ResidualUNet3D(
            in_channels=hparams.in_channels,
            out_channels=hparams.out_channels,
            final_sigmoid=False,
            f_maps=hparams.fmaps,
            dtype=torch.bfloat16 if getattr(hparams, "bf16", True) else torch.float32,
            device=device,
            generator=generator,
        )
        return cls(model=model)

    @property
    def out_channels(self) -> int:
        return self.model.config.out_channels

    def predict_postprocess(self, logits: torch.Tensor) -> torch.Tensor:
        """(N, C, X, Y, Z) logits -> (N, 1, X, Y, Z) uint8 class map."""
        pred = torch.argmax(torch.softmax(logits, dim=1), dim=1, keepdim=True)
        return pred.to(torch.uint8)
