"""Models of the port: the residual 3D U-Net and its blocks."""

from tpu_mednet_torch.models.unet import (
    ResidualUNet3D,
    UNet3DBase,
    UNetConfig,
    create_feature_maps,
)

__all__ = ["ResidualUNet3D", "UNet3DBase", "UNetConfig", "create_feature_maps"]
