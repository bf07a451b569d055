"""Models of the port: the 3D U-Net family (residual and UNet3D) and its
blocks, and Swin UNETR."""

from tpu_mednet_torch.models.blocks import DoubleConv, FinalConv
from tpu_mednet_torch.models.swin_unetr import SwinUNETR, SwinUNETRConfig
from tpu_mednet_torch.models.unet import (
    ResidualUNet3D,
    UNet3D,
    UNet3DBase,
    UNetConfig,
    create_feature_maps,
)

__all__ = ["DoubleConv", "FinalConv", "ResidualUNet3D", "SwinUNETR", "SwinUNETRConfig", "UNet3D",
           "UNet3DBase", "UNetConfig", "create_feature_maps"]
