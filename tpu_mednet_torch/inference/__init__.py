"""Sliding-window inference of the port."""

from tpu_mednet_torch.inference.device_sliding import predict_volumes_on_device

__all__ = ["predict_volumes_on_device"]
