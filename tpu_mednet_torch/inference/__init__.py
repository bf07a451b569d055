"""Sliding-window inference of the port: the ``crop``, ``device`` and
``gaussian`` stitches, with mirror TTA."""

from tpu_mednet_torch.inference.common import normalize_tta
from tpu_mednet_torch.inference.device_sliding import predict_volumes_on_device
from tpu_mednet_torch.inference.sliding_window import predict_volumes
from tpu_mednet_torch.inference.weighted import (gaussian_window, predict_volumes_weighted,
                                                 predict_volumes_weighted_on_device)

__all__ = ["gaussian_window", "normalize_tta", "predict_volumes", "predict_volumes_on_device",
           "predict_volumes_weighted", "predict_volumes_weighted_on_device"]
