"""Inference of the port: the ``crop``, ``device`` and ``gaussian``
sliding-window stitches, with mirror TTA, and whole-volume inference split
over the space axis (``spatial``)."""

from tpu_mednet_torch.inference.common import normalize_tta
from tpu_mednet_torch.inference.device_sliding import predict_volumes_on_device
from tpu_mednet_torch.inference.sliding_window import predict_volumes
from tpu_mednet_torch.inference.spatial import predict_volume_spatial, receptive_halo
from tpu_mednet_torch.inference.weighted import (gaussian_window, predict_volumes_weighted,
                                                 predict_volumes_weighted_on_device)

__all__ = ["gaussian_window", "normalize_tta", "predict_volumes", "predict_volumes_on_device",
           "predict_volume_spatial", "predict_volumes_weighted",
           "predict_volumes_weighted_on_device", "receptive_halo"]
