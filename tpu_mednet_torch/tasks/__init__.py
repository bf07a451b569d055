"""Tasks of the port: segmentation, and landmark heatmap regression with an
auxiliary segmentation head."""

from tpu_mednet_torch.tasks.landmarks import LandmarkTask
from tpu_mednet_torch.tasks.segmentation import SegmentationTask

__all__ = ["LandmarkTask", "SegmentationTask"]
