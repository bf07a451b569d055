"""Tasks of the port: segmentation."""

from tpu_mednet_torch.tasks.segmentation import SegmentationTask

__all__ = ["SegmentationTask"]
