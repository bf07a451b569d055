"""Which task a checkpoint was trained as.

The port's copy of ``detect_task_name`` (``tpu_mednet/inference/serving.py:31``);
serving export (``jax.export`` -> ``torch.export``) is not ported.
"""

from __future__ import annotations


def detect_task_name(hparams) -> str:
    """'LandmarkNet' or 'SegmentationNet', from a checkpoint's hparams.

    A landmark training run always carries ``loss_regression_weight`` in
    its hparams (it defines ``num_heatmaps``, reference landmarks.py:57);
    a segmentation run never does.
    """
    hp = hparams if isinstance(hparams, dict) else vars(hparams)
    return "LandmarkNet" if hp.get("loss_regression_weight") else "SegmentationNet"
