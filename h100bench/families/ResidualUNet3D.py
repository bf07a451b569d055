"""ResidualUNet3D, the family of the segmentation and landmark cells.

torch-mednet's ``unet/model.py`` (after pytorch-3dunet, Wolny et al., eLife
2020): ``num_levels`` stages of three 3^3 convolutions with cge GroupNorm
and ELU, joined by a stride-2 transposed convolution summed with the
encoder feature, and a 1x1x1 head.  The port builds it as
``tpu_mednet_torch.models.ResidualUNet3D`` under ``SegmentationTask`` or
``LandmarkTask``; its plain reference is ``reference/unet.py``.  The
harness finds this module by the configuration's ``model``
(``harness.family_of`` lists what a family gives).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from h100bench import counting, harness
from h100bench.reference import train as ref_train
from h100bench.reference import unet

# the values of the configuration's keys that this module implements; a
# key of one task only is checked where the configuration has it
IMPLEMENTED = {
    "join": ("transposed_conv_sum",),
    "layer_order": ("cge",),
    "optimizer": ("adam",),
    "task": ("segmentation", "landmarks"),
    "loss": ("DICE",),
    "loss_class": ("DICE",),
    "loss_regression": ("L2",),
}
OPTIONAL = ("loss", "loss_class", "loss_regression")

# no kernel of its own beyond the shared groups (conv, K1, K2)
KERNEL_GROUPS: Dict[str, str] = {}

param_count = unet.param_count
init_from_uniform = unet.init_from_uniform
forward = unet.forward


def check(cfg: dict, where: str) -> None:
    harness.check_keys(cfg, where, IMPLEMENTED, OPTIONAL, "ResidualUNet3D")


def _dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[cfg["dtype"]]


def port_task(cfg: dict, params: Dict[str, torch.Tensor], device):
    """The program's task with its model holding ``params``."""
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask

    model = ResidualUNet3D(int(cfg["in_channels"]), int(cfg["out_channels"]),
                           f_maps=int(cfg["f_maps"]), conv_layer_order=cfg["layer_order"],
                           num_groups=int(cfg["num_groups"]), dtype=_dtype(cfg),
                           num_levels=int(cfg["num_levels"]), device=device)
    model.load_state_dict(params, strict=True)
    if cfg["task"] == "landmarks":
        return LandmarkTask(model=model, loss_regression_weight=cfg["loss_regression_weight"],
                            loss_class=cfg["loss_class"],
                            loss_class_weight=cfg["loss_class_weight"],
                            loss_regression=cfg["loss_regression"])
    return SegmentationTask(model=model, loss=cfg["loss"], loss_weight=cfg.get("loss_weight"))


def optimizer(cfg: dict) -> dict:
    """The port's optimizer (``OptimizerConfig``'s fields): Adam."""
    return {"name": "adam", "learning_rate": float(cfg["learning_rate"])}


def reference_loss(cfg: dict) -> ref_train.Loss:
    return ref_train.Loss(cfg)


def reference_update(cfg: dict, params, grads, m, v, step: int) -> None:
    ref_train.adam_(params, grads, m, v, step, float(cfg["learning_rate"]))


def forward_flops(cfg: dict, patch: Sequence[int]) -> float:
    """Logical FLOPs of one sample's forward: every 3^3 convolution at its
    output extent, the stride-2 transposed convolution at its input extent,
    the 1x1x1 head (a copy of ``tpu_mednet_torch/utils/flops.py``'s
    arithmetic, which the tests hold it to)."""
    f = unet.feature_maps(cfg)
    total, c_prev = 0.0, int(cfg["in_channels"])
    for i, c in enumerate(f):
        spatial = [p // 2 ** i for p in patch]
        total += counting.conv(spatial, 3, c_prev, c) + 2 * counting.conv(spatial, 3, c, c)
        c_prev = c
    for lvl in range(len(f) - 2, -1, -1):
        spatial = [p // 2 ** lvl for p in patch]
        total += counting.conv([s // 2 for s in spatial], 3, f[lvl + 1], f[lvl])
        total += 3 * counting.conv(spatial, 3, f[lvl], f[lvl])
    return total + counting.conv(patch, 1, f[0], int(cfg["out_channels"]))


conv_flops = forward_flops  # every FLOP of the forward is a convolution's


def norm_layers(cfg: dict, patch: Sequence[int]) -> List[counting.NormLayer]:
    """(channels, voxels a sample, adds the residual) of every GroupNorm."""
    out = []
    f = unet.feature_maps(cfg)
    for i, c in enumerate(f):
        vox = 1
        for p in patch:
            vox *= p // 2 ** i
        out += [(c, vox, False), (c, vox, False), (c, vox, True)]
        if i < len(f) - 1:  # the decoder stage at this level
            out += [(c, vox, False), (c, vox, False), (c, vox, True)]
    return out


def group_work(cfg: dict, patch: Sequence[int], train: bool) -> Dict[str, dict]:
    """The work a sample gives each of ``KERNEL_GROUPS``' groups: none."""
    return {}
