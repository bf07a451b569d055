"""A family kept for the tests of the seam: two convolutions under
``SegmentationTask``, trained with AdamW.

A 3^3 convolution (``f_maps`` channels, with bias) and ELU, then a 1x1x1
head, in the configuration's compute dtype.  The harness finds this
module as it finds ``families/<model>.py``, given this directory as its
family search path; nothing outside the tests names it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from h100bench import counting, harness
from h100bench.reference import train as ref_train

IMPLEMENTED = {"task": ("segmentation",), "loss": ("DICE",), "optimizer": ("adamw",)}
KERNEL_GROUPS: Dict[str, str] = {}


def check(cfg: dict, where: str) -> None:
    harness.check_keys(cfg, where, IMPLEMENTED, (), "TwoConvNet")


def _specs(cfg: dict):
    c_in, f, c_out = int(cfg["in_channels"]), int(cfg["f_maps"]), int(cfg["out_channels"])
    return [("conv1.weight", (f, c_in, 3, 3, 3)), ("conv1.bias", (f,)),
            ("conv2.weight", (c_out, f, 1, 1, 1)), ("conv2.bias", (c_out,))]


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape in _specs(cfg))


def init_from_uniform(cfg: dict, u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """torch's default bound, 1/sqrt(fan in), for each layer's weight and bias."""
    params, at = {}, 0
    for name, shape in _specs(cfg):
        n = math.prod(shape)
        fan_in = int(cfg["f_maps"]) if name.startswith("conv2") else 27 * int(cfg["in_channels"])
        params[name] = (2.0 * u[at:at + n].view(shape) - 1.0) / math.sqrt(fan_in)
        at += n
    return params


def forward(cfg: dict, p: Dict[str, torch.Tensor], x: torch.Tensor, quant=None) -> torch.Tensor:
    q = quant or (lambda t: t)
    h = F.elu(F.conv3d(q(x), q(p["conv1.weight"]), p["conv1.bias"], padding=1))
    return F.conv3d(q(h), q(p["conv2.weight"]), p["conv2.bias"])


class TwoConvNet(nn.Module):
    def __init__(self, cfg: dict, device):
        super().__init__()
        from tpu_mednet_torch.models.unet import UNetConfig

        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
        c_in, f, c_out = int(cfg["in_channels"]), int(cfg["f_maps"]), int(cfg["out_channels"])
        # what the program's step and serving entry read of a model
        self.config = UNetConfig(c_in, c_out, f_maps=(f,), num_levels=1, dtype=dtype)
        self.conv1 = nn.Conv3d(c_in, f, 3, padding=1, device=device)
        self.conv2 = nn.Conv3d(f, c_out, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = F.elu(F.conv3d(x, self.conv1.weight.to(dt), self.conv1.bias.to(dt), padding=1))
        return F.conv3d(h, self.conv2.weight.to(dt), self.conv2.bias.to(dt))


def port_task(cfg: dict, params: Dict[str, torch.Tensor], device):
    from tpu_mednet_torch.tasks import SegmentationTask

    model = TwoConvNet(cfg, device)
    model.load_state_dict(params, strict=True)
    return SegmentationTask(model=model, loss=cfg["loss"], loss_weight=cfg.get("loss_weight"))


def optimizer(cfg: dict) -> dict:
    return {"name": "adamw", "learning_rate": float(cfg["learning_rate"]),
            "weight_decay": float(cfg["weight_decay"])}


def reference_loss(cfg: dict) -> ref_train.Loss:
    return ref_train.Loss(cfg)


def reference_update(cfg: dict, params, grads, m, v, step: int) -> None:
    ref_train.adam_(params, grads, m, v, step, float(cfg["learning_rate"]),
                    weight_decay=float(cfg["weight_decay"]))


def forward_flops(cfg: dict, patch: Sequence[int]) -> float:
    f = int(cfg["f_maps"])
    return (counting.conv(patch, 3, int(cfg["in_channels"]), f)
            + counting.conv(patch, 1, f, int(cfg["out_channels"])))


conv_flops = forward_flops


def norm_layers(cfg: dict, patch: Sequence[int]) -> List[counting.NormLayer]:
    return []


def group_work(cfg: dict, patch: Sequence[int], train: bool) -> Dict[str, dict]:
    return {}
