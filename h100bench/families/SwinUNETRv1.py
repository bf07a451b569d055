"""Swin UNETR v1, the family of the BTCV training cell.

Hatamizadeh et al. 2022, "Swin UNETR" (arXiv:2201.01266), as MONAI builds
it (``monai.networks.nets.SwinUNETR`` with ``use_v2=False``, hence the
name: MONAI ships Swin UNETR-V2 beside it): a shifted-window transformer
encoder of four stages at head dim 16, hidden states under an affine-free
LayerNorm, UNETR's residual conv blocks with InstanceNorm and LeakyReLU
0.01, transposed-conv up blocks and a 1x1x1 head; trained on BTCV with
Dice + CE and AdamW.  The port builds it as
``tpu_mednet_torch.models.SwinUNETR`` under ``SegmentationTask``; its plain
reference is ``reference/swin_unetr.py``.  Its own kernel groups are the
fused attention (``attn``) and the Linear layers' GEMMs (``linear``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from h100bench import counting, harness
from h100bench.reference import swin_unetr
from h100bench.reference import train as ref_train

IMPLEMENTED = {
    "use_v2": (False,),
    "task": ("segmentation",),
    "loss": ("DICE_CE",),
    "optimizer": ("adamw",),
    "norm": ("instance",),
    "merge_order": ("zyx",),
    "mlp_ratio": (4,),
}

# name parts of the family's own kernels (none names a conv kernel: the
# tests hold them to the residual cells' kernel names): the fused SDPA
# kernels (memory-efficient, as the H100 runs them: fmha_cutlassF and
# fmha_cutlassB, PyTorchMemEffAttention; flash), and cuBLAS's GEMMs of the
# Linear layers (nvjet_*, cutlass_80_tensorop_*gemm*, *_cublas; cuDNN runs
# every convolution under names of its own)
KERNEL_GROUPS: Dict[str, str] = {
    "fmha": "attn",
    "attention": "attn",
    "flash": "attn",
    "nvjet": "linear",
    "_tensorop_": "linear",
    "cublas": "linear",
}

param_count = swin_unetr.param_count
init_from_uniform = swin_unetr.init_from_uniform
forward = swin_unetr.forward


def check(cfg: dict, where: str) -> None:
    harness.check_keys(cfg, where, IMPLEMENTED, (), "SwinUNETRv1")


def _dtype(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def port_task(cfg: dict, params: Dict[str, torch.Tensor], device):
    """The program's task with its model holding ``params``."""
    from tpu_mednet_torch.models import SwinUNETR, SwinUNETRConfig
    from tpu_mednet_torch.tasks import SegmentationTask

    config = SwinUNETRConfig(
        in_channels=int(cfg["in_channels"]), out_channels=int(cfg["out_channels"]),
        feature_size=int(cfg["feature_size"]), depths=tuple(cfg["depths"]),
        num_heads=tuple(cfg["num_heads"]), window_size=int(cfg["window_size"]),
        patch_size=int(cfg["patch_size"]), dtype=_dtype(cfg))
    model = SwinUNETR(config, device=device)
    model.load_state_dict(params, strict=True)
    return SegmentationTask(model=model, loss=cfg["loss"], loss_weight=cfg.get("loss_weight"))


def optimizer(cfg: dict) -> dict:
    """The port's optimizer (``OptimizerConfig``'s fields): AdamW."""
    return {"name": "adamw", "learning_rate": float(cfg["learning_rate"]),
            "weight_decay": float(cfg["weight_decay"])}


class DiceCELoss(ref_train.Loss):
    """Dice (``reference.train.Loss``'s) plus the mean cross-entropy of the
    voxels (class-weighted as torch's, where the configuration weights the
    classes): the CE term's batch sums are its summed negative
    log-likelihood ``ce`` and its weight ``n``."""

    def terms(self, logits, label) -> dict:
        t = super().terms(logits, label)
        classes = label[:, -1].long()
        picked = torch.log_softmax(logits, dim=1).gather(1, classes[:, None])[:, 0]
        w = self._w(logits.shape[1], logits.device)[classes]
        t["ce"] = -(w * picked).sum()
        t["n"] = w.sum()
        return t

    def value(self, t: dict) -> torch.Tensor:
        return super().value(t) + t["ce"] / t["n"]

    def linearised(self, t: dict, total: dict) -> torch.Tensor:
        return super().linearised(t, total) + t["ce"] / total["n"]


def reference_loss(cfg: dict) -> ref_train.Loss:
    return DiceCELoss(cfg)


def reference_update(cfg: dict, params, grads, m, v, step: int) -> None:
    ref_train.adam_(params, grads, m, v, step, float(cfg["learning_rate"]),
                    weight_decay=float(cfg["weight_decay"]))


def _vox(spatial: Sequence[int]) -> int:
    n = 1
    for s in spatial:
        n *= int(s)
    return n


def _stages(cfg: dict, patch: Sequence[int]):
    """Per stage: (width, depth, heads, tokens, window tokens n, windows)."""
    fs, w, pt = int(cfg["feature_size"]), int(cfg["window_size"]), int(cfg["patch_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        ext = [p // pt // 2 ** i for p in patch]
        ws = [e if e <= w else w for e in ext]
        windows = 1
        for e, s in zip(ext, ws):
            windows *= -(-e // s)
        out.append((fs * 2 ** i, int(depth), int(heads), _vox(ext), _vox(ws), windows))
    return out


def _terms(cfg: dict, patch: Sequence[int]) -> Dict[str, float]:
    """Logical FLOPs of one sample's forward by kind (a copy of
    ``tpu_mednet_torch/utils/flops.py``'s ``swin_unetr_forward_terms``,
    which the tests hold it to): ``conv``, ``linear`` (2 x tokens x C_in x
    C_out, the stage's own tokens), ``attention`` (4 n^2 d a window and
    head, over the padded grid's windows)."""
    fs, c_in, pt = int(cfg["feature_size"]), int(cfg["in_channels"]), int(cfg["patch_size"])
    ratio = int(cfg["mlp_ratio"])
    conv = counting.conv([p // pt for p in patch], 1, c_in * pt ** 3, fs)
    linear = attention = 0.0
    for c, depth, heads, tokens, n, windows in _stages(cfg, patch):
        linear += depth * 2.0 * tokens * (4 + 2 * ratio) * c * c
        linear += 2.0 * (tokens // 8) * 8 * c * 2 * c
        attention += depth * 4.0 * n * n * (c // heads) * windows * heads

    def at(level):
        return [p // 2 ** level for p in patch]

    def res(spatial, ci, co):
        f = counting.conv(spatial, 3, ci, co) + counting.conv(spatial, 3, co, co)
        return f + (counting.conv(spatial, 1, ci, co) if ci != co else 0.0)

    conv += res(at(0), c_in, fs) + res(at(1), fs, fs) + res(at(2), 2 * fs, 2 * fs)
    conv += res(at(3), 4 * fs, 4 * fs) + res(at(5), 16 * fs, 16 * fs)
    for level, ci, co in ((4, 16 * fs, 8 * fs), (3, 8 * fs, 4 * fs), (2, 4 * fs, 2 * fs),
                          (1, 2 * fs, fs), (0, fs, fs)):
        conv += counting.conv(at(level + 1), 2, ci, co) + res(at(level), 2 * co, co)
    conv += counting.conv(patch, 1, fs, int(cfg["out_channels"]))
    return {"conv": conv, "linear": linear, "attention": attention}


def forward_flops(cfg: dict, patch: Sequence[int]) -> float:
    """Every convolution's, Linear layer's and attention product's logical
    FLOPs of one sample's forward (MFU's numerator)."""
    return float(sum(_terms(cfg, patch).values()))


def conv_flops(cfg: dict, patch: Sequence[int]) -> float:
    return _terms(cfg, patch)["conv"]


def norm_layers(cfg: dict, patch: Sequence[int]) -> List[counting.NormLayer]:
    """(channels, voxels a sample, adds the residual) of every InstanceNorm
    (K1 at one channel a group): a residual block's norm1, its norm3 where
    the width changes, and norm2 with the residual."""
    fs, c_in = int(cfg["feature_size"]), int(cfg["in_channels"])

    def res(level, ci, co):
        vox = _vox([p // 2 ** level for p in patch])
        out = [(co, vox, False), (co, vox, True)]
        return out + ([(co, vox, False)] if ci != co else [])

    out = res(0, c_in, fs) + res(1, fs, fs) + res(2, 2 * fs, 2 * fs)
    out += res(3, 4 * fs, 4 * fs) + res(5, 16 * fs, 16 * fs)
    for level, co in ((4, 8 * fs), (3, 4 * fs), (2, 2 * fs), (1, fs), (0, fs)):
        out += res(level, 2 * co, co)
    return out


def group_work(cfg: dict, patch: Sequence[int], train: bool) -> Dict[str, dict]:
    """A sample's work in the family's groups.

    - ``attn``: the forward's 4 n^2 d a window and head (a train step: 3 x,
      the backward's four products against the forward's two); ``bytes``,
      the least the fused kernels move for each sample, in the compute
      dtype over the padded tokens: q, k, v read and o written, and the
      backward's q, k, v, o and dO read and dq, dk, dv written;
      ``step_bytes``, what they read once a block and pass whatever the
      batch: the bias (heads x n^2) and, in a shifted block, the mask
      (windows x n^2).  ``counting.scaled`` multiplies it by the samples as
      it does the rest, so its reader divides it by the batch.
    - ``linear``: qkv, proj, the MLP's two layers and the merging,
      2 x tokens x C_in x C_out (a train step: 3 x).
    """
    e = {"bfloat16": 2, "float32": 4}[cfg["dtype"]]
    terms = _terms(cfg, patch)
    passes = 2 if train else 1
    act_bytes = step_bytes = 0.0
    for c, depth, heads, tokens, n, windows in _stages(cfg, patch):
        act_bytes += depth * n * windows * c * e * (4 + (8 if train else 0))
        for j in range(depth):
            shifted = j % 2 == 1 and windows > 1
            step_bytes += passes * (heads + (windows if shifted else 0)) * n * n * e
    return {"attn": {"flops": (3.0 if train else 1.0) * terms["attention"],
                     "bytes": act_bytes, "step_bytes": step_bytes},
            "linear": {"flops": (3.0 if train else 1.0) * terms["linear"]}}
