"""ResidualUNet3D in plain PyTorch, float32, channels-first (N, C, X, Y, Z).

The published network (pytorch-3dunet's ResidualUNet3D, Wolny et al.,
eLife 2020, as torch-mednet's ``unet/model.py`` builds it): ``num_levels``
encoder stages of ``ExtResNetBlock`` (conv1 -> GroupNorm -> ELU is the
residual; conv2 -> GroupNorm -> ELU; conv3 -> GroupNorm, + residual, ELU),
2x max pooling before every stage but the first; decoder stages join by a
stride-2 transposed convolution (k 3, padding 1, output padding 1) summed
with the encoder feature, then the same block; a 1x1x1 head.  Convolutions
in the blocks carry no bias (a norm follows them); GroupNorm takes
``min(num_groups, C)`` groups as the reference clamps them.

Parameters live in a flat dict keyed by the published state-dict names,
so the benchmark loads the same tensors into the program's model and
here.  ``quant`` (identity by default) is applied to each convolution's
input and weight: the precision controls pass a rounding to a lower
precision there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Spec = Tuple[str, Tuple[int, ...], str]
EPS = 1e-5


def feature_maps(cfg: dict) -> List[int]:
    return [int(cfg["f_maps"]) * 2 ** i for i in range(int(cfg["num_levels"]))]


def groups(channels: int, num_groups: int) -> int:
    return 1 if channels < num_groups else num_groups


def _block_specs(prefix: str, c_in: int, c_out: int) -> List[Spec]:
    out = []
    for i, ci in enumerate((c_in, c_out, c_out), start=1):
        out.append((f"{prefix}.conv{i}.conv.weight", (c_out, ci, 3, 3, 3), "conv"))
        out.append((f"{prefix}.conv{i}.groupnorm.weight", (c_out,), "gn_weight"))
        out.append((f"{prefix}.conv{i}.groupnorm.bias", (c_out,), "gn_bias"))
    return out


def param_specs(cfg: dict) -> List[Spec]:
    """(name, shape, kind) of every parameter, in a fixed order."""
    f = feature_maps(cfg)
    specs: List[Spec] = []
    c_prev = int(cfg["in_channels"])
    for i, c in enumerate(f):
        specs += _block_specs(f"encoders.{i}.basic_module", c_prev, c)
        c_prev = c
    for j, level in enumerate(reversed(range(len(f) - 1))):
        c_deep, c = f[level + 1], f[level]
        specs.append((f"decoders.{j}.upsample.weight", (c_deep, c, 3, 3, 3), "conv"))
        specs.append((f"decoders.{j}.upsample.bias", (c,), "conv_bias"))
        specs += _block_specs(f"decoders.{j}.basic_module", c, c)
    n_out = int(cfg["out_channels"])
    specs.append(("final_conv.weight", (n_out, f[0], 1, 1, 1), "conv"))
    specs.append(("final_conv.bias", (n_out,), "conv_bias"))
    return specs


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_specs(cfg))


def init_from_uniform(cfg: dict, u: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split one flat U[0, 1) draw of ``param_count`` floats into the
    parameters: a convolution's weight and bias U(-b, b) with b =
    1/sqrt(dim 1 x kernel volume) (torch's default bound); GroupNorm's
    weight 1 + 0.1 U(-1, 1) and bias 0.1 U(-1, 1)."""
    params, at = {}, 0
    bounds = {}
    for name, shape, kind in param_specs(cfg):
        n = math.prod(shape)
        s = 2.0 * u[at:at + n].view(shape) - 1.0
        at += n
        if kind == "conv":
            b = 1.0 / math.sqrt(shape[1] * math.prod(shape[2:]))
            bounds[name.rsplit(".", 1)[0]] = b
            params[name] = s * b
        elif kind == "conv_bias":
            params[name] = s * bounds[name.rsplit(".", 1)[0]]
        elif kind == "gn_weight":
            params[name] = 1.0 + 0.1 * s
        else:
            params[name] = 0.1 * s
    if at != u.numel():
        raise ValueError(f"draw of {u.numel()} floats for {at} parameters")
    return params


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _conv_layer(p, prefix, x, num_groups, q, residual=None):
    w = p[f"{prefix}.conv.weight"]
    y = F.conv3d(q(x), q(w), padding=1)
    y = F.group_norm(y, groups(w.shape[0], num_groups), p[f"{prefix}.groupnorm.weight"],
                     p[f"{prefix}.groupnorm.bias"], EPS)
    if residual is not None:
        y = y + residual
    return F.elu(y)


def _block(p, prefix, x, num_groups, q):
    r = _conv_layer(p, f"{prefix}.conv1", x, num_groups, q)
    o = _conv_layer(p, f"{prefix}.conv2", r, num_groups, q)
    return _conv_layer(p, f"{prefix}.conv3", o, num_groups, q, residual=r)


def forward(cfg: dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """fp32 logits (N, out_channels, X, Y, Z) of fp32 input (N, C, X, Y, Z)."""
    q = quant or _identity
    ng = int(cfg["num_groups"])
    n_levels = int(cfg["num_levels"])
    feats = []
    for i in range(n_levels):
        if i:
            x = F.max_pool3d(x, 2, 2)
        x = _block(p, f"encoders.{i}.basic_module", x, ng, q)
        feats.append(x)
    for j, skip in enumerate(feats[-2::-1]):
        w, b = p[f"decoders.{j}.upsample.weight"], p[f"decoders.{j}.upsample.bias"]
        x = F.conv_transpose3d(q(x), q(w), b, stride=2, padding=1, output_padding=1) + skip
        x = _block(p, f"decoders.{j}.basic_module", x, ng, q)
    return F.conv3d(q(x), q(p["final_conv.weight"]), p["final_conv.bias"])
