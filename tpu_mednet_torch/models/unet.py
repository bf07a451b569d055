"""Configurable 3D U-Net family as an ``nn.Module``.

Counterpart of ``tpu_mednet/models/unet.py:36-329``, both reference
networks (model.py:11-213):

- ``UNet3D``: 4 levels from 64 feature maps, ``DoubleConv`` blocks,
  nearest-resize + concatenation decoder (model.py:11-110);
- ``ResidualUNet3D``: 5 levels from 32 feature maps, ``ExtResNetBlock``s,
  transposed-conv + summation decoder (model.py:113-213);

each with a 1x1x1 head.  Input and output are logical (N, C, X, Y, Z)
tensors stored ``channels_last_3d``.

Dtype policy (as the JAX package): fp32 parameters, compute in the config's
dtype (bf16 by default), the head's logits cast to fp32.  Parameters start
from torch's layer defaults — the JAX package's ``'torch'`` init scheme
(blocks.py:82-137) — optionally drawn from an explicit ``torch.Generator``.

``remat`` recomputes the chosen stages' activations in the backward
(``torch.utils.checkpoint``), as JAX's ``nn.remat`` does; JAX keeps the
GroupNorm statistics across it, the port recomputes them with the stage.
A BatchNorm's running statistics move in the forward only: the recompute
runs under ``freeze_batch_stats``, as JAX's remat updates ``batch_stats``
once.  On a space axis (``models/blocks.py``'s ``space_axis``) the
recompute runs the stage's halo exchanges and GroupNorm sums again: every
rank recomputes the same stages in the same order, so the collectives
pair up.  Not ported: ``packed`` (a TPU layout with the same parameters
and math).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.models.blocks import (
    BLOCKS,
    BatchNorm,
    DecoderStage,
    EncoderStage,
    GroupNorm,
    _cast,
    _conv_weight,
    freeze_batch_stats,
)

CL3D = torch.channels_last_3d


def create_feature_maps(init_channels: int, num_levels: int) -> Tuple[int, ...]:
    """Geometric x2 progression of per-level feature maps (model.py:7-8)."""
    return tuple(init_channels * 2**k for k in range(num_levels))


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static configuration of a 3D U-Net.

    ``f_maps`` may be an int (expanded geometrically over ``num_levels``
    levels, model.py:44-46,148-150) or an explicit per-level tuple.

    ``remat`` recomputes stages in the backward instead of keeping their
    activations: False (none), True (every stage) or an int k, the k
    highest-resolution stages on each side (encoder stage i when i < k,
    the decoder stage whose output level is < k).  It changes neither the
    parameters nor the results.
    """

    in_channels: int
    out_channels: int
    f_maps: Union[int, Sequence[int]] = 32
    num_levels: int = 5
    block: str = "residual"
    layer_order: str = "cge"
    num_groups: int = 8
    final_sigmoid: bool = False
    skip_final_activation: bool = False
    pool_type: str = "max"
    dtype: torch.dtype = torch.bfloat16
    remat: Union[bool, int] = False

    @property
    def feature_maps(self) -> Tuple[int, ...]:
        if isinstance(self.f_maps, int):
            return create_feature_maps(self.f_maps, self.num_levels)
        return tuple(self.f_maps)

    @property
    def remat_levels(self) -> int:
        """Levels whose stages are recomputed: the highest-resolution k."""
        if self.remat is True:
            return len(self.feature_maps)
        return int(self.remat)


class UNet3DBase(nn.Module):
    """Generic 3D U-Net over (N, C, X, Y, Z) volumes.

    The encoder stack collects per-level features; the decoder consumes them
    in reverse, skipping the deepest (model.py:189-205).  A 1x1x1 conv head
    gives per-voxel logits (model.py:207); sigmoid/softmax only with
    ``testing=True`` (model.py:211-212).  ``config.block`` is ``double``
    (UNet3D) or ``residual`` (ResidualUNet3D).
    """

    def __init__(self, config: UNetConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.block not in BLOCKS:
            raise ValueError(f"block must be one of {sorted(BLOCKS)}, got {config.block!r}")
        dev = resolve_device(device)
        self.config = config
        f_maps = config.feature_maps
        common = dict(block=config.block, order=config.layer_order,
                      num_groups=config.num_groups, dtype=config.dtype, device=dev)
        self.encoders = nn.ModuleList(
            EncoderStage(config.in_channels if i == 0 else f_maps[i - 1], out_ch,
                         apply_pooling=i > 0, pool_type=config.pool_type, **common)
            for i, out_ch in enumerate(f_maps)
        )
        self.decoders = nn.ModuleList(
            DecoderStage(f_maps[level + 1], f_maps[level], **common)
            for level in reversed(range(len(f_maps) - 1))
        )
        self.final_conv = nn.Conv3d(f_maps[0], config.out_channels, 1, device=dev)
        if generator is not None:
            init_parameters_(self, generator)

    def forward(self, x: torch.Tensor, testing: bool = False) -> torch.Tensor:
        cfg = self.config
        # the sum join needs every pooled extent to double back exactly
        # through the stride-2 transposed conv (unet.py:107-116); the
        # concat join resizes to the skip's extent and needs nothing
        div = 2 ** (len(cfg.feature_maps) - 1)
        spatial = tuple(int(s) for s in x.shape[2:])
        if cfg.block == "residual" and any(s % div for s in spatial):
            raise ValueError(
                f"spatial extents {spatial} must be divisible by {div} "
                f"(= 2^(num_levels-1)) for the {len(cfg.feature_maps)}-level "
                "residual U-Net's sum join; use a larger patch or fewer levels"
            )
        x = x.to(cfg.dtype).contiguous(memory_format=CL3D)
        k = cfg.remat_levels if torch.is_grad_enabled() else 0
        features = []
        for i, encoder in enumerate(self.encoders):
            x = _run(encoder, i < k, x)
            features.append(x)
        n_dec = len(self.decoders)
        for i, (decoder, skip) in enumerate(zip(self.decoders, features[-2::-1])):
            # decoder stage i outputs at level n_dec - 1 - i
            x = _run(decoder, n_dec - 1 - i < k, skip, x)
        x = F.conv3d(x, _conv_weight(self.final_conv.weight, cfg.dtype),
                     _cast(self.final_conv.bias, cfg.dtype))
        # fp32 logits: cheap (tiny channel dim) and stabilizes softmax
        x = x.float()
        if testing and not cfg.skip_final_activation:
            x = torch.sigmoid(x) if cfg.final_sigmoid else torch.softmax(x, dim=1)
        return x


def _recompute_contexts():
    """(forward, recompute) contexts of a rematerialized stage: the
    recompute leaves BatchNorm's running statistics alone."""
    return contextlib.nullcontext(), freeze_batch_stats()


def _run(stage: nn.Module, remat: bool, *args: torch.Tensor) -> torch.Tensor:
    """``stage(*args)``; with ``remat``, the backward recomputes the stage's
    activations from its inputs instead of keeping them."""
    if remat:
        return checkpoint(stage, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=_recompute_contexts)
    return stage(*args)


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Redraw every parameter with torch's layer-default distribution from
    ``generator`` (a CPU generator, so a seed gives the same weights on any
    device): conv and transposed-conv weight and bias U(-b, b) with
    b = 1/sqrt(fan_in) (kaiming_uniform(a=sqrt(5))), GroupNorm and
    BatchNorm weight 1 and bias 0, BatchNorm's running mean 0 and variance
    1 (flax's initial ``batch_stats``)."""
    for module in model.modules():
        if isinstance(module, (nn.Conv3d, nn.ConvTranspose3d)):
            # torch's fan_in is dim 1 of the weight times the kernel volume
            w = module.weight
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            for p in (module.weight, module.bias):
                if p is not None:
                    draw = torch.empty(p.shape, dtype=torch.float32)
                    p.copy_(draw.uniform_(-bound, bound, generator=generator))
        elif isinstance(module, (GroupNorm, BatchNorm)):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
            if isinstance(module, BatchNorm):
                module.running_mean.fill_(0.0)
                module.running_var.fill_(1.0)


def UNet3D(
    in_channels: int,
    out_channels: int,
    final_sigmoid: bool = False,
    f_maps: Union[int, Sequence[int]] = 64,
    layer_order: str = "gcr",
    num_groups: int = 8,
    dtype: torch.dtype = torch.bfloat16,
    num_levels: int = 4,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> UNet3DBase:
    """Vanilla 4-level 3D U-Net (reference model.py:11-110): ``DoubleConv``
    blocks and the nearest-resize + concatenation join.  ``remat`` is set
    through ``UNetConfig``, as in the JAX package."""
    cfg = UNetConfig(
        in_channels=in_channels,
        out_channels=out_channels,
        f_maps=f_maps,
        num_levels=num_levels,
        block="double",
        layer_order=layer_order,
        num_groups=num_groups,
        final_sigmoid=final_sigmoid,
        dtype=dtype,
    )
    return UNet3DBase(cfg, device=device, generator=generator)


def ResidualUNet3D(
    in_channels: int,
    out_channels: int,
    final_sigmoid: bool = False,
    f_maps: Union[int, Sequence[int]] = 32,
    conv_layer_order: str = "cge",
    num_groups: int = 8,
    skip_final_activation: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    num_levels: int = 5,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    remat: Union[bool, int] = False,
) -> UNet3DBase:
    """Residual 5-level 3D U-Net (reference model.py:113-213)."""
    cfg = UNetConfig(
        in_channels=in_channels,
        out_channels=out_channels,
        f_maps=f_maps,
        num_levels=num_levels,
        block="residual",
        layer_order=conv_layer_order,
        num_groups=num_groups,
        final_sigmoid=final_sigmoid,
        skip_final_activation=skip_final_activation,
        dtype=dtype,
        remat=remat,
    )
    return UNet3DBase(cfg, device=device, generator=generator)
