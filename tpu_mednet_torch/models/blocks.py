"""3D U-Net building blocks (residual family) as ``nn.Module``s.

Counterpart of ``tpu_mednet/models/blocks.py``: the order-string DSL,
``ConvLayer``, ``ExtResNetBlock``, ``EncoderStage`` and the residual-join
``DecoderStage``.  Modules take logical (N, C, D, H, W) tensors stored
``channels_last_3d``.  Parameters are fp32; the forward computes in the
stage's ``dtype`` (bf16 by default), as the flax modules do.

Module names equal the torch reference's (``conv``, ``groupnorm``,
``basic_module``, ``upsample``), so a reference state dict strict-loads
(``tpu_mednet/utils/torch_import.py:28-37``).

Every ``g`` runs through K1 (``ops/groupnorm.py``), forward and backward;
a nonlinearity right after ``g`` fuses into K1's apply kernel, and in
``ExtResNetBlock`` conv3's GroupNorm also takes the residual add and the
final nonlinearity.  Conv,
transposed conv and pooling go to ``torch.nn.functional`` (cuDNN), as the
JAX package left them to XLA.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_mednet_torch.ops import groupnorm as gn

VALID_ORDER_CHARS = frozenset("crlebg")
NONLINEARITIES = "rle"
CL3D = torch.channels_last_3d


def validate_order(order: str) -> None:
    """Validate an order string with the reference's rules.

    Reference: components.py:30-31 — a conv must be present, and the first op
    may not be a nonlinearity; components.py:64-65 — only 'bgrlec' allowed.
    """
    if "c" not in order:
        raise ValueError("Conv layer MUST be present in the order string")
    if order[0] in NONLINEARITIES:
        raise ValueError("Non-linearity cannot be the first operation in the layer")
    bad = set(order) - VALID_ORDER_CHARS
    if bad:
        raise ValueError(
            f"Unsupported layer type(s) {sorted(bad)}. MUST be one of ['b','g','r','l','e','c']"
        )


def group_count(num_channels: int, num_groups: int) -> int:
    """Clamp the group count exactly as the reference does.

    components.py:52-56: use a single group when the channel count is smaller
    than the requested group count; channel count must divide evenly.
    """
    if num_channels < num_groups:
        num_groups = 1
    if num_channels % num_groups != 0:
        raise ValueError(
            f"Expected number of channels to be divisible by num_groups. "
            f"num_channels={num_channels}, num_groups={num_groups}"
        )
    return num_groups


def _conv_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 parameter -> compute-dtype channels-last kernel, so cuDNN keeps
    the activation channels-last even where C == 1 makes its layout ambiguous."""
    return w.to(dtype).contiguous(memory_format=CL3D)


def _cast(b: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if b is None else b.to(dtype)


class GroupNorm(nn.Module):
    """GroupNorm parameters (``weight``/``bias`` like ``nn.GroupNorm``) whose
    forward is K1, with an optional fused residual add and nonlinearity, and
    whose gradient is K1's backward (``gn.group_norm``'s autograd Function)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
        return gn.group_norm(x, self.num_groups, self.weight, self.bias,
                             self.eps, residual=residual, act=act)


class ConvLayer(nn.Module):
    """One conv 'layer' described by an order string (e.g. ``'cge'``).

    The reference's ``SingleConv``/``create_conv`` (components.py:12-90): a
    3D convolution composed, in order, with an optional GroupNorm and a
    nonlinearity.  The conv carries a bias only when no norm is present
    (components.py:43); a norm before the conv normalizes the input
    channels, after it the output channels.  BatchNorm (``b``) is not
    ported yet.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 order: str = "crg", num_groups: int = 8, padding: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        validate_order(order)
        if "b" in order:
            raise NotImplementedError("BatchNorm orders ('b') are not ported yet")
        if any(order.count(ch) > 1 for ch in "cg"):
            raise ValueError(f"order {order!r} repeats a conv or norm")
        self.dtype = dtype
        self.padding = padding
        # plan: ('c', None) | ('g', fused act or None) | ('a', act)
        plan: List[Tuple[str, Optional[str]]] = []
        channels = in_channels
        for char in order:
            if char == "c":
                self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                                      padding=padding, bias="g" not in order,
                                      device=device)
                channels = out_channels
                plan.append(("c", None))
            elif char == "g":
                self.groupnorm = GroupNorm(group_count(channels, num_groups),
                                           channels, device=device)
                plan.append(("g", None))
            elif plan[-1] == ("g", None):
                plan[-1] = ("g", char)
            else:
                plan.append(("a", char))
        self.plan = tuple(plan)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                post_act: Optional[str] = None) -> torch.Tensor:
        """``post_act(layer(x) + residual)``; both fuse into a trailing GroupNorm."""
        fuse_tail = self.plan[-1] == ("g", None)
        for i, (op, act) in enumerate(self.plan):
            if op == "c":
                x = F.conv3d(x, _conv_weight(self.conv.weight, self.dtype),
                             _cast(self.conv.bias, self.dtype), padding=self.padding)
                x = x.contiguous(memory_format=CL3D)
            elif op == "g":
                if fuse_tail and i == len(self.plan) - 1:
                    return self.groupnorm(x, residual=residual, act=post_act)
                x = self.groupnorm(x, act=act)
            else:
                x = gn.activation_plain(x, act)
        if residual is not None:
            x = x + residual
        return gn.activation_plain(x, post_act)


def _strip_nonlinearity(order: str) -> str:
    return "".join(ch for ch in order if ch not in NONLINEARITIES)


class ExtResNetBlock(nn.Module):
    """SingleConv + residual conv pair + post-residual nonlinearity.

    Reference semantics (components.py:136-180): conv1 adapts channel count
    and its output is the residual; conv2 keeps the full order; conv3 has the
    nonlinearity stripped (it is applied after the residual add); the final
    nonlinearity is LeakyReLU if 'l' in order, ELU if 'e', else ReLU.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 order: str = "cge", num_groups: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        common = dict(kernel_size=kernel_size, num_groups=num_groups,
                      dtype=dtype, device=device)
        self.conv1 = ConvLayer(in_channels, out_channels, order=order, **common)
        self.conv2 = ConvLayer(out_channels, out_channels, order=order, **common)
        self.conv3 = ConvLayer(out_channels, out_channels,
                               order=_strip_nonlinearity(order), **common)
        self.post_act = "l" if "l" in order else ("e" if "e" in order else "r")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.conv1(x)
        out = self.conv2(residual)
        return self.conv3(out, residual=residual, post_act=self.post_act)


def pool3d(x: torch.Tensor, window: Tuple[int, int, int], pool_type: str) -> torch.Tensor:
    """Stride-``window`` max/avg pooling (reference components.py:207-214)."""
    if pool_type == "max":
        y = F.max_pool3d(x, window, window)
    elif pool_type == "avg":
        y = F.avg_pool3d(x, window, window)
    else:
        raise ValueError(f"pool_type must be 'max' or 'avg', got {pool_type!r}")
    return y.contiguous(memory_format=CL3D)


class EncoderStage(nn.Module):
    """Optional pooling followed by the basic block (reference ``Encoder``,
    components.py:183-226)."""

    def __init__(self, in_channels: int, out_channels: int, apply_pooling: bool = True,
                 pool_type: str = "max", order: str = "cge", num_groups: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.pool_type = pool_type
        self.basic_module = ExtResNetBlock(
            in_channels, out_channels, order=order, num_groups=num_groups,
            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = pool3d(x, (2, 2, 2), self.pool_type)
        return self.basic_module(x)


class DecoderStage(nn.Module):
    """Transposed-conv upsample + summation join + basic block.

    The reference ``Decoder``'s residual join (components.py:259-266,
    281-284): ``ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1)``
    doubles the spatial extent, then the encoder feature is added.
    """

    def __init__(self, in_channels: int, out_channels: int, order: str = "cge",
                 num_groups: int = 8, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.upsample = nn.ConvTranspose3d(
            in_channels, out_channels, 3, stride=2, padding=1,
            output_padding=1, device=device)
        self.basic_module = ExtResNetBlock(
            out_channels, out_channels, order=order,
            num_groups=num_groups, dtype=dtype, device=device)

    def forward(self, encoder_features: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        up = self.upsample
        x = F.conv_transpose3d(x, _conv_weight(up.weight, self.dtype),
                               _cast(up.bias, self.dtype), stride=2, padding=1,
                               output_padding=1)
        x = (x + encoder_features).contiguous(memory_format=CL3D)
        return self.basic_module(x)
