"""3D U-Net building blocks as ``nn.Module``s.

Counterpart of ``tpu_mednet/models/blocks.py``: the order-string DSL,
``ConvLayer`` (GroupNorm ``g`` or BatchNorm ``b``), ``DoubleConv``,
``ExtResNetBlock``, ``EncoderStage``, ``DecoderStage`` with either join
(nearest resize + concatenation for ``double``, transposed conv + sum for
``residual``) and ``FinalConv``.  Modules take logical (N, C, D, H, W)
tensors stored ``channels_last_3d``.  Parameters are fp32; the forward
computes in the stage's ``dtype`` (bf16 by default), as the flax modules
do.

Module names equal the torch reference's (``conv``, ``groupnorm``,
``batchnorm``, ``basic_module``, ``SingleConv1``/``SingleConv2``,
``upsample``), so a reference state dict strict-loads
(``tpu_mednet/utils/torch_import.py:28-37``).

Every ``g`` runs through K1 (``ops/groupnorm.py``), forward and backward;
a nonlinearity right after ``g`` fuses into K1's apply kernel, and in
``ExtResNetBlock`` conv3's GroupNorm also takes the residual add and the
final nonlinearity.  Conv, transposed conv, pooling, the nearest resize
and BatchNorm's normalization go to ``torch.nn.functional`` (cuDNN), as
the JAX package left them to XLA; BatchNorm's running statistics follow
flax's update (``BatchNorm``).

On a space axis (``space_axis``: the input's X split over the ranks of
a data row, ``parallel/halo.py``) each module computes its part of the
unsplit function, as GSPMD's partitioning of the JAX modules does: a 3^3
convolution first exchanges its padding's rows of X with its neighbours
and pads only Y and Z; the transposed convolution takes its right
neighbour's first row (its last output row reads it) and crops the one
row it makes past its slab; GroupNorm's sums are added over the data row
before the fold (``gn.SlabGroupNormFunction``); BatchNorm's count is
summed with its sums.  Pooling, the nearest resize and the 1x1x1 head
stay local: every slab is a whole number of pooling windows.
"""

from __future__ import annotations

import contextlib
import threading
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
    whose gradient is K1's backward (``gn.group_norm``'s autograd Function).
    On a space axis the statistics are the whole volume's.

    ``affine=False`` holds no parameters (``nn.InstanceNorm3d``'s default at
    ``num_groups == num_channels``): K1 then takes a weight of ones and a
    bias of zeros, kept as buffers outside the state dict.  ``slope`` is
    the negative slope of a fused LeakyReLU (``act="l"``)."""

    space = None

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 device=None, affine: bool = True, slope: float = gn.LEAKY_SLOPE):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.slope = slope
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels, device=device))
            self.bias = nn.Parameter(torch.zeros(num_channels, device=device))
        else:
            self.register_buffer("weight", torch.ones(num_channels, device=device),
                                 persistent=False)
            self.register_buffer("bias", torch.zeros(num_channels, device=device),
                                 persistent=False)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
        if self.space is not None:
            spatial = self.space.extent(x.shape[2]) * x.shape[3] * x.shape[4]
            return gn.SlabGroupNormFunction.apply(
                x, self.weight, self.bias, residual, self.num_groups, self.eps, act,
                self.space.reduce_, spatial, self.slope)
        return gn.group_norm(x, self.num_groups, self.weight, self.bias,
                             self.eps, residual=residual, act=act, slope=self.slope)


_RECOMPUTE = threading.local()


def batch_stats_frozen() -> bool:
    """True inside ``freeze_batch_stats`` on this thread."""
    return getattr(_RECOMPUTE, "frozen", False)


@contextlib.contextmanager
def freeze_batch_stats():
    """BatchNorms in training mode leave their running statistics alone on
    this thread: the backward's recompute of a rematerialized stage runs
    under it, so a step moves them once, as JAX's ``nn.remat`` does."""
    prev = batch_stats_frozen()
    _RECOMPUTE.frozen = True
    try:
        yield
    finally:
        _RECOMPUTE.frozen = prev


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over (N, D, H, W)
    with the torch reference's names (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``).

    Training mode normalizes by the batch's statistics (``F.batch_norm``,
    biased variance) and moves the running ones by flax's rule, which is
    not ``nn.BatchNorm3d``'s: ``r = 0.9 r + 0.1 s`` with the *biased* batch
    variance (torch's update takes the unbiased one).  The batch statistics
    come out of the same ``F.batch_norm`` call, as its running buffers at
    momentum 1; the unbiased variance is rescaled by (n - 1) / n.  Eval
    mode normalizes by the running statistics.  ``num_batches_tracked``
    exists for strict loading only: flax keeps no count and the momentum
    is fixed, so it stays 0 and a loaded count is dropped, as the JAX
    package's import drops it.

    With ``dp`` set (``set_batch_norm_mesh``: a data-parallel step over a
    ``DataMesh`` of more than one rank), training mode takes the global
    batch's statistics as flax does over a sharded batch: per-channel sums
    of x and x² all-reduced inside autograd over the global count (every
    rank's elements: uneven X slabs hold different counts), mean E[x] and
    biased variance E[x²] − E[x]² (clipped at 0) in fp32.
    """

    dp = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9,
                 device=None):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long, device=device))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        self.num_batches_tracked.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                             self.bias, False, 0.0, self.eps)
            return y.contiguous(memory_format=CL3D)
        n = x.numel() // x.shape[1]
        if self.dp is None:
            mean = torch.zeros_like(self.running_mean)
            var = torch.zeros_like(self.running_var)
            y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            var_scale = (n - 1) / n  # F.batch_norm's running variance is unbiased
        else:
            y, mean, var = self._global_batch_norm(x, n)
            var_scale = 1.0
        if not batch_stats_frozen():
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=(1.0 - m) * var_scale)
        return y.contiguous(memory_format=CL3D)

    def _global_batch_norm(self, x: torch.Tensor, n: int):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dims = [0, *range(2, x.dim())]
        xf = x.float()
        s1, s2 = self.dp.all_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]))
        count = self.dp.count_sum(n)
        mean = s1 / count
        var = (s2 / count - mean * mean).clamp_min(0.0)  # flax clips at 0
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype), mean, var


def set_batch_norm_mesh(model: nn.Module, dp) -> None:
    """Every BatchNorm of ``model`` takes its training statistics over
    ``dp``'s global batch (None: over its own batch)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.dp = dp


@contextlib.contextmanager
def space_axis(model: nn.Module, space):
    """Inside the block every layer of ``model`` that needs it runs on X
    slabs of ``space`` (a ``parallel.halo.SpaceAxis``); after it, and with
    ``space`` None, on whole volumes (a forward elsewhere, on one rank,
    then runs no collective)."""
    layers = [m for m in model.modules() if isinstance(m, (GroupNorm, ConvLayer, DecoderStage))]
    for m in layers:
        m.space = space
    try:
        yield
    finally:
        for m in layers:
            m.space = None


def batch_stat_buffers(model: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm's running mean and variance in ``model``."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


class ConvLayer(nn.Module):
    """One conv 'layer' described by an order string (e.g. ``'cge'``).

    The reference's ``SingleConv``/``create_conv`` (components.py:12-90): a
    3D convolution composed, in order, with an optional GroupNorm or
    BatchNorm and a nonlinearity.  The conv carries a bias only when no
    norm is present (components.py:43); a norm before the conv normalizes
    the input channels, after it the output channels.
    """

    space = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 order: str = "crg", num_groups: int = 8, padding: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        validate_order(order)
        if any(order.count(ch) > 1 for ch in "cgb"):
            raise ValueError(f"order {order!r} repeats a conv or norm")
        self.dtype = dtype
        self.padding = padding
        norm = "g" in order or "b" in order
        # plan: ('c', None) | ('g', fused act or None) | ('b', None) | ('a', act)
        plan: List[Tuple[str, Optional[str]]] = []
        channels = in_channels
        for char in order:
            if char == "c":
                self.conv = nn.Conv3d(in_channels, out_channels, kernel_size,
                                      padding=padding, bias=not norm,
                                      device=device)
                channels = out_channels
                plan.append(("c", None))
            elif char == "g":
                self.groupnorm = GroupNorm(group_count(channels, num_groups),
                                           channels, device=device)
                plan.append(("g", None))
            elif char == "b":
                self.batchnorm = BatchNorm(channels, device=device)
                plan.append(("b", None))
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
                x = self._conv(x).contiguous(memory_format=CL3D)
            elif op == "g":
                if fuse_tail and i == len(self.plan) - 1:
                    return self.groupnorm(x, residual=residual, act=post_act)
                x = self.groupnorm(x, act=act)
            elif op == "b":
                x = self.batchnorm(x)
            else:
                x = gn.activation_plain(x, act)
        if residual is not None:
            x = x + residual
        return gn.activation_plain(x, post_act)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        w, b = _conv_weight(self.conv.weight, self.dtype), _cast(self.conv.bias, self.dtype)
        pad = self.padding
        if self.space is None or not pad:
            return F.conv3d(x, w, b, padding=pad)
        x = self.space.exchange(x, pad, pad).contiguous(memory_format=CL3D)
        return F.conv3d(x, w, b, padding=(0, pad, pad))


class DoubleConv(nn.Module):
    """Two consecutive ``ConvLayer``s, ``SingleConv1`` and ``SingleConv2``.

    Reference semantics (components.py:93-133): on the encoder path the
    first conv goes to ``max(out_channels // 2, in_channels)`` features; on
    the decoder path both convs output ``out_channels``.
    """

    def __init__(self, in_channels: int, out_channels: int, encoder: bool,
                 kernel_size: int = 3, order: str = "crg", num_groups: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        mid = max(out_channels // 2, in_channels) if encoder else out_channels
        common = dict(kernel_size=kernel_size, order=order, num_groups=num_groups,
                      dtype=dtype, device=device)
        self.SingleConv1 = ConvLayer(in_channels, mid, **common)
        self.SingleConv2 = ConvLayer(mid, out_channels, **common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.SingleConv2(self.SingleConv1(x))


def _strip_nonlinearity(order: str) -> str:
    return "".join(ch for ch in order if ch not in NONLINEARITIES)


class ExtResNetBlock(nn.Module):
    """SingleConv + residual conv pair + post-residual nonlinearity.

    Reference semantics (components.py:136-180): conv1 adapts channel count
    and its output is the residual; conv2 keeps the full order; conv3 has the
    nonlinearity stripped (it is applied after the residual add); the final
    nonlinearity is LeakyReLU if 'l' in order, ELU if 'e', else ReLU.
    ``encoder`` exists for call-signature parity with ``DoubleConv`` and
    changes nothing (components.py:146).
    """

    def __init__(self, in_channels: int, out_channels: int, encoder: bool = True,
                 kernel_size: int = 3, order: str = "cge", num_groups: int = 8,
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


BLOCKS = {"double": DoubleConv, "residual": ExtResNetBlock}


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
                 pool_type: str = "max", block: str = "residual", order: str = "cge",
                 num_groups: int = 8, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.apply_pooling = apply_pooling
        self.pool_type = pool_type
        self.basic_module = BLOCKS[block](
            in_channels, out_channels, encoder=True, order=order, num_groups=num_groups,
            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.apply_pooling:
            x = pool3d(x, (2, 2, 2), self.pool_type)
        return self.basic_module(x)


def resize_nearest(x: torch.Tensor, spatial: Tuple[int, ...]) -> torch.Tensor:
    """Nearest resize of the spatial dims with half-pixel centres:
    ``jax.image.resize(..., "nearest")``, which is torch's ``nearest-exact``
    (``nearest`` floors ``i * in / out`` instead, and differs wherever the
    ratio is not an integer)."""
    return F.interpolate(x, size=tuple(spatial), mode="nearest-exact")


class DecoderStage(nn.Module):
    """Upsample + join + basic block, with the reference ``Decoder``'s two
    joins (components.py:229-287):

    - ``double``: the deeper feature resized (nearest) to the encoder
      feature's extent, then the channel concatenation ``[encoder, x]``;
      the block takes ``out_channels + in_channels`` channels;
    - ``residual``: ``ConvTranspose3d(k=3, stride=2, padding=1,
      output_padding=1)`` doubles the extent, then the encoder feature is
      added.

    On a space axis the transposed conv's output row ``2i + k - 1`` reads
    input row ``i`` (k = 0, 1, 2): a slab's last output row reads the
    right neighbour's first input row and no row reads the left one's, so
    the slab takes one row from the right (zeros past the volume, where
    ``output_padding`` adds a row that reads nothing), and the one output
    row past its slab is cropped.
    """

    space = None

    def __init__(self, in_channels: int, out_channels: int, block: str = "residual",
                 order: str = "cge", num_groups: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.block = block
        if block == "residual":
            self.upsample = nn.ConvTranspose3d(
                in_channels, out_channels, 3, stride=2, padding=1,
                output_padding=1, device=device)
            block_in = out_channels
        else:
            block_in = out_channels + in_channels
        self.basic_module = BLOCKS[block](
            block_in, out_channels, encoder=False, order=order,
            num_groups=num_groups, dtype=dtype, device=device)

    def forward(self, encoder_features: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.block == "double":
            x = resize_nearest(x, encoder_features.shape[2:])
            x = torch.cat([encoder_features, x], dim=1)
        else:
            up = self.upsample
            w, b = _conv_weight(up.weight, self.dtype), _cast(up.bias, self.dtype)
            if self.space is None:
                x = F.conv_transpose3d(x, w, b, stride=2, padding=1, output_padding=1)
            else:
                rows = 2 * x.shape[2]
                x = self.space.exchange(x, 0, 1).contiguous(memory_format=CL3D)
                x = F.conv_transpose3d(x, w, b, stride=2, padding=1,
                                       output_padding=(0, 1, 1)).narrow(2, 0, rows)
            x = x + encoder_features
        return self.basic_module(x.contiguous(memory_format=CL3D))


class FinalConv(nn.Module):
    """A ``ConvLayer`` that keeps the channel count, then a 1x1x1
    projection (reference ``FinalConv``, components.py:290-316; the stock
    U-Nets use a bare 1x1x1 conv instead).  Names follow the JAX package's
    (``conv``, ``final_conv``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 order: str = "crg", num_groups: int = 8,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = ConvLayer(in_channels, in_channels, kernel_size, order=order,
                              num_groups=num_groups, dtype=dtype, device=device)
        self.final_conv = nn.Conv3d(in_channels, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        y = F.conv3d(x, _conv_weight(self.final_conv.weight, self.dtype),
                     _cast(self.final_conv.bias, self.dtype))
        return y.contiguous(memory_format=CL3D)
