"""Swin UNETR (v1) as an ``nn.Module``: a 3D shifted-window transformer
encoder with a convolutional U-Net decoder.

Hatamizadeh et al. 2022, "Swin UNETR" (arXiv:2201.01266), as MONAI builds
it (``monai.networks.nets.SwinUNETR``, ``use_v2=False``), with MONAI's
state-dict names (``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``encoder1.layer.conv1.conv.weight``, ...), so a MONAI checkpoint loads
(its ``relative_position_index`` buffers are derived here and dropped on
load).  Inputs are logical (N, C, X, Y, Z) tensors, every extent a
multiple of 32; the logits come back fp32.

- Encoder (``swinViT``): a stride-``patch_size`` convolution embeds the
  input as tokens, kept channels-last (B, D, H, W, C) through the four
  stages.  A stage is ``depth`` blocks, ``x + Attn(LN1(x))`` then
  ``x + MLP(LN2(x))`` (Linear, exact GELU, Linear), every second block
  with its windows shifted by half a window, and a patch merging (the
  2x2x2 neighbours concatenated, LayerNorm, Linear to twice the width
  without bias).  The window is fixed per stage from the unpadded extent:
  where an extent is at most ``window_size`` the window is that extent and
  the shift 0, else LN1's output is zero-padded at the end to a multiple
  of the window, rolled back by the shift, cut into windows, and the
  attention output is put back, rolled and cropped.  Padded tokens are not
  masked (as in Swin and MONAI).  Each window attends with a learned
  relative-position bias, table rows ``(dz+w-1)(2w-1)^2 + (dy+w-1)(2w-1) +
  (dx+w-1)``, sliced ``[:n, :n]`` where the window holds n < w^3 tokens
  (MONAI's slice of its full-window index), and in a shifted block
  MONAI's mask of -100 between the 27 regions of the rolled grid.
- Hidden states: the embedding and each stage's output under a LayerNorm
  without affine (MONAI's ``proj_out``).
- Decoder: UNETR's residual conv blocks (``UnetResBlock``: 3^3 conv,
  InstanceNorm, LeakyReLU 0.01, 3^3 conv, InstanceNorm, plus the input or
  its 1x1x1 conv + InstanceNorm, LeakyReLU) on the input and on the hidden
  states, up blocks (a 2^3 stride-2 transposed convolution, concatenated
  with the skip, a residual block) and a 1x1x1 head with bias.

Dtype policy as the U-Nets': fp32 parameters, compute in ``config.dtype``.
Every InstanceNorm is K1 (``ops/groupnorm.py``) at one channel a group,
affine-free, with the LeakyReLU (and the block's residual add) fused into
its apply.  Window attention is one ``F.scaled_dot_product_attention`` call
a block, the bias (and mask) its ``attn_mask``: the fused kernel keeps the
scores and probabilities out of device memory.  The windows are cut and
put back by one gather each (``index_select`` with the padded grid's
roll and partition folded into one index).  The forward runs in two
spans, ``swin.encoder`` and ``swin.decoder`` (``utils/tracing.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.models.blocks import GroupNorm, _conv_weight
from tpu_mednet_torch.utils import memory, tracing

CL3D = torch.channels_last_3d
LEAKY_SLOPE = 0.01   # UnetResBlock's LeakyReLU
MASK_VALUE = -100.0  # MONAI's compute_mask
LN_EPS = 1e-5
MLP_RATIO = 4        # the MLP's hidden width over the stage's


@dataclasses.dataclass(frozen=True)
class SwinUNETRConfig:
    """Static configuration of Swin UNETR v1 (MONAI's defaults but
    ``feature_size``, which BTCV sets to 48)."""

    in_channels: int = 1
    out_channels: int = 14
    feature_size: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 2
    dtype: torch.dtype = torch.bfloat16

    @property
    def divisor(self) -> int:
        """Input extents must be multiples of this: the embedding and one
        merge a stage halve them, and the decoder doubles them back."""
        return self.patch_size * 2 ** len(self.depths)

    def infer_peak_bytes(self, batch: int, patch: Sequence[int]) -> int:
        """The serving guard's working set of one forward of ``batch``
        tiles of ``patch`` (``utils/memory.swin_unetr_infer_peak_bytes``),
        with what the model holds whatever the batch: each shifted stage's
        (windows, n, n) mask, kept with its geometry, and the largest
        (windows x heads, n, n) bias and mask an attention call takes."""
        e = torch.finfo(self.dtype).bits // 8
        kept = largest = 0
        for i, heads in enumerate(self.num_heads):
            extent = [int(p) // self.patch_size // 2 ** i for p in patch]
            ws, ss, padded = window_geometry(extent, self.window_size, self.window_size // 2)
            if any(ss):
                n = math.prod(ws)
                windows = math.prod(padded) // n
                kept += windows * n * n * e
                largest = max(largest, windows * heads * n * n * e)
        return memory.swin_unetr_infer_peak_bytes(batch, patch, self.feature_size,
                                                  kept + largest, e)


def window_geometry(extent: Sequence[int], window: int, shift: int
                    ) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """(window, shift, padded extent) per axis of a stage whose tokens span
    ``extent``: MONAI's ``get_window_size`` (an axis no longer than the
    window takes its extent as the window and no shift) and the padding
    to a whole number of windows."""
    ws = tuple(e if e <= window else window for e in extent)
    ss = tuple(0 if e <= window else shift for e in extent)
    padded = tuple(-(-e // w) * w for e, w in zip(extent, ws))
    return ws, ss, padded


def relative_position_index(window: int) -> torch.Tensor:
    """(w^3, w^3) rows of the bias table of each pair of a full window's
    tokens (MONAI's ``WindowAttention``)."""
    r = torch.arange(window)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    span = 2 * window - 1
    return rel[..., 0] * span * span + rel[..., 1] * span + rel[..., 2]


def shift_mask(padded: Sequence[int], ws: Sequence[int], ss: Sequence[int]) -> torch.Tensor:
    """(windows, n, n) fp32: 0 within a region of the rolled grid, -100
    across regions (MONAI's ``compute_mask``, its slices as written)."""
    img = torch.zeros(tuple(padded))
    cnt = 0
    sl = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, ss)]
    for d in sl[0]:
        for h in sl[1]:
            for w in sl[2]:
                img[d, h, w] = cnt
                cnt += 1
    win = _partition_grid(img, ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


def _partition_grid(grid: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """(D, H, W) -> (windows, n): the grid cut into windows, in order."""
    d, h, w = grid.shape
    g = grid.view(d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2])
    return g.permute(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])


class StageGeometry:
    """A stage's windows on one device for one extent: ``gather`` (window
    order -> the padded grid's flat index, roll and partition in one),
    ``scatter`` (each unpadded token -> its window-order position: the
    reverse, roll back and crop in one), the window, the padding and the
    shift mask (None without a shift) in the compute dtype."""

    def __init__(self, extent: Sequence[int], window: int, shift: int, device,
                 dtype: torch.dtype = torch.float32):
        self.extent = tuple(int(e) for e in extent)
        self.ws, self.ss, self.padded = window_geometry(self.extent, window, shift)
        self.n = math.prod(self.ws)
        self.windows = math.prod(self.padded) // self.n
        self.shifted = any(s > 0 for s in self.ss)
        grid = torch.arange(math.prod(self.padded)).view(self.padded)
        if self.shifted:
            grid = torch.roll(grid, shifts=tuple(-s for s in self.ss), dims=(0, 1, 2))
        gather = _partition_grid(grid, self.ws).reshape(-1)
        position = torch.empty_like(gather)
        position[gather] = torch.arange(gather.numel())
        d, h, w = self.extent
        _, hp, wp = self.padded
        flat = (torch.arange(d)[:, None, None] * hp * wp + torch.arange(h)[None, :, None] * wp
                + torch.arange(w)[None, None, :]).reshape(-1)
        self.gather = gather.to(device)
        self.scatter = position[flat].to(device)
        self.mask = shift_mask(self.padded, self.ws, self.ss).to(device, dtype) \
            if self.shifted else None
        self.pad = tuple(p - e for p, e in zip(self.padded, self.extent))


class Linear(nn.Linear):
    """``nn.Linear`` whose fp32 parameters compute in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose fp32 parameters compute in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative-position
    bias; ``qkv``, ``proj`` and ``relative_position_bias_table`` as MONAI's."""

    def __init__(self, dim: int, num_heads: int, window: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, num_heads, device=device))
        self.register_buffer("relative_position_index",
                             relative_position_index(window).to(device), persistent=False)
        self.qkv = Linear(dim, 3 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "relative_position_index", None)  # MONAI keeps it
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def bias(self, n: int) -> torch.Tensor:
        """(heads, n, n) fp32: the table's rows of the first n tokens'
        pairs (MONAI's ``[:n, :n]``)."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        table = self.relative_position_bias_table
        return table[idx].view(n, n, -1).permute(2, 0, 1).contiguous()

    def forward(self, tokens: torch.Tensor, geo: StageGeometry) -> torch.Tensor:
        """(B, N_padded, C) tokens in window order -> (B, N_padded, C) the
        heads' outputs, before ``proj``."""
        b, _, c = tokens.shape
        h, n, nw = self.num_heads, geo.n, geo.windows
        d = c // h
        qkv = self.qkv(tokens).view(b, nw, n, 3, h, d)
        bias = self.bias(n)
        if geo.shifted:
            # one mask a window: the windows join the heads, so the mask
            # broadcasts over the batch alone
            q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).reshape(3, b, nw * h, n, d).unbind(0)
            mask = (bias.to(tokens.dtype)[None] + geo.mask[:, None]).view(1, nw * h, n, n)
        else:
            q, k, v = qkv.view(b * nw, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            mask = bias.to(tokens.dtype)[None]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return out.view(b, nw, h, n, d).transpose(2, 3).reshape(b, nw * n, c)


class MLPBlock(nn.Module):
    """Linear, exact GELU, Linear (MONAI's ``MLPBlock``)."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.linear1 = Linear(dim, hidden, device=device)
        self.linear2 = Linear(hidden, dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, device=None):
        super().__init__()
        self.shift = shift
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = WindowAttention(dim, num_heads, window, device=device)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = MLPBlock(dim, dim * MLP_RATIO, device=device)

    def forward(self, x: torch.Tensor, geo: StageGeometry) -> torch.Tensor:
        b, d, h, w, c = x.shape
        y = self.norm1(x)
        if any(geo.pad):
            y = F.pad(y, (0, 0, 0, geo.pad[2], 0, geo.pad[1], 0, geo.pad[0]))
        y = y.reshape(b, -1, c).index_select(1, geo.gather)
        y = self.attn(y, geo).index_select(1, geo.scatter)
        x = x + self.attn.proj(y).view(b, d, h, w, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """The 2x2x2 neighbours concatenated (z, y, x order), LayerNorm(8C),
    Linear(8C, 2C) without bias."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = LayerNorm(8 * dim, eps=LN_EPS, device=device)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        x = x.view(b, d // 2, 2, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
        return self.reduction(self.norm(x.reshape(b, d // 2, h // 2, w // 2, 8 * c)))


class BasicLayer(nn.Module):
    """One stage: its blocks (no shift, then half a window, alternating)
    and the patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, device=None):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window, 0 if i % 2 == 0 else window // 2,
                                 device=device)
            for i in range(depth))
        self.downsample = PatchMerging(dim, device=device)
        self._geometry: Dict[tuple, StageGeometry] = {}

    def geometry(self, extent, shift: int, device, dtype) -> StageGeometry:
        """The stage's windows at ``extent`` (made once a shape, device and
        dtype: the indices and the mask reach the device before the first
        step, and never again)."""
        key = (tuple(extent), shift, device, dtype)
        geo = self._geometry.get(key)
        if geo is None:
            geo = self._geometry[key] = StageGeometry(extent, self.window, shift, device,
                                                      dtype)
        return geo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, self.geometry(x.shape[1:4], blk.shift, x.device, x.dtype))
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, device=None):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv3d(in_channels, dim, patch, stride=patch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _conv_weight(self.proj.weight, x.dtype)
        y = F.conv3d(x, w, self.proj.bias.to(x.dtype), stride=self.patch)
        return y.contiguous(memory_format=CL3D).permute(0, 2, 3, 4, 1)


def _proj_out(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine over the channels, as a channels_last_3d
    (N, C, D, H, W) view (MONAI's ``proj_out``)."""
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS).permute(0, 4, 1, 2, 3)


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinUNETRConfig, device=None):
        super().__init__()
        fs = cfg.feature_size
        self.patch_embed = PatchEmbed(cfg.in_channels, fs, cfg.patch_size, device=device)
        for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([
                BasicLayer(fs * 2 ** i, depth, heads, cfg.window_size, device=device)]))
        self.num_layers = len(cfg.depths)

    def forward(self, x: torch.Tensor):
        """The hidden states ``hs0`` ... ``hs4`` as channels_last_3d views."""
        x = self.patch_embed(x)
        out = [_proj_out(x)]
        for i in range(self.num_layers):
            x = getattr(self, f"layers{i + 1}")[0](x)
            out.append(_proj_out(x))
        return out


class ConvUnit(nn.Module):
    """A bias-free convolution under MONAI's ``Convolution`` names (``conv``)."""

    def __init__(self, c_in: int, c_out: int, k: int, transposed: bool = False,
                 bias: bool = False, device=None):
        super().__init__()
        cls = nn.ConvTranspose3d if transposed else nn.Conv3d
        kw = dict(stride=k) if transposed else dict(padding=k // 2)
        self.conv = cls(c_in, c_out, k, bias=bias, device=device, **kw)
        self.transposed = transposed

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        w = _conv_weight(c.weight, x.dtype)
        b = None if c.bias is None else c.bias.to(x.dtype)
        if self.transposed:
            y = F.conv_transpose3d(x, w, b, stride=c.stride)
        else:
            y = F.conv3d(x, w, b, padding=c.padding)
        return y.contiguous(memory_format=CL3D)


def _instance_norm(c: int, device) -> GroupNorm:
    return GroupNorm(c, c, eps=1e-5, device=device, affine=False, slope=LEAKY_SLOPE)


class UnetResBlock(nn.Module):
    """``lrelu(norm2(conv2(lrelu(norm1(conv1(x))))) + r)``, r the input or
    ``norm3(conv3(x))`` (a 1x1x1 conv) where the width changes; norm2's
    K1 call takes the residual add and the LeakyReLU."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv1 = ConvUnit(c_in, c_out, 3, device=device)
        self.conv2 = ConvUnit(c_out, c_out, 3, device=device)
        self.norm1 = _instance_norm(c_out, device)
        self.norm2 = _instance_norm(c_out, device)
        if c_in != c_out:
            self.conv3 = ConvUnit(c_in, c_out, 1, device=device)
            self.norm3 = _instance_norm(c_out, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.norm1(self.conv1(x), act="l"))
        if not hasattr(self, "conv3"):
            r = x
        elif x.shape[1] == 1:
            # From one channel conv3 only scales each output channel, which
            # norm3 takes out but for its eps: the weight's gradient is that
            # term alone, a sum that cancels to eps / (var + eps) of its
            # parts.  A bf16 or TF32 conv rounds z and dz first and leaves
            # noise several times the gradient, so conv3 runs as an fp32
            # product, with norm3 in fp32.
            z = x.float() * self.conv3.conv.weight.view(1, -1, 1, 1, 1)
            r = self.norm3(z.contiguous(memory_format=CL3D)).to(x.dtype)
        else:
            r = self.norm3(self.conv3(x))
        return self.norm2(y, residual=r, act="l")


class UnetrBasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.layer = UnetResBlock(c_in, c_out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """The transposed conv (2^3, stride 2), the skip concatenated after it,
    a residual block."""

    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.transp_conv = ConvUnit(c_in, c_out, 2, transposed=True, device=device)
        self.conv_block = UnetResBlock(2 * c_out, c_out, device=device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = torch.cat((self.transp_conv(x), skip), dim=1)
        return self.conv_block(y.contiguous(memory_format=CL3D))


class UnetOutBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, device=None):
        super().__init__()
        self.conv = ConvUnit(c_in, c_out, 1, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SwinUNETR(nn.Module):
    """Swin UNETR v1 (module docstring)."""

    def __init__(self, config: SwinUNETRConfig, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        fs = config.feature_size
        self.swinViT = SwinTransformer(config, device=dev)
        self.encoder1 = UnetrBasicBlock(config.in_channels, fs, device=dev)
        self.encoder2 = UnetrBasicBlock(fs, fs, device=dev)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs, device=dev)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs, device=dev)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs, device=dev)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, device=dev)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, device=dev)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, device=dev)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, device=dev)
        self.decoder1 = UnetrUpBlock(fs, fs, device=dev)
        self.out = UnetOutBlock(fs, config.out_channels, device=dev)
        if dev.type != "meta":
            init_parameters_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        div = self.config.divisor
        spatial = tuple(int(s) for s in x.shape[2:])
        if any(s % div for s in spatial):
            raise ValueError(f"spatial extents {spatial} must be divisible by {div} for "
                             "Swin UNETR's embedding, merges and up blocks")
        x = x.to(self.config.dtype).contiguous(memory_format=CL3D)
        with tracing.span("swin.encoder"):
            hs = self.swinViT(x)
        with tracing.span("swin.decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            dec = self.encoder10(hs[4])
            dec = self.decoder5(dec, hs[3])
            dec = self.decoder4(dec, enc3)
            dec = self.decoder3(dec, enc2)
            dec = self.decoder2(dec, enc1)
            dec = self.decoder1(dec, enc0)
            return self.out(dec).float()


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """MONAI's initial parameters: torch's layer defaults (conv, transposed
    conv and Linear weight and bias U(-b, b), b = 1/sqrt(fan_in) with
    torch's fan in, dim 1 of the weight times the kernel volume;
    LayerNorm 1 and 0) and the bias tables truncated normal (std 0.02,
    within +-2), drawn from ``generator`` (a CPU generator, so a seed gives
    the same weights on any device) or, without one, torch's."""
    def draw(p: torch.Tensor, fill) -> None:
        t = torch.empty(p.shape, dtype=torch.float32)
        fill(t)
        p.copy_(t)

    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d, nn.Linear)):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * math.prod(w.shape[2:]))
            for p in (m.weight, m.bias):
                if p is not None:
                    draw(p, lambda t: t.uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, WindowAttention):
            draw(m.relative_position_bias_table,
                 lambda t: nn.init.trunc_normal_(t, std=0.02, a=-2.0, b=2.0,
                                                 generator=generator))
